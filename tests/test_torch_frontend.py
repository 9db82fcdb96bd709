"""PyTorch port, edge front-end: colour, blur, K1 (edge_front) and K2
(thinthres) against the JAX package on the CPU.

The same numpy inputs go through the jitted JAX function and the port's
plain version (the port takes its plain versions for CPU tensors).
Tolerances:
  * packed0, labb, em and edge_bin: equal (bit-equal floats);
  * vec: within 2.4e-7 (2 ulp at 1.0).  XLA:CPU's rsqrt is a hardware
    estimate plus a Newton step, faithful but not correctly rounded; the
    port rounds 1/sqrt once (ops/gradient.py), so unit vectors may differ
    by one ulp;
  * edge_thin: bit-equal when both sides sample the same (em, vec); from
    the port's own vec the one-ulp direction differences move the bicubic
    fraction, within atol 5e-3 (measured <= 1.2e-3 at these sizes) and
    without changing edge_thin > 0;
  * against the interpret-mode Pallas kernels: atol 2e-4, their own
    contract (tests/test_pallas_grad.py, tests/test_pallas_thin.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_scene
from rectdetect_tpu.core import color as jcolor
from rectdetect_tpu.ops import blur as jblur
from rectdetect_tpu.ops import gradient as jgrad
from rectdetect_tpu.ops import thin as jthin
from rectdetect_tpu.ops.pallas_grad import edge_front_pallas
from rectdetect_tpu.ops.pallas_thin import thinthres_pallas
from rectdetect_tpu.pipeline.frontend import edge_frontend as jax_frontend

from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.ops import blur, hopper_grad, hopper_thin
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend

# The suite runs several test workers on shared cores: a torch thread pool
# per worker would oversubscribe them, and these tensors are small.
torch.set_num_threads(1)

VEC_ATOL = 2.4e-7
THIN_ATOL = 5e-3
PALLAS_ATOL = 2e-4

_jax_frontend = jax.jit(jax_frontend)
_jax_colour = jax.jit(lambda b: (jcolor.bgr_to_labf(b),
                                 jcolor.quantize_labf(jcolor.bgr_to_labf(b)),
                                 jcolor.pack_lab(jcolor.bgr_to_labf(b))))
_jax_blur = jax.jit(lambda x: jblur.gaussian_blur(x, 2))
_jax_em_vec = jax.jit(lambda labb: (
    jgrad.edge_lab(jcolor.quantize_labf(labb)), jgrad.edgevec(labb[..., 0])))
_jax_thin = jax.jit(jthin.thinthres)


def _t(a):
    return torch.from_numpy(np.array(a))


def _labb(h, w, seed):
    """Blurred Lab planes of a synthetic scene, as the JAX front-end makes
    them."""
    return np.asarray(_jax_frontend(jnp.asarray(synth_scene(h, w, seed))).labb)


def test_colour_matches_jax():
    r = np.random.default_rng(11)
    bgr = r.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    jl, jq, jp = (np.asarray(a) for a in _jax_colour(jnp.asarray(bgr)))
    lab = color.bgr_to_labf(_t(bgr))
    np.testing.assert_array_equal(color.pack_lab(lab).numpy(), jp)
    np.testing.assert_array_equal(color.quantize_labf(lab).numpy(), jq)
    # the float Lab differs from XLA's cbrt by at most an ulp
    np.testing.assert_allclose(lab.numpy(), jl, rtol=0, atol=2e-7)


def test_srgb_table_within_a_few_ulp_of_jax():
    # standalone, XLA fuses the decode differently than inside
    # bgr_to_labf (which test_colour_matches_jax holds bit-equal through
    # the packed lattice): 4 ulp allowed, 3 measured
    tbl = color._srgb_table_np()
    want = np.asarray(jax.jit(jcolor.srgb_to_linear)(
        jnp.arange(256, dtype=jnp.uint8)))
    np.testing.assert_array_max_ulp(tbl, want, maxulp=4)
    assert tbl[0] == 0.0 and abs(tbl[255] - 1.0) < 1e-6


@pytest.mark.parametrize("shape", [(32, 44), (37, 45)])
def test_blur_matches_jax(shape):
    assert blur.gaussian_taps(2) == jblur.gaussian_taps(2)
    img = np.random.default_rng(2).random(shape).astype(np.float32)
    np.testing.assert_array_equal(blur.gaussian_blur(_t(img), 2).numpy(),
                                  np.asarray(_jax_blur(jnp.asarray(img))))


@pytest.mark.parametrize("shape,seed", [((32, 44), 0), ((37, 45), 1)])
def test_edge_front_matches_xla_and_pallas(shape, seed):
    labb = _labb(*shape, seed)
    jem, jvec = (np.asarray(a) for a in _jax_em_vec(jnp.asarray(labb)))
    em, vec = hopper_grad.edge_front(_t(labb))
    np.testing.assert_array_equal(em.numpy(), jem)
    np.testing.assert_allclose(vec.numpy(), jvec, rtol=0, atol=VEC_ATOL)
    assert (vec.numpy() == jvec).mean() > 0.5
    pem, pvec = (np.asarray(a) for a in edge_front_pallas(jnp.asarray(labb)))
    np.testing.assert_allclose(em.numpy(), pem, rtol=0, atol=PALLAS_ATOL)
    np.testing.assert_allclose(vec.numpy(), pvec, rtol=0, atol=PALLAS_ATOL)


@pytest.mark.parametrize("shape,seed", [((32, 44), 0), ((37, 45), 1)])
def test_thinthres_matches_xla_and_pallas(shape, seed):
    labb = _labb(*shape, seed)
    jem, jvec = (np.asarray(a) for a in _jax_em_vec(jnp.asarray(labb)))
    want = np.asarray(_jax_thin(jnp.asarray(jem), jnp.asarray(jvec)))
    got = hopper_thin.thinthres(_t(jem), _t(jvec)).numpy()
    np.testing.assert_array_equal(got, want)
    pal = np.asarray(thinthres_pallas(jnp.asarray(jem), jnp.asarray(jvec)))
    np.testing.assert_allclose(got, pal, rtol=0, atol=PALLAS_ATOL)
    np.testing.assert_array_equal(got > 0, pal > 0)


def test_thincubic_plain_matches_xla():
    labb = _labb(32, 44, 3)
    jem, jvec = (np.asarray(a) for a in _jax_em_vec(jnp.asarray(labb)))
    want = np.asarray(jax.jit(jthin.thincubic)(jnp.asarray(jem),
                                               jnp.asarray(jvec)))
    got = hopper_thin.thinthres(_t(jem), _t(jvec), mode="cubic").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,seed", [((32, 44), 0), ((37, 45), 1),
                                        ((96, 128), 2)])
def test_edge_frontend_matches_jax(shape, seed):
    bgr = synth_scene(*shape, seed)
    want = _jax_frontend(jnp.asarray(bgr))
    got = edge_frontend(_t(bgr))
    np.testing.assert_array_equal(got.packed0.numpy(), np.asarray(want.packed0))
    np.testing.assert_array_equal(got.labb.numpy(), np.asarray(want.labb))
    np.testing.assert_array_equal(got.edge_bin.numpy(),
                                  np.asarray(want.edge_bin))
    assert got.edge_bin.dtype == torch.int32
    np.testing.assert_allclose(got.edge_thin.numpy(),
                               np.asarray(want.edge_thin), rtol=0,
                               atol=THIN_ATOL)


def test_wrappers_refuse_other_devices():
    labb = torch.zeros((8, 8, 3), device="meta")
    with pytest.raises(ValueError):
        hopper_grad.edge_front(labb)
    with pytest.raises(ValueError):
        hopper_thin.thinthres(torch.zeros((8, 8)), torch.zeros((8, 8, 2),
                                                               device="meta"))
