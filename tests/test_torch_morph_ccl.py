"""PyTorch port, K3 (strings_chain) and K4 (label_components) plus the
strength filter, against the JAX package on the CPU.

Integer outputs, so every comparison is exact: the port's plain versions
against the XLA compositions (morphology.strings_chain,
ccl.label_components_converged) and against the interpret-mode Pallas
kernels (morph_chain_pallas, pallas_ccl.label_components_exact).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectdetect_tpu.ops import ccl as jccl
from rectdetect_tpu.ops import morphology as jmorph
from rectdetect_tpu.ops.pallas_ccl import label_components_exact
from rectdetect_tpu.ops.pallas_morph import morph_chain_pallas

from rectdetect_tpu_torch.ops import ccl, hopper_ccl, hopper_morph

# The suite runs several test workers on shared cores: a torch thread pool
# per worker would oversubscribe them, and these tensors are small.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _edge_map(h=40, w=56, seed=7):
    """Binary edge-like map: straight and diagonal strokes, a box outline,
    1-px gaps, blobs and 12% speckle."""
    r = np.random.default_rng(seed)
    m = (r.random((h, w)) < 0.12).astype(np.int32)
    m[5, 3:50] = 1
    m[5, 20] = 0                             # 1-px gap
    for i in range(25):
        m[8 + i, 10 + i] = 1                 # diagonal
    m[12:30, 40] = 1
    m[12, 36:52] = 1
    m[29, 36:52] = 1
    m[12:30, 51] = 1
    m[30:36, 4:12] = 1                       # blob
    return m


def _spiral(h=24, w=24):
    img = np.zeros((h, w), np.int32)
    top, bot, left, right = 0, h - 1, 0, w - 1
    while top <= bot and left <= right:
        img[top, left:right + 1] = 1
        img[top:bot + 1, right] = 1
        img[bot, left:right + 1] = 1
        img[top:bot + 1, left] = 1
        top, bot, left, right = top + 3, bot - 3, left + 3, right - 3
    return img


def _blobs(h=32, w=40, seed=3):
    return (np.random.default_rng(seed).random((h, w)) < 0.55).astype(np.int32)


def _noise45(h=36, w=44, seed=9):
    return (np.random.default_rng(seed).random((h, w)) < 0.45).astype(np.int32)


@pytest.mark.parametrize("variant", ["rect", "poly_branch"])
def test_strings_chain_matches_xla_and_pallas(variant):
    for m in (_edge_map(), _noise45()):
        got = hopper_morph.strings_chain(_t(m), variant).numpy()
        want = np.asarray(jax.jit(lambda e: jmorph.strings_chain(e, variant))(
            jnp.asarray(m)))
        np.testing.assert_array_equal(got, want)
        pal = np.asarray(morph_chain_pallas(jnp.asarray(m), variant, bh=16))
        np.testing.assert_array_equal(got, pal)


_converged = jax.jit(jccl.label_components_converged, static_argnums=1)


@pytest.mark.parametrize("name,pix", [("blobs", _blobs()),
                                      ("spiral", _spiral()),
                                      ("noise45", _noise45()),
                                      ("multivalue", np.random.default_rng(5)
                                       .integers(0, 3, (28, 36))
                                       .astype(np.int32))])
def test_label_components_matches_converged_and_pallas(name, pix):
    got = hopper_ccl.label_components(_t(pix), 0).numpy()
    np.testing.assert_array_equal(got, np.asarray(_converged(
        jnp.asarray(pix), 0)))
    np.testing.assert_array_equal(got, np.asarray(label_components_exact(
        jnp.asarray(pix), 0, bh=8)))
    assert got.dtype == np.int32


def test_label_components_other_background():
    pix = np.random.default_rng(6).integers(0, 3, (20, 24)).astype(np.int32)
    got = hopper_ccl.label_components(_t(pix), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(_converged(
        jnp.asarray(pix), 2)))


def test_strength_filter_matches_jax():
    r = np.random.default_rng(12)
    edge = (r.random((40, 56)) * (_edge_map() > 0)).astype(np.float32)
    lbl_np = np.asarray(_converged(jnp.asarray((edge > 0).astype(np.int32)),
                                   0))
    jst = np.asarray(jccl.calc_strength(jnp.asarray(edge),
                                        jnp.asarray(lbl_np), 10000.0))
    st = ccl.calc_strength(_t(edge), _t(lbl_np), 10000.0)
    np.testing.assert_array_equal(st.numpy(), jst)
    for thre in (500, 2500):
        want = np.asarray(jccl.filter_strength(jnp.asarray(lbl_np),
                                               jnp.asarray(jst), thre))
        got = ccl.filter_strength(_t(lbl_np), st, thre).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError):
        hopper_morph.strings_chain(torch.zeros((8, 8), dtype=torch.int32,
                                               device="meta"), "rect")
    with pytest.raises(ValueError):
        hopper_ccl.label_components(torch.zeros((8, 8), dtype=torch.int32,
                                                 device="meta"), 0)
    with pytest.raises(ValueError):
        hopper_morph.strings_chain(_t(_edge_map()), "poly")
