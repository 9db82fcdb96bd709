"""PyTorch port, the rect path's edge labeling and region smoothing against
the JAX package on the CPU: the segmented scan (kernel #10's plain
version), the strength pair, the packed-Lab helpers, blblur (#12) and
quantize + despeckle (#5), and the slice edge_frontend ->
weak_strong_labels -> region_smoothing as a whole.

The Pallas kernels run in interpret mode off the TPU.  Every output here
is integer-valued and must be equal.  Weak labels: the JAX package's CPU
path labels with a fixed-pass CCL and the port with the exact K4, so
label values are compared where the JAX labels equal
ccl.label_components_converged; the > 0 maps, and so the blurred and
despeckled planes, are compared everywhere.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_scene
from rectdetect_tpu.config import PipelineConfig as JaxConfig
from rectdetect_tpu.core import color as jcolor
from rectdetect_tpu.ops import ccl as jccl
from rectdetect_tpu.ops import morphology as jmorph
from rectdetect_tpu.ops import regions as jregions
from rectdetect_tpu.ops.pallas_blblur import blblur_pallas_blocked
from rectdetect_tpu.ops.pallas_morph import quant_despeckle_pallas
from rectdetect_tpu.ops.pallas_scan import seg_scan_sorted, seg_total_sorted
from rectdetect_tpu.pipeline.frontend import edge_frontend as jax_frontend
from rectdetect_tpu.pipeline.rect import weak_strong_labels as jax_labels

from rectdetect_tpu_torch.core import color
from rectdetect_tpu_torch.ops import ccl, hopper_scan, regions
from rectdetect_tpu_torch.ops.hopper_ccl import label_components
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.rect import (region_smoothing,
                                                weak_strong_labels)

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _packed(h, w, seed):
    r = np.random.default_rng(seed)
    return ((r.integers(0, 1024, (h, w)) << 22)
            | (r.integers(0, 1024, (h, w)) << 12)
            | r.integers(0, 4096, (h, w))).astype(np.int32)


@pytest.mark.parametrize("op", ["satsum", "max", "total"])
def test_seg_scan_matches_jax_pallas(op):
    """Sorted keys with runs of 1 to 400 elements, so that runs cross the
    128-element rows and the 1024-element blocks of the Pallas kernel;
    values below the cap, where the JAX kernel's int32 sums are exact."""
    r = np.random.default_rng(11)
    lengths = np.concatenate([r.integers(1, 4, 120), r.integers(100, 400, 8)])
    key = np.repeat(np.arange(lengths.size), r.permutation(lengths))
    key = key[:3000].astype(np.int32)
    val = r.integers(0, 300, key.size).astype(np.int32)
    cap = 2500
    if op == "total":
        want = seg_total_sorted(jnp.asarray(key), jnp.asarray(val), cap, rb=8)
        got = hopper_scan.seg_total_sorted(_t(key), _t(val), cap)
    else:
        want = seg_scan_sorted(jnp.asarray(key), jnp.asarray(val), op=op,
                               cap=cap, rb=8)
        got = hopper_scan.seg_scan_sorted(_t(key), _t(val), op, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == cap).any() or op == "max"


@pytest.mark.parametrize("cap", [None, 60])
def test_strength_filter_pair_dense_matches_jax(cap):
    """The same labels into both; cap=None is the pipeline's n // 3,
    cap=60 drops the largest labels' pixels (the last run's highest flat
    indices first) to the filtered state."""
    r = np.random.default_rng(3)
    h, w = 40, 56
    edge = (r.random((h, w)) < 0.3).astype(np.int32)
    edge[8, 2:50] = 1
    lbl = label_components(_t(edge), 0).numpy()
    thin = np.where(edge > 0, r.random((h, w)) * 0.6, 0).astype(np.float32)
    cap = cap or max(4096, h * w // 3)
    want = jax.jit(lambda e, l: jccl.strength_filter_pair_dense(
        e, l, cap, 500, 2500, 10000.0))(jnp.asarray(thin), jnp.asarray(lbl))
    got = ccl.strength_filter_pair_dense(_t(thin), _t(lbl), cap, 500, 2500,
                                         10000.0)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    weak = got[0].numpy()
    assert (weak > 0).any() and (weak == -1).any()


def test_lab_packing_matches_jax():
    r = np.random.default_rng(5)
    raw = [r.integers(-50, 4200, 500).astype(np.int32) for _ in range(3)]
    packed = jcolor.pack_lab_int(*map(jnp.asarray, raw))
    np.testing.assert_array_equal(color.pack_lab_int(*map(_t, raw)).numpy(),
                                  np.asarray(packed))
    p = _packed(20, 25, 5)
    for g, wv in zip(color.unpack_lab_int(_t(p)),
                     jcolor.unpack_lab_int(jnp.asarray(p))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(color.unpack_labf(_t(p)).numpy(),
                                  np.asarray(jcolor.unpack_labf(p)))


@pytest.mark.parametrize("horizontal", [True, False])
def test_blblur_axis_matches_jax(horizontal):
    r = np.random.default_rng(7)
    p = _packed(37, 53, 7)
    edge = (r.random(p.shape) < 0.25).astype(np.int32)
    edge[10, :] = 1
    edge[:, 20] = 1
    want = jax.jit(lambda a, e: jregions._blblur_axis(a, e, horizontal))(
        p, edge)
    got = regions._blblur_axis(_t(p), _t(edge), horizontal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_blblur_matches_jax_and_pallas():
    r = np.random.default_rng(8)
    p = _packed(64, 80, 8)
    edge = (r.random(p.shape) < 0.15).astype(np.int32)
    want = jax.jit(lambda a, e: jregions.blblur(a, e, 10))(p, edge)
    got = regions.blblur(_t(p), _t(edge), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the interpreted Pallas kernel costs ~2 s per iteration here
    small = (slice(0, 32), slice(0, 44))
    want = blblur_pallas_blocked(jnp.asarray(p[small]),
                                 jnp.asarray(edge[small]), 2)
    got = regions.blblur(_t(p[small]), _t(edge[small]), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_despeckle_matches_jax_and_pallas():
    r = np.random.default_rng(9)
    p = _packed(64, 80, 9)
    emag = np.where(r.random(p.shape) < 0.4, r.random(p.shape),
                    0).astype(np.float32)
    for n in (24, 7):
        want = jax.jit(lambda a, e: jregions.quantize_despeckle(
            a, e, n, n, n))(p, emag)
        got = regions.quantize_despeckle(_t(p), _t(emag), n, n, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    small = (slice(0, 32), slice(0, 44))
    want = quant_despeckle_pallas(jnp.asarray(p[small]),
                                  jnp.asarray(emag[small]))
    got = regions.quantize_despeckle(_t(p[small]), _t(emag[small]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,seed", [((32, 44), 0), ((64, 80), 1)])
def test_region_slice_matches_jax(shape, seed):
    """edge_frontend -> weak_strong_labels -> region_smoothing against
    the same JAX composition."""
    bgr = synth_scene(*shape, seed)
    jcfg = JaxConfig()

    def jax_slice(b):
        fe = jax_frontend(b, jcfg)
        weak, strong, _, _ = jax_labels(fe.edge_bin, fe.edge_thin, jcfg)
        s = jmorph.strings_chain(fe.edge_bin, "rect")
        conv = jccl.label_components_converged(s, 0)
        pieces = jccl.label_components_adaptive(
            s, 0, jcfg.ccl_passes, jcfg.ccl_jumps,
            small_cap=max(4096, b.shape[0] * b.shape[1] // 8),
            big_cap=max(4096, b.shape[0] * b.shape[1] // 3),
            round_cap=jcfg.weak_ccl_round_cap, pieces_ok=True)
        blurred = jregions.blblur(fe.packed0, (weak > 0).astype(jnp.int32),
                                  jcfg.blblur_iters)
        n = jcfg.quantize_levels
        despeck = jregions.quantize_despeckle(blurred, fe.edge_thin, n, n, n)
        return weak, strong, blurred, despeck, pieces == conv

    *want, converged = map(np.asarray, jax.jit(jax_slice)(jnp.asarray(bgr)))
    fe = edge_frontend(_t(bgr))
    weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin)
    blurred, despeck = region_smoothing(fe.packed0, weak, fe.edge_thin)
    for name, g, wv in zip(("weak", "strong"), (weak, strong), want[:2]):
        g = g.numpy()
        np.testing.assert_array_equal(g > 0, wv > 0, err_msg=name)
        np.testing.assert_array_equal(g[converged], wv[converged],
                                      err_msg=name)
    np.testing.assert_array_equal(blurred.numpy(), want[2])
    np.testing.assert_array_equal(despeck.numpy(), want[3])
    assert (want[0] > 0).sum() > 20 and converged.mean() > 0.9
