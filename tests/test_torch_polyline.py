"""PyTorch port, polyline stage: compaction, the arc walk and
polyline_execute against the JAX package on the CPU.

Synthetic edge maps with open chains, closed rings (the cycle re-walk),
corners and speckle.  Every integer output, every SegmentArena integer
field, `count` and `lsid` must be equal; float fields within atol 1e-4
(the port carries XLA's multiply-add contraction, ops/fp.py, and runs the
segment sums in slot order, so they are in fact bit-equal here).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rectdetect_tpu.config import PipelineConfig as JaxConfig
from rectdetect_tpu.ops import chain as jchain
from rectdetect_tpu.ops import compact as jcompact
from rectdetect_tpu.ops import morphology as jmorph
from rectdetect_tpu.ops import polyline as jpolyline

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.ops import chain, compact, polyline

# The suite runs several test workers on shared cores: a torch thread pool
# per worker would oversubscribe them, and these tensors are small.
torch.set_num_threads(1)

FLOAT_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene_edges(h=64, w=80, seed=1, speckle=0.04):
    """Binary edge map: a box outline (a ring), a circle, a polyline with
    corners, a long diagonal and speckle."""
    r = np.random.default_rng(seed)
    m = (r.random((h, w)) < speckle).astype(np.int32)
    m[6, 6:40] = 1
    m[30, 6:40] = 1
    m[6:31, 6] = 1
    m[6:31, 39] = 1
    yy, xx = np.mgrid[0:h, 0:w]
    ring = np.abs(np.hypot(yy - 44, xx - 58) - 12) < 0.6
    m[ring] = 1
    for i in range(30):                       # zig-zag polyline
        m[36 + i // 3, 4 + i] = 1
    for i in range(50):
        m[10 + i // 2, 44 + i // 3] = 1       # shallow diagonal
    return m


def _arena_equal(got, want):
    for f in want._fields:
        a = np.asarray(getattr(want, f))
        b = getattr(got, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=FLOAT_ATOL,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("cap", [100, 4096])
def test_compact_mask_and_subset_match_jax(cap):
    r = np.random.default_rng(3)
    mask = r.random(3000) < 0.1
    jc = jcompact.compact_mask(jnp.asarray(mask), cap)
    c = compact.compact_mask(_t(mask), cap)
    for f in ("idx", "slot_of", "n"):
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      np.asarray(getattr(jc, f)))
    keep = r.random(cap) < 0.5
    js = jcompact.compact_subset(jc, jnp.asarray(keep), 60)
    s = compact.compact_subset(c, _t(keep), 60)
    for f in ("idx", "slot_of", "n"):
        np.testing.assert_array_equal(getattr(s, f).numpy(),
                                      np.asarray(getattr(js, f)))


@pytest.mark.parametrize("seed", [1, 2])
def test_arc_chain_sparse_matches_jax(seed):
    edge = _scene_edges(seed=seed)
    strings = np.asarray(jmorph.strings_chain(jnp.asarray(edge),
                                              "poly_branch"))
    h, w = strings.shape
    sp, cyc_cap = max(4096, h * w // 4), max(1024, h * w // 24)
    jc = jcompact.compact_mask(jnp.asarray(strings != 0).reshape(-1), sp)
    # the JAX tail-staged walk (as the polyline tail runs it) against the
    # port's full-table walk
    want = jax.jit(lambda s: jchain.arc_chain_sparse(
        s, jc, 14, cyc_cap, tail_switch_rounds=3, tail_cap=4096,
        cyc_pin=2))(jnp.asarray(strings))
    c = compact.compact_mask(_t(strings != 0).reshape(-1), sp)
    got = chain.arc_chain_sparse(_t(strings), c, 14, cyc_cap)
    names = ("number", "head", "live", "cyc", "chainlen", "arcmin")
    for name, g, wv in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv), err_msg=name)
    assert got[3].any()                        # the rings walk as cycles


@pytest.mark.parametrize("seed,minerror,size_thre,cap",
                         [(1, 1.0, 20, None), (2, 4.0, 10, None),
                          (1, 1.0, 10, 16)])
def test_polyline_execute_matches_jax(seed, minerror, size_thre, cap):
    """cap=16: the arena overflows during the subdivision (more splits
    than free ids), the case that the JAX package's mkpl kernel excludes;
    the JAX side is its XLA mkpl_subdivide."""
    edge = _scene_edges(seed=seed)
    h, w = edge.shape
    cap = cap or JaxConfig().ls_cap_for(w, h)
    jcfg = JaxConfig(mkpl_pallas=0)
    ja, jl = jax.jit(lambda e: jpolyline.polyline_execute(
        e, minerror, size_thre, cap, jcfg))(jnp.asarray(edge))
    ta, tl = polyline.polyline_execute(_t(edge), minerror, size_thre, cap,
                                       PipelineConfig(mkpl_pallas=0))
    _arena_equal(ta, ja)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(ta.count) > 3
    if cap == 16:
        assert int(ta.count) == cap - 1


def test_mkpl_kernel_config_runs_plain_on_cpu_only():
    """DEFAULT_CONFIG (mkpl_pallas=1) on a CPU tensor: the mkpl wrapper
    runs the plain subdivision, and the result equals the JAX package's
    default configuration."""
    edge = _scene_edges(seed=3)
    cap = PipelineConfig().ls_cap_for(80, 64)
    ja, jl = jax.jit(lambda e: jpolyline.polyline_execute(
        e, 1.0, 20, cap, JaxConfig()))(jnp.asarray(edge))
    ta, tl = polyline.polyline_execute(_t(edge), 1.0, 20, cap,
                                       PipelineConfig())
    _arena_equal(ta, ja)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
