"""PyTorch port, the rect path from the region maps to the hypotheses
against the JAX package on the CPU: the plain versions of kernels #6 merge
mask, #9 links CCL, #8 despeckle2 and #7 distinct bids against the jitted
JAX functions and the interpreted Pallas kernels, the boundary labels, the
reduceLS / member stage, clipping, and rect_hypotheses as a whole.

Every output compared here is integer-valued and must be equal, except
`segs` (float32 endpoints), which is expected bit-equal and held to the
port's arena tolerance, 1e-4 px.

Where the JAX package's CPU path and the port differ by design:
  * boundary labels: the JAX CPU path runs a fixed-pass CCL; the port's
    labels are exact, so they are held against
    ccl.label_components_converged, and the capacity drop against the
    interpreted pallas_ccl.label_components_exact(..., comp=...);
  * the JAX references run with the branch pins at 2 (big slot lists,
    full-table walk, cycle re-walk always, dense despeckle2), the only
    branches the port has; the JAX package holds the pinned and the
    runtime-selected branches equal (tests/test_rect_pipeline.py).
The slice test starts the JAX chain at the region maps (despeck,
strong_lbl), which test_torch_regions.py holds equal to the JAX front of
the chain at the same shapes and seeds; compiling the whole JAX chain once
per shape would cost ~40 s.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from conftest import synth_scene
from rectdetect_tpu.config import PipelineConfig as JaxConfig
from rectdetect_tpu.geometry import clip as jclip
from rectdetect_tpu.ops import ccl as jccl
from rectdetect_tpu.ops import pallas_ccl, pallas_morph
from rectdetect_tpu.ops import polyline as jpoly
from rectdetect_tpu.ops import reduce_ls as jred
from rectdetect_tpu.ops import regions as jregions
from rectdetect_tpu.ops.compact import compact_mask as jcompact
from rectdetect_tpu.pipeline.rect import _hypotheses

from rectdetect_tpu_torch import convert
from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.geometry.clip import clip_segments
from rectdetect_tpu_torch.ops import hopper_bids, reduce_ls, regions
from rectdetect_tpu_torch.ops.compact import Compaction
from rectdetect_tpu_torch.pipeline import rect
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGS_ATOL = 1e-4
# the port's branches: big slot lists, full-table walk, cycle re-walk
# always, dense despeckle2
JCFG = JaxConfig(pin_strings_branch=2, pin_arc_branch=2, pin_walk_tail=2,
                 pin_walk_prefilter=2, pin_cycle_walk=2, pin_region_runs=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want, msg=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=msg)


def _strong(h, w, seed, p=0.08):
    """Strong-label map: sparse labelled pixels, a long line (line ends,
    jn == 2) and a crossing (junction cores, jn > 2); background 0."""
    r = np.random.default_rng(seed)
    sl = (r.random((h, w)) < p).astype(np.int32)
    sl[h // 3, 5:w - 5] = 1
    sl[5:h - 5, w // 3] = 1
    return sl * r.integers(1, 1000, (h, w)).astype(np.int32)


def _regions(h, w, seed, levels=3):
    """Region labels of a blocky colour map merged by the port."""
    r = np.random.default_rng(seed)
    colors = np.kron(r.integers(0, levels, (h // 2 + 1, w // 2 + 1)),
                     np.ones((2, 2), np.int64))[:h, :w]
    colors[r.random((h, w)) < 0.05] = 9
    z = torch.zeros((h, w), dtype=torch.int32)
    return regions.label_merge(_t(colors.astype(np.int32)), z, z)


@pytest.mark.parametrize("case", ["odd", "negative"])
def test_junction_merge_mask_matches_jax_and_pallas(case):
    """#6's plain version against the jitted composition and the
    interpreted Pallas kernel; labels may be -1 (positive_only)."""
    sl = _strong(37, 53, 9)
    if case == "negative":
        sl[sl == 0] = -1
    got = regions.junction_merge_mask(_t(sl))
    _equal(got, jax.jit(jregions.junction_merge_mask)(sl))
    _equal(got, pallas_morph.merge_mask_pallas(jnp.asarray(sl), bh=16))
    assert 0 < int(got.sum()) < got.numel()


def _asymmetric():
    """tests/test_pallas_ccl.py::test_links_side_asymmetry_adversarial:
    two colours, where the preprocess seeds' left link (only where the up
    pixel differs) decides components."""
    r = np.random.default_rng(19)
    h, w = 33, 40
    pix = r.integers(0, 2, (h, w)).astype(np.int32)
    mask = (r.random((h, w)) < 0.1).astype(np.int32)
    elab = (r.random((h, w)) < 0.2).astype(np.int32) * 5
    return pix, mask, elab


def _merge_scene():
    """Blocky colours with noise, a merge-mask patch and strong edges."""
    r = np.random.default_rng(4)
    h, w = 40, 48
    pix = np.kron(r.integers(0, 4, (10, 12)), np.ones((4, 4), np.int64))
    pix = np.where(r.random((h, w)) < 0.1, 7, pix).astype(np.int32)
    mask = np.zeros((h, w), np.int32)
    mask[10:14, 20:30] = 1
    elab = np.where(r.random((h, w)) < 0.1, 3, 0).astype(np.int32)
    elab[:, 24] = 8
    return pix, mask, elab


@pytest.mark.parametrize("case", ["asymmetric", "scene"])
def test_label_merge_matches_jax_and_pallas(case):
    """#9's plain version (merge_pairs + label_links at the fixpoint)
    against the jitted JAX label_merge (its while_loop fixpoint), and on
    the asymmetric case against the interpreted links-mode Pallas CCL at
    bh=8 (block seams)."""
    pix, mask, elab = _asymmetric() if case == "asymmetric" \
        else _merge_scene()
    got = regions.label_merge(_t(pix), _t(mask), _t(elab))
    _equal(got, jax.jit(jregions.label_merge)(pix, mask, elab))
    if case == "asymmetric":
        _equal(got, pallas_ccl.label_merge_exact(
            jnp.asarray(pix), jnp.asarray(mask), jnp.asarray(elab), bh=8))
    lab = got.numpy()
    assert 1 < len(np.unique(lab)) < lab.size // 4


def _szmap(lbl, thre):
    """The Pallas kernel's input: each row run's region size at the run's
    first pixel, thre + 1 elsewhere (regions.sizes_despeckle2)."""
    h, w = lbl.shape
    flat = lbl.reshape(-1)
    sizes = np.bincount(flat, minlength=flat.size)
    start = np.concatenate([np.ones((h, 1), bool),
                            lbl[:, 1:] != lbl[:, :-1]], axis=1).reshape(-1)
    return np.where(start, sizes[flat], thre + 1).astype(
        np.int32).reshape(h, w)


@pytest.mark.parametrize("shape", [(40, 48), (33, 70)])
def test_sizes_despeckle2_matches_jax_and_pallas(shape):
    """#8's plain version (dense sizes + absorption) against the jitted
    JAX run-length form, the dense JAX pair (first shape) and the
    interpreted Pallas kernel."""
    lbl = _regions(*shape, seed=sum(shape), levels=4).numpy()
    got = regions.sizes_despeckle2(_t(lbl), 16)
    _equal(got, jax.jit(lambda x: jregions.sizes_despeckle2(x, 16))(lbl))
    if shape == (40, 48):
        _equal(got, jax.jit(lambda x: jregions.despeckle2(
            x, jregions.label_sizes(x), 16))(lbl))
    _equal(got, pallas_morph.despeckle2_pallas(
        jnp.asarray(lbl), jnp.asarray(_szmap(lbl, 16)), 16, bh=16))
    assert (got.numpy() != lbl).any()


def test_distinct_bids_matches_jax_and_pallas():
    """#7's plain version against reduce_ls._distinct_bids(..., 4) and the
    interpreted Pallas kernel, on blocky ids with -1 background: more than
    4 ids in some windows, so slots fill and later ids drop."""
    r = np.random.default_rng(13)
    b = np.full((40, 56), -1, np.int32)
    for _ in range(30):
        y, x = r.integers(0, 36), r.integers(0, 50)
        b[y:y + r.integers(1, 5), x:x + r.integers(1, 7)] = y * 56 + x + 1
    got = hopper_bids.distinct_bids(_t(b))
    want = jax.jit(lambda x: jred._distinct_bids(x, 4))(b)
    pal = pallas_morph.distinct_bids_pallas(jnp.asarray(b), bh=16)
    for i in range(4):
        _equal(got[i], want[i], f"slot {i}")
        _equal(got[i], pal[i], f"slot {i}")
    assert (got[3].numpy() > 0).any()


def _port_comp(c) -> Compaction:
    return Compaction(idx=_t(c.idx), slot_of=_t(c.slot_of), n=_t(c.n))


@pytest.mark.parametrize("overflow", [False, True])
def test_boundary_labels_match_jax(overflow):
    """boundary_labels: exact labels of mark_boundary's pixels, the
    compaction capacity max(4096, H*W // boundary_sparse_factor).  Without
    overflow they equal the converged JAX labels; with a capacity below the
    boundary count, the interpreted label_components_exact(comp=...),
    which drops the pixels beyond it."""
    h, w = (72, 96) if overflow else (40, 56)
    seg = _regions(h, w, seed=2 if overflow else 5, levels=4 if overflow
                   else 2)
    cfg = PipelineConfig(boundary_sparse_factor=h * w if overflow else 3)
    spb = max(4096, h * w // cfg.boundary_sparse_factor)
    got, bcomp = rect.boundary_labels(seg, cfg)

    def marks(s):
        bm = jregions.mark_boundary(s)
        return bm, jcompact((bm != -1).reshape(-1), spb)

    bmark, jcomp = jax.jit(marks)(seg.numpy())
    _equal(regions.mark_boundary(seg), bmark)
    for f in ("idx", "slot_of", "n"):
        _equal(getattr(bcomp, f), getattr(jcomp, f), f)
    n_fg = int((np.asarray(bmark) != -1).sum())
    if overflow:
        assert n_fg > spb
        # one block: the drop does not depend on the block seams
        want = pallas_ccl.label_components_exact(bmark, -1, comp=jcomp)
        _equal(got, want)
        assert int((got.numpy() != -1).sum()) == spb
        return
    _equal(got, jax.jit(lambda x: jccl.label_components_converged(x, -1))(
        bmark))
    assert n_fg > 200


def test_clip_segments_matches_jax():
    r = np.random.default_rng(21)
    segs = (r.random((500, 4)) * 60 - 10).astype(np.float32)
    segs[:50, 2] = segs[:50, 0]                   # vertical
    segs[50:100, 3] = segs[50:100, 1]             # horizontal
    lo = r.random((500, 2)) * 30
    boxes = np.concatenate([lo, lo + r.random((500, 2)) * 30 + 1],
                           axis=1).astype(np.float32)
    got = clip_segments(_t(segs), _t(boxes))
    want = np.asarray(jax.jit(jclip.clip_segments)(segs, boxes))
    _equal(torch.isnan(got), np.isnan(want))
    assert (np.nan_to_num(got.numpy()) == np.nan_to_num(want)).all()
    assert np.isnan(want).any() and (~np.isnan(want)).any()


def _rect_scene(h, w):
    """A colour map with three overlapping filled rectangles (its regions)
    and an lsid image: segment ids along the rectangles' outlines."""
    r = np.random.default_rng(8)
    colour = np.zeros((h, w), np.int32)
    lsid = np.zeros((h, w), np.int32)
    for i, (y0, x0, y1, x1) in enumerate(((4, 4, 30, 40), (12, 46, 50, 90),
                                          (36, 8, 60, 30))):
        colour[y0:y1 + 1, x0:x1 + 1] = i + 1
        for sl in ((y0, slice(x0, x1 + 1)), (y1, slice(x0, x1 + 1)),
                   (slice(y0, y1 + 1), x0), (slice(y0, y1 + 1), x1)):
            lsid[sl] = r.integers(1, 250)
    return colour, lsid


def _jax_arena(h, w, cap=256, seed=6):
    """A JAX SegmentArena: 180 live segments in chains of 1-6 (polyid =
    the head's id, left/right pointers along the chain), a few dead ids;
    endpoints on the half-pixel grid, so rint and the probes' floor(x +
    0.5) meet ties, and some longer than 32 px."""
    from rectdetect_tpu.ops.polyline import SegmentArena as JaxArena
    r = np.random.default_rng(seed)
    f = {k: np.zeros(cap, np.int32) for k in JaxArena._fields
         if k not in ("sx", "sy", "ex", "ey", "count")}
    xy = [np.zeros(cap, np.float32) for _ in range(4)]
    i = 1
    while i < 181:
        n = int(r.integers(1, 7))
        for j in range(n):
            s = i + j
            f["polyid"][s] = i
            f["left_ptr"][s] = s - 1 if j else 0
            f["right_ptr"][s] = s + 1 if j < n - 1 else 0
            f["npix"][s] = 5
        i += n + int(r.integers(0, 2))          # a dead id between chains
    live = f["polyid"] != 0
    xy[0][:] = r.integers(0, 2 * w, cap) / 2
    xy[1][:] = r.integers(0, 2 * h, cap) / 2
    ln = np.where(r.random(cap) < 0.3, 40, 12)
    ang = r.random(cap) * 2 * np.pi
    xy[2][:] = np.clip(np.round(2 * (xy[0] + ln * np.cos(ang))) / 2, 0, w - 1)
    xy[3][:] = np.clip(np.round(2 * (xy[1] + ln * np.sin(ang))) / 2, 0, h - 1)
    for a in xy:
        a[~live] = 0
    sx, sy, ex, ey = map(jnp.asarray, xy)
    return JaxArena(sx=sx, sy=sy, ex=ex, ey=ey, count=jnp.int32(i),
                    **{k: jnp.asarray(v) for k, v in f.items()})


def test_reduce_stage_matches_jax():
    """pair_bbox_table at a small table size, where (lsid, bid) pairs
    collide and drop (the pipeline's size is in the slice test),
    densify_labels_sparse, probe_members and chain_members (by length and
    by lsid) and chain_heads, on a JAX arena carried across with
    convert.arena_from_numpy."""
    h, w = 64, 96
    colour, lsid_np = _rect_scene(h, w)
    arena_j = _jax_arena(h, w)
    arena = convert.arena_from_numpy(convert.arena_to_numpy(arena_j))
    lsid = _t(lsid_np)
    comp_j = jcompact(jnp.asarray((lsid_np > 0).reshape(-1)), 4096)
    comp = _port_comp(comp_j)
    edge = np.zeros((h, w), np.int32)
    seg = rect.region_merge(_t(colour), _t(edge), PipelineConfig())[1]
    boundary, bcomp = rect.boundary_labels(seg)
    jbcomp = jcompact(jnp.asarray((boundary.numpy() != -1).reshape(-1)),
                      bcomp.cap)
    gmax, k = 12, 6
    small = 97

    def jax_side(b, ls, c, a, bc):
        tab = jred.pair_bbox_table(b, ls, small, comp=c)
        f2d, count, roots = jred.densify_labels_sparse(b, bc, gmax, bg=-1)
        probes = [jred.probe_members(b, a, gmax, f2d, k, 3, 2, by_length=bl)
                  for bl in (True, False)]
        chains = [jred.chain_members(a, gmax, k, 32.0, by_length=bl)
                  for bl in (True, False)]
        return tab, (f2d, count, roots), probes, chains, jred.chain_heads(a)

    tab, dens, probes, chains, heads = jax.jit(jax_side)(
        boundary.numpy(), lsid_np, comp_j, arena_j, jbcomp)
    got = reduce_ls.pair_bbox_table(boundary, lsid, small, comp=comp)
    for g, wv, f in zip(got, tab, ("owner_lsid", "owner_bid", "bb")):
        _equal(g, wv, f)
    # some pairs collide: fewer owners than distinct claiming pairs
    bids = torch.stack(hopper_bids.distinct_bids(boundary)).numpy()
    ls_in = np.zeros((h, w), np.int32)
    ls_in[1:-1, 1:-1] = lsid_np[1:-1, 1:-1]
    pairs = np.stack([np.tile(ls_in.reshape(-1), 4), bids.reshape(-1)], 1)
    claims = np.unique(pairs[(pairs > 0).all(1)], axis=0)
    assert 0 < int((got.owner_lsid > 0).sum()) < len(claims)
    got = reduce_ls.densify_labels_sparse(boundary, bcomp, gmax, bg=-1)
    for g, wv in zip(got, dens):
        _equal(g, wv)
    table = got[0]
    for bl, want in zip((True, False), probes):
        got = reduce_ls.probe_members(boundary, arena, gmax, table, k, 3, 2,
                                      by_length=bl)
        for g, wv in zip(got, want):
            _equal(g, wv, f"probe by_length={bl}")
    for bl, want in zip((True, False), chains):
        got = reduce_ls.chain_members(arena, gmax, k, 32.0, by_length=bl)
        for g, wv in zip(got, want):
            _equal(g, wv, f"chain by_length={bl}")
    _equal(reduce_ls.chain_heads(arena), heads)
    assert int(np.asarray(dens[1])) >= 3
    # groups fill past k, so the selection order matters
    assert np.asarray(probes[0][1]).all(1).any()
    assert np.asarray(chains[0][1]).any()


@pytest.mark.parametrize("weighted", [True, False])
def test_first_k_members_matches_jax(weighted):
    """The member selection on a random relation with duplicates, pairs
    outside the groups and ties in the quantized weight."""
    r = np.random.default_rng(5)
    n_groups, cap, k = 17, 256, 6
    m = 15 * cap
    g = r.integers(-2, n_groups + 3, m).astype(np.int32)
    lsid = r.integers(-1, cap + 2, m).astype(np.int32)
    lw = (r.integers(0, 40, cap + 3) ** 2).astype(np.float32)
    wt = lw[np.clip(lsid, 0, cap + 2)] if weighted else None
    want = jax.jit(lambda a, b, c: jred.first_k_members(
        a, b, n_groups, k, cap, weight=c))(g, lsid, wt)
    got = reduce_ls.first_k_members(_t(g), _t(lsid), n_groups, k, cap,
                                    weight=None if wt is None else _t(wt))
    for x, y, f in zip(got, want, ("ids", "valid", "counts")):
        _equal(x, y, f)


def test_hash_slot_matches_jax():
    r = np.random.default_rng(3)
    a = r.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64).astype(np.int32)
    b = r.integers(-2 ** 31, 2 ** 31, 4000, dtype=np.int64).astype(np.int32)
    a[:100] = r.integers(0, 5000, 100)
    for ne in (97, 737280):
        _equal(reduce_ls.hash_slot(_t(a), _t(b), ne),
               jax.jit(lambda x, y: jred._hash(x, y, ne))(a, b))


def _jax_tail(despeck, strong, cfg):
    """rect_tail's stages from the region maps on: region merge, boundary
    labels (converged), polylines of the strong edges, _hypotheses."""
    ih, iw = despeck.shape
    mask = jregions.junction_merge_mask(strong)
    seg = jregions.label_merge(despeck, mask, strong)
    seg = jregions.sizes_despeckle2(seg, cfg.despeckle2_thre,
                                    cfg.region_run_factor,
                                    pin=cfg.pin_region_runs)
    bmark = jregions.mark_boundary(seg)
    spb = max(4096, ih * iw // cfg.boundary_sparse_factor)
    bcomp = jcompact((bmark != -1).reshape(-1), spb)
    boundary = jccl.label_components_converged(bmark, -1)
    arena, lsid, comp = jpoly.polyline_execute(
        (strong > 0).astype(jnp.int32), cfg.minerror_rect,
        cfg.size_thre_rect, cfg.ls_cap_for(iw, ih), cfg, return_comp=True)
    segs, valid, status = _hypotheses(arena, lsid, boundary, iw, ih, cfg,
                                      comp=comp, bcomp=bcomp)
    return mask, seg, boundary, lsid, segs, valid, status


@pytest.mark.parametrize("shape,seed", [((32, 44), 0), ((64, 80), 1)])
def test_rect_hypotheses_matches_jax(shape, seed):
    """rect_hypotheses on conftest.synth_scene against the JAX chain from
    the same region maps, with DEFAULT_CONFIG (the JAX side pinned to the
    port's branches): every map, valid and status equal, segs within
    1e-4 (bit-equal expected)."""
    bgr = synth_scene(*shape, seed)
    got = rect.rect_hypotheses(_t(bgr))
    fe = edge_frontend(_t(bgr))
    weak, strong = rect.weak_strong_labels(fe.edge_bin, fe.edge_thin)
    _, despeck = rect.region_smoothing(fe.packed0, weak, fe.edge_thin)
    want = jax.jit(lambda d, s: _jax_tail(d, s, JCFG))(despeck.numpy(),
                                                        strong.numpy())
    names = ("mask", "seg", "boundary", "lsid")
    for name, wv in zip(names, want[:4]):
        _equal(getattr(got, name), wv, name)
    _equal(got.valid, want[5], "valid")
    _equal(got.status, want[6], "status")
    np.testing.assert_allclose(got.segs.numpy(), np.asarray(want[4]),
                               rtol=0, atol=SEGS_ATOL)
    assert got.segs.shape == (2 * 192, 48, 2, 2)
    # live region-boundary groups
    assert got.valid[:192].any(1).sum() >= 1


def test_rect_hyp_fixture_is_the_jax_720p_reference():
    path = os.path.join(ROOT, "tests", "data", "rect_hyp_720p_synth.npz")
    assert os.path.getsize(path) < 200_000
    fx = np.load(path)
    assert tuple(fx["shape"]) == (720, 1280)
    for k in ("mask", "seg", "boundary", "lsid"):
        assert len(str(fx[f"{k}_sha256"])) == 64
    assert fx["segs"].shape == (384, 48, 2, 2)
    assert fx["valid"].shape == (384, 48) and fx["status"].shape == (384,)
    assert fx["valid"][:192].any(1).sum() >= 1
    assert np.isfinite(fx["segs"]).all()
    rx = np.load(os.path.join(ROOT, "tests", "data",
                              "rect_regions_720p_synth.npz"))
    assert str(fx["packed0_sha256"]) == str(rx["packed0_sha256"])


def test_rect_hypotheses_raises_on_unported_branches():
    seg = _regions(24, 32, seed=1)
    for cfg in (PipelineConfig(boundary_comp=0),
                PipelineConfig(boundary_tpu_sparse=True)):
        with pytest.raises(NotImplementedError):
            rect.boundary_labels(seg, cfg)
