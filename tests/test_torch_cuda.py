"""PyTorch port on a CUDA card: each kernel against its plain version, and
the poly path, the rect path's region maps, rect_hypotheses and
rect_frame on the card against the same paths on the CPU.

These tests need a card and skip without one.  They import neither JAX
nor the JAX package, so they run where only PyTorch is installed; the
repository's tests/conftest.py imports JAX, so on such a machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K3, K4, labels, strings, lsid and arena integer fields equal;
K1/K2 float outputs and arena floats within atol 2e-4 (the Pallas
kernels' contract; the plain version's float64 emulation of a fused
multiply-add may round twice on a tie), edge_thin > 0 equal.  The mkpl
kernel's arena is held bit-equal to the plain subdivision on the card
(the same float operations on both sides); seg_scan, blblur,
quant_despeckle, merge_mask, label_merge, despeckle2 and distinct_bids
are integer-valued and equal; rect_hypotheses' maps, valid and status
equal, segs within atol 2e-4.  The hyp and pose kernels run their plain
versions' float operations, so `ok` and c2 are held equal and the other
floats within rtol 1e-3 (bit-equal expected); rect_frame's valid and
status equal, its corners within 2e-4 px.  The blblur kernel is held
equal to the plain version at every fused round count it compiles, and
the pose kernel bit for bit (NaN in the same places).  The mkpl and links
kernels are held bit-equal on arenas whose arc numbers repeat or skip and
on frames of one region; K3 (both variants) and quant_despeckle bit-equal
from 1x1 to 720x1280; K2 in both modes from 5x5 to 33x1281 within ATOL
with edge_thin > 0 equal; despeckle2 equal on maps of one label a pixel
(the tables spill) and of one region (every tile adds to one size) up to
720x1280; launches are read from the kernel library's own counter
(`_build.launch_count`).
"""

import math

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch import parity
from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.geometry import pose, quad
from rectdetect_tpu_torch.ops import (_build, hopper_bids, hopper_blblur,
                                      hopper_ccl, hopper_despeckle2,
                                      hopper_grad, hopper_hyp, hopper_links,
                                      hopper_merge_mask, hopper_mkpl,
                                      hopper_morph, hopper_pose, hopper_quant,
                                      hopper_scan, hopper_thin, mkpl,
                                      polyline, regions)
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.poly import poly_frame
from rectdetect_tpu_torch.pipeline.rect import (boundary_labels, rect_frame,
                                                rect_geometry,
                                                rect_hypotheses,
                                                region_smoothing,
                                                weak_strong_labels)

pytestmark = pytest.mark.cuda

ATOL = 2e-4
POSE_RTOL = 1e-3
TAN_AOV = math.tan(math.radians(72.0) / 2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _scene(h=96, w=128, seed=2):
    """BGR frame: a background gradient, an axis-aligned and a tilted
    quad, and noise."""
    r = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.int32)
    img[:] = (40, 90, 120)
    yy, xx = np.mgrid[0:h, 0:w]
    img[..., 1] += (xx * 255 // w) // 4
    img[h // 6:h // 2, w // 8:w // 2] = (200, 60, 50)
    tilt = ((xx - yy * 0.5 > w * 0.55) & (xx - yy * 0.5 < w * 0.9) &
            (yy + 0.2 * xx > h * 0.3) & (yy + 0.2 * xx < h * 0.85))
    img[tilt] = (60, 180, 220)
    img += r.integers(0, 6, img.shape)
    return torch.from_numpy(img.clip(0, 255).astype(np.uint8))


def _maps():
    r = np.random.default_rng(7)
    edge = (r.random((40, 56)) < 0.12).astype(np.int32)
    edge[5, 3:50] = 1
    edge[12:30, 40] = 1
    spiral = np.zeros((24, 24), np.int32)
    t, b, lft, rgt = 0, 23, 0, 23
    while t <= b and lft <= rgt:
        spiral[t, lft:rgt + 1] = 1
        spiral[t:b + 1, rgt] = 1
        spiral[b, lft:rgt + 1] = 1
        spiral[t:b + 1, lft] = 1
        t, b, lft, rgt = t + 3, b - 3, lft + 3, rgt - 3
    noise = (r.random((36, 44)) < 0.45).astype(np.int32)
    multi = r.integers(0, 3, (28, 36)).astype(np.int32)
    return [torch.from_numpy(m) for m in (edge, spiral, noise, multi)]


def test_edge_front_and_thin_kernels_match_plain():
    _need_card()
    labb = edge_frontend(_scene().cuda()).labb
    em, vec = hopper_grad.edge_front(labb)
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    torch.testing.assert_close(em, em_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(vec, vec_p, rtol=0, atol=ATOL)
    for mode in ("thres", "cubic"):
        got = hopper_thin.thinthres(em, vec, mode=mode)
        want = hopper_thin.thin_plain(em, vec, mode=mode)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        assert torch.equal(got > 0, want > 0)


def test_morph_and_ccl_kernels_match_plain():
    _need_card()
    for m in _maps():
        p = m.cuda()
        for variant in ("rect", "poly_branch"):
            assert torch.equal(hopper_morph.strings_chain(p, variant),
                               hopper_morph.strings_chain_plain(p, variant))
        for bgc in (0, 2):
            assert torch.equal(hopper_ccl.label_components(p, bgc),
                               hopper_ccl.label_components_plain(p, bgc))


K3_CARD_SHAPES = [(1, 1), (1, 61), (61, 1), (37, 53), (33, 1281),
                  (720, 1280)]


@pytest.mark.parametrize("h,w", K3_CARD_SHAPES)
def test_morph_kernel_matches_plain_at_odd_sizes(h, w):
    """K3, both variants, bit-equal to the plain chain at densities 0.1,
    0.3 and 0.6 of values in {-1, 0, 1, 2} (rect counts only values > 0);
    one kernel per call by the library's own counter."""
    _need_card()
    r = np.random.default_rng(h * 7919 + w)
    for density in (0.1, 0.3, 0.6):
        vals = r.choice(np.array([-1, 1, 2], np.int32), size=(h, w))
        e = np.where(r.random((h, w)) < density, vals, 0).astype(np.int32)
        edge = torch.from_numpy(e)
        for variant in ("rect", "poly_branch"):
            n0 = _build.launch_count()
            got = hopper_morph.strings_chain(edge.cuda(), variant)
            torch.cuda.synchronize()
            assert _build.launch_count() == n0 + hopper_morph.KERNELS == n0 + 1
            want = hopper_morph.strings_chain_plain(edge, variant)
            assert torch.equal(got.cpu(), want), (density, variant)


@pytest.mark.parametrize("h,w", K3_CARD_SHAPES)
def test_quant_despeckle_kernel_matches_plain_at_odd_sizes(h, w):
    """quant_despeckle bit-equal to the plain version at edge shares 0,
    0.3 and 1 and level triples (24, 24, 24), (5, 7, 11), (1, 1, 1), the
    kernel's code table at its limit (255 levels), past it (300) and
    with a negative count (-3), where it divides per pixel; one kernel per
    call by the library's own counter."""
    _need_card()
    r = np.random.default_rng(h * 104729 + w)
    packed = torch.from_numpy(((r.integers(0, 1024, (h, w)) << 22)
                               | (r.integers(0, 1024, (h, w)) << 12)
                               | r.integers(0, 4096, (h, w)))
                              .astype(np.int32))
    for share in (0.0, 0.3, 1.0):
        on = r.random((h, w)) < share
        below = np.where(r.random((h, w)) < 0.5, 0.0, 9e-7)
        emag = torch.from_numpy(np.where(on, r.random((h, w)) + 1e-6, below)
                                .astype(np.float32))
        for levels in ((24, 24, 24), (5, 7, 11), (1, 1, 1), (255, 255, 255),
                       (300, 24, 24), (-3, 24, 24)):
            n0 = _build.launch_count()
            got = hopper_quant.quantize_despeckle(packed.cuda(), emag.cuda(),
                                                  *levels)
            torch.cuda.synchronize()
            assert _build.launch_count() == n0 + hopper_quant.KERNELS == n0 + 1
            want = regions.quantize_despeckle(packed, emag, *levels)
            assert torch.equal(got.cpu(), want), (share, levels)



def _thin_inputs(h, w, seed):
    """Edge magnitudes with plateaus, and unit vectors of random
    directions beside zero vectors and exact axis-aligned ones, where the
    sample position truncates on an integer."""
    r = np.random.default_rng(seed)
    em = r.random((h, w)).astype(np.float32)
    em[r.random((h, w)) < 0.2] = 0.5
    ang = r.random((h, w)) * 2 * np.pi
    vec = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    kind = r.integers(0, 4, (h, w))
    vec[kind == 1] = 0.0
    axis = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]], np.float32)
    vec[kind == 2] = axis[r.integers(0, 4, int((kind == 2).sum()))]
    return torch.from_numpy(em), torch.from_numpy(vec)


@pytest.mark.parametrize("h,w", [(5, 5), (7, 9), (13, 31), (37, 53),
                                 (70, 33), (33, 1281)])
def test_thin_kernel_matches_plain_at_odd_sizes(h, w):
    """K2 in both modes on frames smaller than one 16x32 tile and on odd
    sizes: the parent kernel's formula, op for op, so within ATOL of
    thin_plain (whose float64 multiply-add emulation may round twice on
    a tie) and edge_thin > 0 equal; one kernel per call."""
    _need_card()
    em, vec = _thin_inputs(h, w, seed=h * 31 + w)
    for mode in ("thres", "cubic"):
        n0 = _build.launch_count()
        got = hopper_thin.thinthres(em.cuda(), vec.cuda(), mode=mode)
        torch.cuda.synchronize()
        assert _build.launch_count() == n0 + 1
        want = hopper_thin.thin_plain(em, vec, mode=mode)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=ATOL)
        assert torch.equal(got.cpu() > 0, want > 0), mode
    # the kernel reads vec as float2: a 4-byte offset raises
    flat = torch.zeros(h * w * 2 + 1, device="cuda")
    with pytest.raises(ValueError):
        hopper_thin.thinthres(em.cuda(), flat[1:].view(h, w, 2))


def _despeckle2_maps(h, w, seed):
    """Label maps: every pixel its own label (more distinct labels a tile
    than its table holds), 2x2 blocks, regions of exactly thre and
    thre + 1 pixels, one region over the whole frame, and a few labels
    out of [0, h*w) (the size index is clamped)."""
    r = np.random.default_rng(seed)
    n = h * w
    flat = np.arange(n, dtype=np.int32).reshape(h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    blocks = flat[yy - yy % 2, xx - xx % 2]
    runs = flat[yy, xx - xx % 4]        # 1x4 runs of 4 pixels
    strips = np.where(r.random((h, w)) < 0.5, runs, blocks)
    odd = r.integers(0, 3, (h, w)).astype(np.int32) * (n // 3)
    odd[r.random((h, w)) < 0.05] = -5
    odd[r.random((h, w)) < 0.05] = n + 3
    return [torch.from_numpy(np.ascontiguousarray(m)) for m in (
        flat, blocks, strips, np.zeros((h, w), np.int32), odd)]


@pytest.mark.parametrize("h,w", [(1, 1), (1, 61), (61, 1), (37, 53),
                                 (33, 1281), (720, 1280)])
def test_despeckle2_kernel_matches_plain(h, w):
    """despeckle2 equal to regions.sizes_despeckle2 at thre 16, 4 and 3
    (regions of 4 pixels are just small enough, then just too large), on
    maps with far more labels a tile than its table holds (the spill
    path) and on one region over the whole frame (every tile adds to one
    size); one kernel per call."""
    _need_card()
    for i, lbl in enumerate(_despeckle2_maps(h, w, seed=h + w)):
        for thre in (16, 4, 3):
            n0 = _build.launch_count()
            got = hopper_despeckle2.sizes_despeckle2(lbl.cuda(), thre)
            torch.cuda.synchronize()
            assert (_build.launch_count() == n0 + hopper_despeckle2.KERNELS
                    == n0 + 1)
            want = regions.sizes_despeckle2(lbl, thre)
            assert torch.equal(got.cpu(), want), (i, thre)

def _walks(h, w, seed=3):
    """1-px chains: 8-connected random walks over sparse noise."""
    r = np.random.default_rng(seed + h * w)
    e = (r.random((h, w)) < 0.03).astype(np.int32)
    for _ in range(max(2, h * w // 300)):
        y, x = r.integers(0, h), r.integers(0, w)
        for _ in range(r.integers(5, 3 * (h + w))):
            e[y, x] = 1
            y = min(max(y + r.integers(-1, 2), 0), h - 1)
            x = min(max(x + r.integers(-1, 2), 0), w - 1)
    return torch.from_numpy(e)


def _staircase(h, w, anti, th=16, tw=32):
    """Value 1 on diagonal steps from tile to tile of the kernel's 16x32
    tiles that touch only at the tile corners (NW-SE, or NE-SW if anti)."""
    c = np.zeros((h, w), np.int32)
    ty, tx = 0, (w - 1) // tw if anti else 0
    while ty * th < h and 0 <= tx * tw < w:
        y0, x0 = ty * th, tx * tw
        y1, x1 = min(y0 + th, h) - 1, min(x0 + tw, w) - 1
        ya, xa, yb, xb = (y0, x1, y1, x0) if anti else (y0, x0, y1, x1)
        y, x = ya, xa
        while True:
            c[y, x] = 1
            if (y, x) == (yb, xb):
                break
            y += y < yb
            x += (x < xb) - (x > xb)
        ty += 1
        tx += -1 if anti else 1
    return torch.from_numpy(c)


def _region_marks(h, w, seed=12):
    """mark_boundary of the region labels of blocks of three colours and
    speckles: rings of many distinct labels side by side, background -1."""
    r = np.random.default_rng(seed + h * w)
    colours = np.kron(r.integers(0, 3, (h // 4 + 1, w // 4 + 1)),
                      np.ones((4, 4), np.int64))[:h, :w]
    colours = np.where(r.random((h, w)) < 0.06, 9, colours)
    packed = torch.from_numpy(colours.astype(np.int32))
    z = torch.zeros((h, w), dtype=torch.int32)
    return regions.mark_boundary(regions.label_merge(packed, z, z))


@pytest.mark.parametrize("h,w", [(1, 97), (97, 1), (37, 53), (70, 33),
                                 (129, 257)])
def test_ccl_kernel_matches_plain_at_odd_sizes(h, w):
    """Edge chains, boundary marks (background -1), staircases through
    the tile corners on both diagonals, values 0-3 side by side, one
    value and background only; three launches per call."""
    _need_card()
    r = np.random.default_rng(h + w)
    frames = [(_walks(h, w), 0), (_region_marks(h, w), -1),
              (_staircase(h, w, False), 0), (_staircase(h, w, True), 0),
              (torch.from_numpy(r.integers(-1, 4, (h, w)).astype(np.int32)),
               -1),
              (torch.full((h, w), 3, dtype=torch.int32), 0),
              (torch.zeros((h, w), dtype=torch.int32), 0)]
    for pix, bgc in frames:
        n0 = _build.launch_count()
        got = hopper_ccl.label_components(pix.cuda(), bgc)
        assert _build.launch_count() == n0 + 3
        assert torch.equal(got.cpu(), hopper_ccl.label_components_plain(
            pix, bgc))
    if h > 16 and w > 32:
        for pix, _ in frames[2:4]:
            lbl = hopper_ccl.label_components(pix.cuda(), 0)
            assert int(torch.unique(lbl[pix.cuda() == 1]).numel()) == 1


def test_ccl_kernel_matches_plain_on_720p_inputs():
    """The three inputs of K4 on the main paths at 720p: the poly path's
    edge_bin, the rect strings and the boundary marks."""
    _need_card()
    from bench import synth_frame
    bgr = torch.from_numpy(synth_frame(720, 1280, seed=0)).cuda()
    fe = edge_frontend(bgr)
    weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin)
    despeck = region_smoothing(fe.packed0, weak, fe.edge_thin)[1]
    seg = hopper_links.label_merge(
        despeck, hopper_merge_mask.junction_merge_mask(strong), strong)
    inputs = [(fe.edge_bin, 0),
              (hopper_morph.strings_chain(fe.edge_bin, "rect"), 0),
              (regions.mark_boundary(seg), -1)]
    for pix, bgc in inputs:
        got = hopper_ccl.label_components(pix, bgc)
        assert torch.equal(got, hopper_ccl.label_components_plain(pix, bgc))
        assert int((got >= 0).sum()) > 1000


def test_wrappers_check_their_inputs():
    _need_card()
    edge = _maps()[0].cuda()
    with pytest.raises(TypeError):
        hopper_morph.strings_chain(edge.float(), "rect")
    with pytest.raises(ValueError):
        hopper_ccl.label_components(edge.t(), 0)          # not contiguous
    with pytest.raises(ValueError):
        hopper_grad.edge_front(torch.zeros((8, 8, 2), device="cuda"))


def _count_kernels(fn):
    """fn() with the launch counts set to 0 first; asserts that the
    library's counter saw exactly the kernels the wrappers stated, and that
    K3 and quant_despeckle stated their wrappers' KERNELS a call."""
    _build.expected_kernels.clear()
    hopper_morph.launches = hopper_quant.launches = 0
    n0 = _build.launch_count()
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_count() - n0 == sum(_build.expected_kernels.values())
    for name, mod in (("rd_strings_chain", hopper_morph),
                      ("rd_quant_despeckle", hopper_quant)):
        assert (_build.expected_kernels.get(name, 0)
                == mod.launches * mod.KERNELS), name
    return out


def test_poly_frame_on_card_matches_cpu_and_counts_launches():
    _need_card()
    bgr = _scene()
    mods = (hopper_grad, hopper_thin, hopper_morph, hopper_ccl, hopper_mkpl)
    for m in mods:
        m.launches = 0
    ga, gl = _count_kernels(lambda: poly_frame(bgr.cuda(), PipelineConfig()))
    assert all(m.launches >= 1 for m in mods)
    # the plain subdivision on the card gives the same bits
    pa, pl = poly_frame(bgr.cuda(), PipelineConfig(mkpl_pallas=0))
    assert hopper_mkpl.launches == 1
    assert torch.equal(gl, pl)
    for f in pa._fields:
        assert torch.equal(getattr(ga, f), getattr(pa, f)), f
    ca, cl = poly_frame(bgr, PipelineConfig())
    assert torch.equal(gl.cpu(), cl)
    for f in ca._fields:
        got, want = getattr(ga, f).cpu(), getattr(ca, f)
        if want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        else:
            assert torch.equal(got, want), f


def _mkpl_case(edge, cap, minerror=1.0, size_thre=4):
    arena, dense, number, comp = polyline.mkpl_inputs(
        edge, size_thre, cap, PipelineConfig())
    got = hopper_mkpl.mkpl_subdivide(arena, dense, number, minerror, 16, comp)
    want = mkpl.mkpl_subdivide(arena, dense, number, minerror, 16, comp)
    return comp, got, want


def _polylines(h=256, w=256, seed=4, count=120):
    """Binary edge map of `count` random zig-zag polylines."""
    r = np.random.default_rng(seed)
    m = np.zeros((h, w), np.int32)
    for _ in range(count):
        y, x = r.integers(2, h - 2), r.integers(2, w - 2)
        dy, dx = r.integers(-1, 2, 2)
        for _ in range(r.integers(15, 60)):
            if r.random() < 0.15:
                dy, dx = r.integers(-1, 2, 2)
            y, x = np.clip(y + dy, 1, h - 2), np.clip(x + dx, 1, w - 2)
            m[y, x] = 1
    return torch.from_numpy(m)


@pytest.mark.parametrize("cap", [4096, 200, 180, 176])
def test_mkpl_kernel_matches_plain(cap):
    """The arc slot list outnumbers the arena at every cap here; at 200
    and 180 the arena overflows during the subdivision (173 arcs, 284
    segments unbounded) and splits drop in id order; at 176 the first
    round already overflows."""
    _need_card()
    comp, (ga, gl), (pa, pl) = _mkpl_case(_polylines().cuda(), cap)
    assert comp.cap > cap > 173
    assert torch.equal(gl, pl)
    for f in pa._fields:
        assert torch.equal(getattr(ga, f), getattr(pa, f)), f
    if cap < 4096:
        assert int(ga.count) == cap - 1


def _scrambled_numbers(dense, number, comp):
    """Every third arc's numbers no longer 1..size without repeats: a
    repeat, a gap, or both (the kernel ranks such an arc by sorting)."""
    num = number.clone().reshape(-1)
    flat = dense.reshape(-1)
    live = comp.idx[comp.valid()].long()
    for k, arc in enumerate(torch.unique(flat[live]).tolist()):
        px = live[flat[live] == arc]
        if k % 3 or px.numel() < 4:
            continue
        order = px[torch.argsort(num[px])]
        if k % 9 == 0:
            num[order[2]] = num[order[1]]
        elif k % 9 == 3:
            num[order[2:]] += 2
        else:
            num[order[1]] = num[order[2]]
            num[order[-1]] += 5
    return num.reshape(number.shape)


@pytest.mark.parametrize("h,w,count", [(256, 256, 120), (512, 512, 500)])
def test_mkpl_kernel_rounds_numbers_and_launch_count(h, w, count):
    """0, 1, 2 and 15 rounds; arcs whose numbers repeat or skip; more live
    slots than the launch has threads (512 x 512); one launch per call by
    the library's own counter."""
    _need_card()
    arena, dense, number, comp = polyline.mkpl_inputs(
        _polylines(h, w, 4, count).cuda(), 4, 16384, PipelineConfig())
    number2 = _scrambled_numbers(dense, number, comp)
    arena2 = polyline.mkpl_init(dense, number2, 16384, comp)
    for a0, num in ((arena, number), (arena2, number2)):
        for iters in (1, 2, 3, 16):
            n0 = _build.launch_count()
            got = hopper_mkpl.mkpl_subdivide(a0, dense, num, 1.0, iters, comp)
            assert _build.launch_count() == n0 + 1
            want = mkpl.mkpl_subdivide(a0, dense, num, 1.0, iters, comp)
            assert torch.equal(got[1], want[1]), iters
            for f in want[0]._fields:
                assert torch.equal(getattr(got[0], f),
                                   getattr(want[0], f)), (iters, f)


def _check_scan(key, val, caps):
    key = torch.from_numpy(key.astype(np.int32)).cuda()
    val = torch.from_numpy(val.astype(np.int32)).cuda()
    for cap in caps:
        for op in ("satsum", "max"):
            assert torch.equal(
                hopper_scan.seg_scan_sorted(key, val, op, cap),
                hopper_scan.seg_scan_plain(key, val, op, cap)), (op, cap)
        assert torch.equal(hopper_scan.seg_total_sorted(key, val, cap),
                           hopper_scan.seg_total_plain(key, val, cap)), cap


def test_seg_scan_kernel_matches_plain():
    _need_card()
    r = np.random.default_rng(5)
    for s in (1, 1000, 1024, 5000, 70000):
        # long runs crossing the 1024-element tiles, short runs, one run
        # over several tiles
        lengths = np.concatenate([r.integers(1, 5, 200),
                                  r.integers(900, 3000, 30), [70000]])
        key = np.repeat(np.arange(lengths.size), lengths)[:s]
        _check_scan(key, r.integers(0, 400, s), (300, 2500, 2 ** 30))
    # more than 256 tiles, so the carry pass runs a second chunk of tiles:
    # non-zero values, a run over several tiles across the chunk boundary
    # (256 tiles of 1024 elements), then a run starting exactly on it; the
    # sums stay below 2**30, so the large cap never saturates
    s, chunk = 300000, 256 * 1024
    for cuts in (np.r_[r.integers(1, chunk - 5000, 150),
                       r.integers(chunk + 9000, s, 40)],
                 np.r_[r.integers(1, s, 300), chunk]):
        starts = np.zeros(s, np.int64)
        starts[cuts] = 1
        _check_scan(np.cumsum(starts), r.integers(1, 400, s),
                    (2500, 2 ** 30))


def test_blblur_and_quant_despeckle_kernels_match_plain():
    _need_card()
    r = np.random.default_rng(9)
    for h, w in ((37, 53), (96, 128)):
        packed = ((r.integers(0, 1024, (h, w)) << 22)
                  | (r.integers(0, 1024, (h, w)) << 12)
                  | r.integers(0, 4096, (h, w))).astype(np.int32)
        packed = torch.from_numpy(packed).cuda()
        edge = torch.from_numpy(
            (r.random((h, w)) < 0.2).astype(np.int32)).cuda()
        for iters in (0, 1, 10):
            assert torch.equal(hopper_blblur.blblur(packed, edge, iters),
                               regions.blblur(packed, edge, iters)), iters
        emag = np.where(r.random((h, w)) < 0.4, r.random((h, w)), 0)
        emag = torch.from_numpy(emag.astype(np.float32)).cuda()
        for n in (24, 7):
            assert torch.equal(
                hopper_quant.quantize_despeckle(packed, emag, n, n, n),
                regions.quantize_despeckle(packed, emag, n, n, n)), n
    with pytest.raises(NotImplementedError):
        hopper_blblur.blblur(packed, edge, 10, x0=8)


@pytest.mark.parametrize("h,w", [(1, 64), (64, 1), (37, 53), (720, 1280)])
def test_blblur_kernel_matches_plain_at_every_fuse(h, w):
    """Edge maps all edge, no edge and random; iters 0-3 and 10 (ragged
    last launches), every fused round count the kernel compiles; tiles
    that do not divide the frame."""
    _need_card()
    r = np.random.default_rng(h * 31 + w)
    packed = ((r.integers(0, 1024, (h, w)) << 22)
              | (r.integers(0, 1024, (h, w)) << 12)
              | r.integers(0, 4096, (h, w))).astype(np.int32)
    packed = torch.from_numpy(packed).cuda()
    edges = {"all": torch.ones((h, w), dtype=torch.int32),
             "none": torch.zeros((h, w), dtype=torch.int32),
             "random": torch.from_numpy(
                 (r.random((h, w)) < 0.2).astype(np.int32))}
    for name, edge in edges.items():
        edge = edge.cuda()
        for iters in (0, 1, 2, 3, 10):
            want = regions.blblur(packed, edge, iters)
            n0 = hopper_blblur.launches
            assert torch.equal(hopper_blblur.blblur(packed, edge, iters),
                               want), (name, iters)
            assert hopper_blblur.launches == n0 + 1
            for fuse in sorted(hopper_blblur.TILES):
                got = hopper_blblur.blblur_fused(packed, edge, iters, fuse)
                assert torch.equal(got, want), (name, iters, fuse)


def test_region_maps_on_card_match_cpu_and_count_launches():
    _need_card()
    bgr = _scene()
    mods = (hopper_scan, hopper_blblur, hopper_quant)
    for m in mods:
        m.launches = 0
    outs = []
    for dev in ("cuda", "cpu"):
        fe = edge_frontend(bgr.to(dev))
        weak, strong = weak_strong_labels(fe.edge_bin, fe.edge_thin)
        blurred, despeck = region_smoothing(fe.packed0, weak, fe.edge_thin)
        outs.append([t.cpu() for t in (weak, strong, blurred, despeck)])
    assert all(m.launches >= 1 for m in mods)
    assert int((outs[1][0] > 0).sum()) > 50
    for name, g, c in zip(("weak", "strong", "blurred", "despeck"), *outs):
        assert torch.equal(g, c), name


def test_region_merge_and_bids_kernels_match_plain():
    """merge_mask (labels > 0, = 0 and < 0), label_merge, despeckle2 and
    distinct_bids on frames whose sides are not multiples of the 32x32
    tiles, one region spanning most of the frame."""
    _need_card()
    r = np.random.default_rng(12)
    for h, w in ((37, 53), (96, 128), (70, 33)):
        strong = (r.random((h, w)) < 0.08) * r.integers(1, 900, (h, w))
        strong[h // 3, 3:w - 3] = 5
        strong[3:h - 3, w // 3] = 6
        strong = np.where(r.random((h, w)) < 0.05, -1, strong)
        strong = torch.from_numpy(strong.astype(np.int32)).cuda()
        colours = np.kron(r.integers(0, 3, (h // 4 + 1, w // 4 + 1)),
                          np.ones((4, 4), np.int64))[:h, :w]
        colours[: h // 2, : w // 2] = 7
        colours = np.where(r.random((h, w)) < 0.06, 9, colours)
        packed = torch.from_numpy(colours.astype(np.int32)).cuda()
        mask = hopper_merge_mask.junction_merge_mask(strong)
        assert torch.equal(mask, regions.junction_merge_mask(strong))
        assert int(mask.sum()) > 0
        seg0 = hopper_links.label_merge(packed, mask, strong)
        assert torch.equal(seg0, regions.label_merge(packed, mask, strong))
        for thre in (16, 3):
            seg = hopper_despeckle2.sizes_despeckle2(seg0, thre)
            assert torch.equal(seg, regions.sizes_despeckle2(seg0, thre))
        boundary = boundary_labels(seg)[0]
        assert int((boundary >= 0).sum()) > 0
        for a, b in zip(hopper_bids.distinct_bids(boundary),
                        hopper_bids.distinct_bids_plain(boundary)):
            assert torch.equal(a, b)
    with pytest.raises(TypeError):
        hopper_links.label_merge(packed, mask.float(), strong)


def _serpentine(h, w):
    """Colour 1 on a path along every other row, turning at alternate
    ends, so one region crosses every tile seam; colour 0 elsewhere."""
    c = np.zeros((h, w), np.int32)
    c[::2] = 1
    c[1::4, -1] = 1
    c[3::4, 0] = 1
    return torch.from_numpy(c)


@pytest.mark.parametrize("h,w", [(1, 64), (64, 1), (37, 53), (70, 33),
                                 (720, 1280)])
def test_links_kernel_matches_plain(h, w):
    """Random colours, mask and edges; the serpentine; one colour; three
    launches per call by the library's own counter."""
    _need_card()
    r = np.random.default_rng(h * 7 + w)
    z = torch.zeros((h, w), dtype=torch.int32)
    frames = [
        (torch.from_numpy(r.integers(0, 3, (h, w)).astype(np.int32)),
         torch.from_numpy((r.random((h, w)) < 0.2).astype(np.int32)),
         torch.from_numpy((r.random((h, w)) < 0.3).astype(np.int32))),
        (_serpentine(h, w), z, z),
        (torch.full((h, w), 5, dtype=torch.int32), z, z)]
    for packed, mask, edge in frames:
        packed, mask, edge = packed.cuda(), mask.cuda(), edge.cuda()
        n0 = _build.launch_count()
        got = hopper_links.label_merge(packed, mask, edge)
        assert _build.launch_count() == n0 + 3
        assert torch.equal(got, regions.label_merge(packed, mask, edge))
    assert int(got.max()) == 0
    serp = hopper_links.label_merge(_serpentine(h, w).cuda(), z.cuda(),
                                    z.cuda())
    assert int((serp == 0).sum()) == int(_serpentine(h, w).sum())


def test_rect_hypotheses_on_card_matches_cpu_and_counts_launches():
    _need_card()
    bgr = _scene()
    mods = (hopper_merge_mask, hopper_links, hopper_despeckle2, hopper_bids,
            hopper_ccl, hopper_mkpl)
    for m in mods:
        m.launches = 0
    got = _count_kernels(lambda: rect_hypotheses(bgr.cuda()))
    assert all(m.launches >= 1 for m in mods + (hopper_morph, hopper_quant))
    # the rect strings and the strong edges' polylines: one K3 call each
    assert hopper_morph.launches == 2
    want = rect_hypotheses(bgr)
    for f in ("mask", "seg", "boundary", "lsid", "valid", "status"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.segs.cpu(), want.segs, rtol=0, atol=ATOL)
    assert int(want.valid.any(1).sum()) >= 1


@pytest.mark.parametrize("seed,scale,k", [(0, 1.0, 48), (2, 0.03, 48),
                                          (3, 1.0, 13)])
def test_hyp_kernel_matches_plain(seed, scale, k):
    """384 groups of the randomized corpus (quads, axis-aligned quads, a
    duplicate-heavy and a zero-length group), also at an odd K."""
    _need_card()
    segs, valid = parity.segment_groups(seed, 384, k, scale)
    segs = torch.from_numpy(segs).cuda()
    valid = torch.from_numpy(valid).cuda()
    got_c, got_ok = hopper_hyp.reduce_groups(segs, valid, 24)
    want_c, want_ok = quad.reduce_groups(segs, valid, 24)
    assert torch.equal(got_ok, want_ok)
    assert int(want_ok.sum()) >= 10
    torch.testing.assert_close(got_c[want_ok], want_c[want_ok], rtol=0,
                               atol=1e-3)
    torch.testing.assert_close(got_c, want_c, rtol=0, atol=0, equal_nan=True)


def test_hyp_kernel_empty_groups():
    _need_card()
    segs = torch.zeros((5, 48, 2, 2), device="cuda")
    valid = torch.zeros((5, 48), dtype=torch.bool, device="cuda")
    corners, ok = hopper_hyp.reduce_groups(segs, valid, 24)
    assert corners.shape == (5, 4, 2) and not ok.any()


def test_hyp_kernel_at_its_limits():
    """K = 64 segments and 64 hull vertices, the kernel's limits: ok equal,
    corners bit-equal with NaN in the same places."""
    _need_card()
    segs, valid = parity.segment_groups(5, 384, 64, 1.0)
    segs = torch.from_numpy(segs).cuda()
    valid = torch.from_numpy(valid).cuda()
    got_c, got_ok = hopper_hyp.reduce_groups(segs, valid, 64)
    want_c, want_ok = quad.reduce_groups(segs, valid, 64)
    assert torch.equal(got_ok, want_ok)
    assert int(want_ok.sum()) >= 10
    torch.testing.assert_close(got_c, want_c, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        hopper_hyp.reduce_groups(segs, valid, 65)


def test_pose_kernel_matches_plain():
    _need_card()
    q = torch.from_numpy(parity.pose_quads(1, 56, 8, 640, 480,
                                           TAN_AOV)).cuda()
    got = hopper_pose.pose_estimate(q, 640, 480, TAN_AOV)
    want = pose.pose_estimate(q, 640, 480, TAN_AOV)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=POSE_RTOL, atol=1e-6,
                                   equal_nan=True)
    assert int(pose.looks_like_a_screen(*want).sum()) >= 40


@pytest.mark.parametrize("g", [1, 5, 33, 384])
def test_pose_kernel_bit_equal_to_plain(g):
    """g quads spread over 336 projected rectangles and 48 degenerate ones
    (all zero, three corners on a line, two equal, a bow tie): 1 to 192
    warps of two groups each, the last one half idle where g is odd."""
    _need_card()
    q = parity.pose_quads(2, 336, 48, 1280, 720, TAN_AOV)
    idx = np.unique(np.linspace(0, len(q) - 1, g).astype(int))
    if g > 1:
        idx[1] = 340                      # a degenerate quad
    q = torch.from_numpy(q[np.sort(idx)]).cuda()
    want = pose.pose_estimate(q, 1280, 720, TAN_AOV)
    got = hopper_pose.pose_estimate(q, 1280, 720, TAN_AOV)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    if g > 1:
        assert torch.isnan(want[2]).any()


def test_region_smoothing_and_rect_geometry_count_one_call_each():
    _need_card()
    bgr = _scene().cuda()
    fe = edge_frontend(bgr)
    weak, _ = weak_strong_labels(fe.edge_bin, fe.edge_thin)
    hopper_blblur.launches = hopper_quant.launches = 0
    region_smoothing(fe.packed0, weak, fe.edge_thin)
    assert (hopper_blblur.launches, hopper_quant.launches) == (1, 1)
    hyp = rect_hypotheses(bgr)
    hopper_hyp.launches = hopper_pose.launches = 0
    rect_geometry(hyp.segs, hyp.valid, hyp.status, bgr.shape[1],
                  bgr.shape[0], TAN_AOV)
    assert (hopper_hyp.launches, hopper_pose.launches) == (1, 1)


def test_rect_frame_on_card_launches_hyp_and_pose_once():
    _need_card()
    bgr = _scene()
    hopper_hyp.launches = hopper_pose.launches = 0
    got = rect_frame(bgr.cuda(), TAN_AOV)
    torch.cuda.synchronize()
    assert (hopper_hyp.launches, hopper_pose.launches) == (1, 1)
    want = rect_frame(bgr, TAN_AOV)
    for f in ("valid", "status"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    torch.testing.assert_close(got.c2.cpu(), want.c2, rtol=0, atol=ATOL)
    assert int(want.valid.sum()) >= 1


def test_hyp_pallas_0_runs_the_plain_versions_on_card():
    _need_card()
    bgr = _scene().cuda()
    hopper_hyp.launches = hopper_pose.launches = 0
    plain = rect_frame(bgr, TAN_AOV, PipelineConfig(hyp_pallas=0))
    torch.cuda.synchronize()
    assert (hopper_hyp.launches, hopper_pose.launches) == (0, 0)
    kern = rect_frame(bgr, TAN_AOV)
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)


def test_failed_launch_raises_without_fallback():
    """A CUDA tensor the kernel cannot take raises in the wrapper, and a
    launch the kernel refuses raises from its error code; neither falls
    back to a plain version."""
    _need_card()
    segs = torch.zeros((3, 65, 2, 2), device="cuda")
    valid = torch.ones((3, 65), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        hopper_hyp.reduce_groups(segs, valid, 24)
    with pytest.raises(TypeError):
        hopper_pose.pose_estimate(torch.zeros((3, 4, 2), device="cuda",
                                              dtype=torch.float64),
                                  640, 480, TAN_AOV)
    corners = torch.empty((3, 4, 2), device="cuda")
    ok = torch.empty((3,), dtype=torch.bool, device="cuda")
    with pytest.raises(RuntimeError):
        _build.launch("rd_hyp", segs.device, segs.data_ptr(),
                      valid.data_ptr(), corners.data_ptr(), ok.data_ptr(),
                      3, 65, 24, 0.0025)
