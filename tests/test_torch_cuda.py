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
are integer-valued and equal (merge_mask from 1x1 to 720x1280, frames all
edge and with no edge; distinct_bids from 1x1 to 720x1280 on frames of
no id, one id, sparse and dense ids; seg_total_sorted from 1 to 2 764 800
rows, more tiles than co-resident blocks; seg_scan_sorted in both
directions, its scratch sized by the library's rd_seg_scan_scratch_words);
edge_front from 3x3 to 720x1280 within ATOL; where build/parent/ holds a
git archive of the parent commit, distinct_bids and edge_front are also
held bit-equal to its kernels; rect_hypotheses' maps, valid and status
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
720x1280; K3's bridge2 variant bit-equal to the plain chain from 1x1 to
720x1280 and on staircases; EXTENDED_CONFIG rect_frame and poly_frame
on the card as on the CPU (rect_frame's corners within 2e-4 px, no
seg_scan launched); the exact colour path, the front end at color_exact
and blur radius 5, the blur at radii 0-40, rescue_filtered over a slot
list, color_reassign and rand_field equal on the card and the CPU (the
recursive blur within 1e-5); the width-tiled path's offset forms (K3
both variants with and without bridge2, merge_mask, blblur at every fused
round count, the links CCL; K2 at a frame column within ATOL, edge_thin
> 0 equal) bit-equal to their plain versions at left, odd interior and
right offsets, and rect_step_tiled over two tiles on one card bit-equal
to rect_frame; the batch forms of K1 and K2 (one launch for four frames)
bit-equal to single calls from 16x64 to 720x1280, rect_frames and
poly_frames at B = 4 bit-equal to per-frame calls with K1 and K2 launched
once, rect_frames_sharded over two entries of the card and the
StreamSupervisor's worker loop (a failing entry quarantined) equal to
rect_frame; the batch forms of the rect tail's dense kernels (K3 in
every variant, blblur at every fused round count and iters = 0,
quant_despeckle, merge_mask, the links CCL, despeckle2) at b = 3 on
37x53 and 144x200 frames bit-equal to three b = 1 calls and to their
plain versions, b = 0 and 65536 and an offset with b > 1 refused, and
rect_frames at B = 3 launching 20 + 12 B kernels, every frame bit-equal
to rect_frame; the slot-range form of mkpl over 1-4 parts of one card
bit-equal to one rd_mkpl launch and to the plain form by slot range (an
overflowing arena too), and rect_step_tiled and poly_step_tiled over 4
tiles bit-equal to rect_frame and poly_frame with the plain subdivision
barred from the card; launches are read from the kernel library's own
counter (`_build.launch_count`).
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


@pytest.mark.parametrize("h,w", [(1, 1), (5, 5), (9, 20), (37, 53),
                                 (41, 33), (70, 33), (33, 1281), (720, 1280)])
def test_merge_mask_kernel_matches_plain_at_odd_sizes(h, w):
    """merge_mask equal to regions.junction_merge_mask on labels > 0, 0
    and -1 at three densities, on a frame where every pixel is an edge and
    on frames with no edge (all 0, all -1); one kernel a call."""
    _need_card()
    r = np.random.default_rng(h * 7 + w)
    maps = [np.full((h, w), 5), np.zeros((h, w)), np.full((h, w), -1)]
    for density in (0.1, 0.3, 0.6):
        lab = np.where(r.random((h, w)) < density,
                       r.integers(1, 900, (h, w)), 0)
        maps.append(np.where(r.random((h, w)) < 0.1, -1, lab))
    for i, m in enumerate(maps):
        strong = torch.from_numpy(m.astype(np.int32))
        n0 = _build.launch_count()
        got = hopper_merge_mask.junction_merge_mask(strong.cuda())
        torch.cuda.synchronize()
        assert _build.launch_count() == n0 + 1
        assert torch.equal(got.cpu(), regions.junction_merge_mask(strong)), i


def _parent_lib():
    """The parent commit's kernel library, built from build/parent/ (a git
    archive of the parent, as for chip_smoke.py), or None without it."""
    import os

    import chip_smoke
    src = os.path.join(chip_smoke.ROOT, "build", "parent",
                       "rectdetect_tpu_torch", "csrc")
    if not os.path.isdir(src):
        return None
    out = os.path.join(chip_smoke.ROOT, "build", "parent", "card_tests")
    os.makedirs(out, exist_ok=True)
    return chip_smoke.build_kernels(_build, src, out,
                                    ("distinct_bids", "edge_front"))


@pytest.fixture(scope="module")
def parent_lib():
    return _parent_lib() if torch.cuda.is_available() else None


# edge_front's tiles are 16 x 64 pixels, staged by float4 where a row
# starts on 16 bytes (widths that are multiples of 4) away from the
# frame's sides: frames of 3x3 (the least it takes), inside one tile, on
# whole tiles and one past, ragged, with tiles of both kinds, and 720p
EF_CARD_SHAPES = [(3, 3), (5, 7), (16, 64), (17, 65), (37, 53), (70, 33),
                  (37, 200), (16, 136), (64, 1281), (720, 1280)]


def _blurred_lab(h, w, seed):
    """(H,W,3) float32 Lab-like planes: ramps, noise, a flat block (the
    zero-gradient branch) and values on the lattice's level edges."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.stack([0.3 + 0.4 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0)
                    for c in range(3)], -1) + r.normal(0, 0.02, (h, w, 3))
    lab[h // 3:h // 3 + 6, w // 4:w // 4 + 9] = 0.5
    edge = r.random((h, w)) < 0.1
    lab[edge, 0] = r.integers(0, 4096, int(edge.sum())) / 4096.0
    return torch.from_numpy(lab.astype(np.float32))


@pytest.mark.parametrize("h,w", EF_CARD_SHAPES)
def test_edge_front_kernel_matches_plain_and_parent(h, w, parent_lib):
    """edge_front within ATOL of edge_front_plain, one kernel a call, and
    bit-equal to the parent commit's kernel where build/parent/ holds
    it."""
    _need_card()
    labb = _blurred_lab(h, w, seed=h * 13 + w).cuda()
    n0 = _build.launch_count()
    em, vec = hopper_grad.edge_front(labb)
    torch.cuda.synchronize()
    assert _build.launch_count() == n0 + 1
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    torch.testing.assert_close(em, em_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(vec, vec_p, rtol=0, atol=ATOL)
    if parent_lib is not None:
        import chip_smoke
        em_q, vec_q = chip_smoke.bind_edge_front(torch, parent_lib)(labb)
        assert torch.equal(em, em_q)
        assert torch.equal(vec, vec_q)


# distinct_bids' tiles are 8 x 32 pixels, its stores int4 where the width
# is a multiple of 4
DB_CARD_SHAPES = [(1, 1), (7, 7), (8, 32), (9, 33), (37, 53), (70, 33),
                  (37, 200), (33, 1281), (720, 1280)]


@pytest.mark.parametrize("h,w", DB_CARD_SHAPES)
def test_distinct_bids_kernel_matches_plain_at_odd_sizes(h, w, parent_lib):
    """distinct_bids equal to distinct_bids_plain on sparse ids, dense ids
    with many repeats, dense ids all distinct, no id (all -1) and one id
    throughout; one kernel a call; bit-equal to the parent commit's
    kernel where build/parent/ holds it."""
    _need_card()
    r = np.random.default_rng(h * 5 + w)
    maps = [np.full((h, w), -1), np.full((h, w), 7)]
    for density, ids in ((0.02, 50), (0.6, 5), (0.8, 10 ** 6)):
        maps.append(np.where(r.random((h, w)) < density,
                             r.integers(1, ids + 1, (h, w)), -1))
    for i, m in enumerate(maps):
        boundary = torch.from_numpy(m.astype(np.int32))
        n0 = _build.launch_count()
        got = hopper_bids.distinct_bids(boundary.cuda())
        torch.cuda.synchronize()
        assert _build.launch_count() == n0 + 1
        for a, b in zip(got, hopper_bids.distinct_bids_plain(boundary)):
            assert torch.equal(a.cpu(), b), i
        if parent_lib is not None:
            import chip_smoke
            want = chip_smoke.bind_distinct_bids(torch, parent_lib)(
                boundary.cuda())
            assert torch.equal(torch.stack(got), want), i


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


# seg_total sizes: one element, a tile less one, one tile, a tile and one,
# the 720p strength table, and the 4K one (more tiles than co-resident
# blocks, so each block walks several tiles)
SEG_TOTAL_SIZES = [1, 1023, 1024, 1025, 307200, 2764800]


def _seg_total_tables(s, seed):
    """(key, val, caps) tables of s rows: short runs, a few runs over many
    tiles and a run to the end, values 0-399 (above the smaller caps, so
    runs saturate and some first values exceed the cap); one key
    throughout; all keys distinct; values near 2^31 whose sums pass 2^31
    (cap at the int32 maximum); the strength table's shape, labelled rows
    and a tail of one key with value 0."""
    r = np.random.default_rng(seed)
    big = (1 << 31) - 1
    lengths = np.concatenate([r.integers(1, 40, s // 20 + 1),
                              r.integers(900, 5000, 4), [s]])
    runs = np.repeat(np.arange(lengths.size), lengths)[:s]
    live = s * 2 // 3
    tail = np.concatenate([np.sort(r.integers(1, max(2, s // 8), live)),
                           np.full(s - live, s)])
    return [(runs, r.integers(0, 400, s), (300, 2500, big)),
            (np.zeros(s), r.integers(0, 400, s), (300, big)),
            (np.arange(s), r.integers(0, 400, s), (300,)),
            (runs, r.integers(1 << 29, big, s), (big,)),
            (tail, np.where(np.arange(s) < live, r.integers(0, 60, s), 0),
             (100, 2500))]


@pytest.mark.parametrize("s", SEG_TOTAL_SIZES)
def test_seg_total_kernel_matches_plain(s):
    """seg_total_sorted equal to seg_total_plain on the card, one kernel a
    call."""
    _need_card()
    for i, (key, val, caps) in enumerate(_seg_total_tables(s, seed=s)):
        key = torch.from_numpy(key.astype(np.int32)).cuda()
        val = torch.from_numpy(val.astype(np.int32)).cuda()
        for cap in caps:
            n0 = _build.launch_count()
            got = hopper_scan.seg_total_sorted(key, val, cap)
            torch.cuda.synchronize()
            assert (_build.launch_count() - n0
                    == hopper_scan.TOTAL_KERNELS == 1)
            assert torch.equal(got, hopper_scan.seg_total_plain(key, val,
                                                                cap)), (i, cap)


@pytest.mark.parametrize("s", [1, 1023, 1025, 70000, 307200])
def test_seg_scan_kernel_both_ops_and_directions(s):
    """The three-launch scan of seg_scan_sorted, satsum and max, equal to
    seg_scan_plain forward and from the end (a scan from the end is one of
    the flipped table, as ops/pallas_scan.py runs it)."""
    _need_card()
    for key, val, caps in _seg_total_tables(s, seed=s + 1)[:2]:
        key = torch.from_numpy(key.astype(np.int32)).cuda()
        val = torch.from_numpy(val.astype(np.int32)).cuda()
        for cap in caps:
            for op in ("satsum", "max"):
                for k, v in ((key, val), (torch.flip(key, (0,)),
                                          torch.flip(val, (0,)))):
                    assert torch.equal(
                        hopper_scan.seg_scan_sorted(k, v, op, cap),
                        hopper_scan.seg_scan_plain(k, v, op, cap)), (op, cap)


def test_seg_scan_scratch_words_follow_the_tile():
    """rd_seg_scan_scratch_words(n) is 4 words a 1024-element tile of
    csrc/scan.cu (kTile), and seg_scan_sorted is right at those sizes."""
    _need_card()
    for n in (0, 1, 1024, 1025, 307200):
        assert _build.lib().rd_seg_scan_scratch_words(n) == 4 * (-(-n // 1024))
        if n:
            key = torch.arange(n, device="cuda", dtype=torch.int32) // 700
            val = torch.ones(n, device="cuda", dtype=torch.int32)
            assert torch.equal(hopper_scan.seg_scan_sorted(key, val),
                               hopper_scan.seg_scan_plain(key, val)), n


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
    # the offset form (a width tile of a wider frame) launches as well
    n0 = hopper_blblur.launches
    assert torch.equal(hopper_blblur.blblur(packed, edge, 10, x0=8,
                                            w_total=w + 16),
                       regions.blblur(packed, edge, 10, 8, w + 16))
    assert hopper_blblur.launches == n0 + 1


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


def _same_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


@pytest.mark.parametrize("which", ["rect", "poly"])
def test_video_detectors_on_card_equal_direct_calls(which):
    """Three frames through the pipelined detector on the card: each poll
    equals the direct call on the same frame, bit for bit, and the
    library counts the path's kernels per frame."""
    _need_card()
    from rectdetect_tpu_torch.pipeline.poly import live_segments
    from rectdetect_tpu_torch.pipeline.rect import live_rects
    from rectdetect_tpu_torch.pipeline.video import (VideoPolyDetector,
                                                     VideoRectDetector)
    frames = [_scene(seed=s).numpy() for s in range(3)]
    if which == "rect":
        det = VideoRectDetector(TAN_AOV, device="cuda")
        per_frame = 32

        def direct(f):
            return live_rects(rect_frame(f, TAN_AOV))
    else:
        det = VideoPolyDetector(device="cuda")
        per_frame = 7

        def direct(f):
            return live_segments(poly_frame(f, PipelineConfig(), 1.0, 10,
                                            2000)[0])
    want = [direct(torch.from_numpy(f).cuda()) for f in frames]
    torch.cuda.synchronize()
    n0 = _build.launch_count()
    for f in frames:
        det.enqueue(f)
    got = [det.poll() for _ in frames]
    torch.cuda.synchronize()
    assert _build.launch_count() - n0 == per_frame * len(frames)
    assert det.poll() is None
    for a, b in zip(got, want):
        _same_lists(a, b)


def test_stage_images_and_calibration_on_card_equal_cpu(tmp_path):
    """rect_stage_images and calibrate on the card against the same calls
    on the CPU: integer maps, densities and capacities equal, edge_thin
    within ATOL; the plan key names the card."""
    _need_card()
    from rectdetect_tpu_torch.pipeline.rect import rect_stage_images
    from rectdetect_tpu_torch.runtime import calibrate as cal
    from rectdetect_tpu_torch.runtime import native
    bgr = _scene()
    got = rect_stage_images(bgr.cuda())
    want = rect_stage_images(bgr)
    for k, v in want.items():
        if k == "edge_thin":
            torch.testing.assert_close(got[k].cpu(), v, rtol=0, atol=ATOL)
            assert torch.equal(got[k].cpu() > 0, v > 0)
        else:
            assert torch.equal(got[k].cpu(), v), k
    assert cal._densities([bgr.cuda()]) == cal._densities([bgr])
    plan = str(tmp_path / "plan_torch.txt")
    c_card = cal.calibrate([bgr.cuda()], plan_path=plan)
    c_cpu = cal.calibrate([bgr], plan_path=plan)
    assert c_card == c_cpu
    key = cal._key(torch.cuda.get_device_name(0), 96, 128)
    assert native.plan_load(plan, key) == native.plan_load(plan, "cpu|96x128")
    assert cal.load_calibrated_config(96, 128, "cuda:0",
                                      plan_path=plan) == c_card
    assert cal.plan_fits(c_card, bgr.cuda()) == cal.plan_fits(c_cpu, bgr)


# ---- the off-default capabilities (EXTENDED_CONFIG and the rest) --------

@pytest.mark.parametrize("h,w", K3_CARD_SHAPES)
def test_morph_bridge2_kernel_matches_plain_at_odd_sizes(h, w):
    """K3 with bridge2, both variants, bit-equal to the plain chain at
    densities 0.1, 0.3 and 0.6; one kernel per call."""
    _need_card()
    r = np.random.default_rng(h * 7907 + w)
    for density in (0.1, 0.3, 0.6):
        vals = r.choice(np.array([-1, 1, 2], np.int32), size=(h, w))
        e = np.where(r.random((h, w)) < density, vals, 0).astype(np.int32)
        edge = torch.from_numpy(e)
        for variant in ("rect", "poly_branch"):
            n0 = _build.launch_count()
            got = hopper_morph.strings_chain(edge.cuda(), variant, True)
            torch.cuda.synchronize()
            assert _build.launch_count() == n0 + hopper_morph.KERNELS
            want = hopper_morph.strings_chain_plain(edge, variant, True)
            assert torch.equal(got.cpu(), want), (density, variant)


def _staircases(h, w):
    """Shallow 1-px edges with a straight 2-px hole at every step,
    horizontal, vertical and diagonal, across word and tile edges and at
    the frame border."""
    e = np.zeros((h, w), np.int32)
    for x in range(1, w - 1):
        if x % 12 not in (10, 11):
            e[7 + (x // 36) % 2, x] = 1
            e[h - 2 - (x // 48) % 2, x] = 1
    for y in range(h):
        if y % 9 not in (7, 8):
            e[y, 31 + (y // 27) % 2] = 1
            e[y, w - 2] = 1
    for i in range(min(h, w) - 12):
        if i % 10 not in (6, 7):
            e[10 + i, 40 + i] = 1
            e[10 + i, w - 3 - i] = 1
    return torch.from_numpy(e)


@pytest.mark.parametrize("h,w", [(41, 99), (33, 1281), (720, 1280)])
def test_morph_bridge2_kernel_on_staircases(h, w):
    """bridge2 closes the staircases' holes on the card exactly as the
    plain chain does, and adds string pixels."""
    _need_card()
    edge = _staircases(h, w)
    for variant in ("rect", "poly_branch"):
        got = hopper_morph.strings_chain(edge.cuda(), variant, True).cpu()
        assert torch.equal(got, hopper_morph.strings_chain_plain(
            edge, variant, True)), variant
        assert int(got.sum()) > int(hopper_morph.strings_chain_plain(
            edge, variant).sum())


def test_extended_frames_on_card_match_cpu():
    """EXTENDED_CONFIG rect_frame and poly_frame on the card equal the
    CPU's; rect_frame runs no seg_scan (the staged strength filters have
    no kernel) and K3 twice, both with bridge2."""
    from rectdetect_tpu_torch.config import EXTENDED_CONFIG
    _need_card()
    bgr = _scene()
    hopper_scan.launches = 0
    hopper_morph.launches = 0
    got = _count_kernels(lambda: rect_frame(bgr.cuda(), TAN_AOV,
                                            EXTENDED_CONFIG))
    assert hopper_scan.launches == 0 and hopper_morph.launches == 2
    want = rect_frame(bgr, TAN_AOV, EXTENDED_CONFIG)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.status.cpu(), want.status)
    torch.testing.assert_close(got.c2.cpu(), want.c2, rtol=0, atol=ATOL)
    ga, gl = _count_kernels(lambda: poly_frame(bgr.cuda(), EXTENDED_CONFIG))
    ca, cl = poly_frame(bgr, EXTENDED_CONFIG)
    assert torch.equal(gl.cpu(), cl)
    for f in ca._fields:
        g, c = getattr(ga, f).cpu(), getattr(ca, f)
        if c.is_floating_point():
            torch.testing.assert_close(g, c, rtol=0, atol=ATOL)
        else:
            assert torch.equal(g, c), f


def test_off_default_plain_ops_on_card_match_cpu():
    """The exact colour path, the front end at color_exact and blur radius
    5, the FIR blur at radii 1 to 40 and the recursive blur, rescue over a
    slot list past its capacity, color_reassign and rand_field: plain
    PyTorch on either device, equal on the card and the CPU (the
    recursive blur within 1e-5: its float32 sums follow the device's
    kernels)."""
    from rectdetect_tpu_torch.core import color
    from rectdetect_tpu_torch.ops import blur, ccl, rand
    from rectdetect_tpu_torch.ops.compact import compact_mask
    _need_card()
    bgr = _scene()
    assert torch.equal(color.bgr_to_packed_exact(bgr.cuda()).cpu(),
                       color.bgr_to_packed_exact(bgr))
    cfg = PipelineConfig(color_exact=True, blur_radius=5)
    fc, fh = edge_frontend(bgr.cuda(), cfg), edge_frontend(bgr, cfg)
    assert torch.equal(fc.packed0.cpu(), fh.packed0)
    assert torch.equal(fc.labb.cpu(), fh.labb)
    torch.testing.assert_close(fc.edge_thin.cpu(), fh.edge_thin, rtol=0,
                               atol=ATOL)
    assert torch.equal(fc.edge_bin.cpu(), fh.edge_bin)
    img = torch.from_numpy(np.random.default_rng(3).random(
        (37, 53)).astype(np.float32))
    for r in (0, 1, 3, 7, 31, 40):
        assert torch.equal(blur.gaussian_blur(img.cuda(), r).cpu(),
                           blur.gaussian_blur(img, r)), r
    torch.testing.assert_close(blur.gaussian_blur_iir(img.cuda(), 5.0).cpu(),
                               blur.gaussian_blur_iir(img, 5.0), rtol=0,
                               atol=1e-5)
    lbl = hopper_ccl.label_components_plain(fh.edge_bin, 0)
    comp = compact_mask((lbl > 0).reshape(-1), int((lbl > 0).sum()) // 2)
    st = ccl.calc_strength(fh.edge_thin, lbl, 10000.0, comp)
    weak = ccl.rescue_filtered(lbl, ccl.filter_strength(lbl, st, 500, comp))
    lc = lbl.cuda()
    cc = compact_mask((lc > 0).reshape(-1), int((lbl > 0).sum()) // 2)
    stc = ccl.calc_strength(fh.edge_thin.cuda(), lc, 10000.0, cc)
    weakc = ccl.rescue_filtered(lc, ccl.filter_strength(lc, stc, 500, cc))
    assert torch.equal(stc.cpu(), st) and torch.equal(weakc.cpu(), weak)
    assert torch.equal(
        regions.color_reassign(fh.packed0.cuda(), lc).cpu(),
        regions.color_reassign(fh.packed0, lbl))
    assert torch.equal(rand.rand_field(5000, 7, "cuda").cpu(),
                       rand.rand_field(5000, 7))


# ---- the width-tiled path's offset forms (dist/tile.py) -------------------

# (x0, w_total) of a 96 x 128 window: the whole frame, a left tile's halo,
# odd interior columns, a right tile
TILE_OFFSETS = ((0, None), (-12, 200), (19, 181), (37, 301), (72, 200))


@pytest.mark.parametrize("x0,wt", TILE_OFFSETS)
def test_offset_forms_match_plain(x0, wt):
    """K3 (both variants, bridge2 off and on), the merge mask, blblur (its
    fused round counts), the links CCL and K2 at a frame column, each
    bit-equal to its plain version at the same offset, with as many
    kernels a call as the whole frame's form."""
    _need_card()
    r = np.random.default_rng(x0 + 100)
    h, w = 96, 128
    edge = torch.from_numpy((r.random((h, w)) < 0.3).astype(np.int32))
    lbl = torch.from_numpy(np.where(
        r.random((h, w)) < 0.25, r.integers(1, 50, (h, w)),
        np.where(r.random((h, w)) < 0.5, -1, 0)).astype(np.int32))
    packed = torch.from_numpy(((r.integers(0, 1024, (h, w)) << 22)
                               | (r.integers(0, 1024, (h, w)) << 12)
                               | r.integers(0, 4096, (h, w)))
                              .astype(np.int32))
    colours = torch.from_numpy(r.integers(0, 3, (h // 4, w // 4))
                               .repeat(4, 0).repeat(4, 1).astype(np.int32))
    mask = torch.from_numpy((r.random((h, w)) < 0.1).astype(np.int32))
    o = dict(x0=x0, w_total=wt)

    def held(fn, plain, *ts, kernels):
        n0 = _build.launch_count()
        got = fn(*(t.cuda() for t in ts))
        torch.cuda.synchronize()
        assert _build.launch_count() - n0 == kernels
        assert torch.equal(got.cpu(), plain(*ts))

    for v in ("rect", "poly_branch"):
        for b2 in (False, True):
            held(lambda e: hopper_morph.strings_chain(e, v, b2, **o),
                 lambda e: hopper_morph.strings_chain_plain(e, v, b2, **o),
                 edge, kernels=hopper_morph.KERNELS)
    held(lambda s: hopper_merge_mask.junction_merge_mask(s, **o),
         lambda s: regions.junction_merge_mask(s, **o), lbl, kernels=1)
    for iters in (1, 10):
        held(lambda p, e: hopper_blblur.blblur(p, e, iters, **o),
             lambda p, e: regions.blblur(p, e, iters, **o), packed,
             (edge > 0).to(torch.int32),
             kernels=hopper_blblur.launch_count(iters))
        for fuse in sorted(hopper_blblur.TILES):
            assert torch.equal(
                hopper_blblur.blblur_fused(packed.cuda(), edge.cuda(), iters,
                                           fuse, **o).cpu(),
                regions.blblur(packed, edge, iters, **o)), fuse
    held(lambda p, m, e: hopper_links.label_merge(p, m, e, **o),
         lambda p, m, e: regions.label_merge(p, m, e, **o), colours, mask,
         lbl, kernels=3)
    fe = edge_frontend(_scene())
    em, vec = hopper_grad.edge_front_plain(fe.labb)
    got = hopper_thin.thinthres(em.cuda(), vec.cuda(), x0=x0).cpu()
    want = hopper_thin.thin_plain(em, vec, x0=x0)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(got > 0, want > 0)


def test_rect_step_tiled_on_one_card_equals_rect_frame():
    """rect_step_tiled over two tiles on one device: the frame's
    RectResult bit for bit, every offset form launched, and the kernels
    its wrappers stated."""
    from rectdetect_tpu_torch.dist import tile as dtile
    from rectdetect_tpu_torch.dist.mesh import TileGroup
    _need_card()
    bgr = _scene(96, 256).cuda()
    g = TileGroup(["cuda:0"] * 2)
    mods = (hopper_morph, hopper_merge_mask, hopper_blblur, hopper_links,
            hopper_thin)
    for m in mods:
        m.offset_launches = 0
    got = _count_kernels(lambda: dtile.rect_step_tiled(g, g.split(bgr),
                                                       TAN_AOV))
    assert all(m.offset_launches == 2 for m in mods)
    want = rect_frame(bgr, TAN_AOV)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(want.valid.sum()) > 0


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("cap", [4096, 180])
def test_mkpl_slot_range_form_matches_one_launch_and_plain(cap, parts):
    """The slot-range entry points of #14 over 1-4 parts on one card: arena
    and lsid bit-equal to one rd_mkpl launch and to the plain form by slot
    range, at 0, 1 and 15 rounds, the arena overflowing at cap 180;
    kernels(parts, iters) launches by the library's counter; the inputs
    unchanged."""
    from rectdetect_tpu_torch.dist.mesh import TileGroup
    _need_card()
    g = TileGroup(["cuda:0"] * parts)
    arena, dense, number, comp = polyline.mkpl_inputs(
        _polylines().cuda(), 4, cap, PipelineConfig())
    before = [t.clone() for t in (*arena, dense, number, comp.idx)]
    for iters in (1, 2, 16):
        one = hopper_mkpl.mkpl_subdivide(arena, dense, number, 1.0, iters,
                                         comp)
        plain = mkpl.mkpl_subdivide(arena, dense, number, 1.0, iters, comp, g)
        n0 = _build.launch_count()
        got = hopper_mkpl.mkpl_subdivide(arena, dense, number, 1.0, iters,
                                         comp, g)
        torch.cuda.synchronize()
        assert _build.launch_count() - n0 == hopper_mkpl.kernels(parts, iters)
        for other in (one, plain):
            assert torch.equal(got[1], other[1]), iters
            for f in arena._fields:
                assert torch.equal(getattr(got[0], f),
                                   getattr(other[0], f)), (iters, f)
    if cap < 4096:
        assert int(got[0].count) == cap - 1
    for a, b in zip(before, (*arena, dense, number, comp.idx)):
        assert torch.equal(a, b)


def _no_plain_on_card(monkeypatch):
    """ops/mkpl.py:mkpl_subdivide raises when handed CUDA tensors."""
    plain = mkpl.mkpl_subdivide

    def guard(arena, label, *args, **kw):
        if label.is_cuda:
            raise AssertionError("the plain subdivision ran on the card")
        return plain(arena, label, *args, **kw)

    monkeypatch.setattr(mkpl, "mkpl_subdivide", guard)


def test_tiled_paths_run_the_slot_range_kernels_not_the_plain_form(
        monkeypatch):
    """rect_step_tiled and poly_step_tiled over 4 tiles of one card with
    the plain subdivision barred from the card: bit-equal to rect_frame
    and poly_frame, the slot-range form launched kernels(4, mkpl_iters)
    times a frame."""
    from rectdetect_tpu_torch.dist import tile as dtile
    from rectdetect_tpu_torch.dist.mesh import TileGroup
    _need_card()
    _no_plain_on_card(monkeypatch)
    cfg = PipelineConfig()
    bgr = _scene(96, 256).cuda()
    g = TileGroup(["cuda:0"] * 4)
    per_frame = hopper_mkpl.kernels(4, cfg.mkpl_iters)
    hopper_mkpl.launches = 0
    got = _count_kernels(lambda: dtile.rect_step_tiled(g, g.split(bgr),
                                                       TAN_AOV, cfg=cfg))
    assert hopper_mkpl.launches == per_frame
    want = rect_frame(bgr, TAN_AOV, cfg)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    hopper_mkpl.launches = 0
    ga, gl = _count_kernels(lambda: dtile.poly_step_tiled(g, g.split(bgr),
                                                          cfg))
    assert hopper_mkpl.launches == per_frame
    pa, pl = poly_frame(bgr, cfg)
    assert torch.equal(gl, pl) and int(pa.count) > 1
    for f in pa._fields:
        assert torch.equal(getattr(ga, f), getattr(pa, f)), f


# kernels a rect_frames call launches once for its whole stack: K1, K2,
# K3 (rect), blblur's 11, quant_despeckle, merge_mask, the links CCL's 3
# and despeckle2; the other 12 of a frame's 32 run once a frame
RECT_STACK_KERNELS = 20

# the stream axis: the batch forms of K1 and K2 (grid z = frame), on a
# width that takes edge_front's float4 staging (200) and one that does not
# (53), and a frame of one tile
BATCH_CARD_SHAPES = [(37, 200), (37, 53), (16, 64), (720, 1280)]


@pytest.mark.parametrize("h,w", BATCH_CARD_SHAPES)
def test_batch_forms_of_edge_front_and_thin_equal_single_calls(h, w):
    """edge_front and thinthres on a (4, H, W) stack: one kernel each for
    the four frames, every frame bit-equal to its own b = 1 call (and to
    the plain version within ATOL), in both thinning modes and at a frame
    column."""
    _need_card()
    labb = torch.stack([_blurred_lab(h, w, seed=s) for s in range(4)]).cuda()
    n0 = _build.launch_count()
    em, vec = hopper_grad.edge_front(labb)
    torch.cuda.synchronize()
    assert _build.launch_count() == n0 + 1
    assert em.shape == (4, h, w) and vec.shape == (4, h, w, 2)
    em_p, vec_p = hopper_grad.edge_front_plain(labb)
    torch.testing.assert_close(em, em_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(vec, vec_p, rtol=0, atol=ATOL)
    for i in range(4):
        em1, vec1 = hopper_grad.edge_front(labb[i])
        assert torch.equal(em[i], em1) and torch.equal(vec[i], vec1), i
    for mode, x0 in (("thres", 0), ("cubic", 0), ("thres", 307)):
        n0 = _build.launch_count()
        got = hopper_thin.thinthres(em, vec, mode=mode, x0=x0)
        torch.cuda.synchronize()
        assert _build.launch_count() == n0 + 1
        want = hopper_thin.thin_plain(em, vec, mode=mode, x0=x0)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        assert torch.equal(got > 0, want > 0)
        for i in range(4):
            assert torch.equal(got[i], hopper_thin.thinthres(
                em[i], vec[i], mode=mode, x0=x0)), (mode, i)
    with pytest.raises(ValueError):
        hopper_grad.edge_front(labb[None])


def test_rect_frames_and_poly_frames_on_card_equal_per_frame_calls():
    """rect_frames and poly_frames at B = 4: every frame bit-equal to its
    own call, K1 and K2 launched once for the four frames (the library's
    counter: rect_frames the per-frame calls' kernels less
    RECT_STACK_KERNELS (B - 1), poly_frames less 2 (B - 1)), and the same
    results as on the CPU."""
    from rectdetect_tpu_torch.pipeline.poly import poly_frames
    from rectdetect_tpu_torch.pipeline.rect import rect_frames
    _need_card()
    frames = torch.stack([_scene(seed=s) for s in range(4)])
    gpu = frames.cuda()
    singles, n_single = [], 0
    for i in range(4):
        n0 = _build.launch_count()
        singles.append(rect_frame(gpu[i], TAN_AOV))
        torch.cuda.synchronize()
        n_single += _build.launch_count() - n0
    hopper_grad.launches = hopper_thin.launches = 0
    res = _count_kernels(lambda: rect_frames(gpu, TAN_AOV))
    assert (hopper_grad.launches, hopper_thin.launches) == (1, 1)
    for i, want in enumerate(singles):
        for f in want._fields:
            assert torch.equal(getattr(res, f)[i], getattr(want, f)), (f, i)
    n0 = _build.launch_count()
    rect_frames(gpu, TAN_AOV)
    torch.cuda.synchronize()
    assert _build.launch_count() - n0 == n_single - RECT_STACK_KERNELS * 3
    cpu = rect_frame(frames[1], TAN_AOV)
    assert torch.equal(res.valid[1].cpu(), cpu.valid)
    torch.testing.assert_close(res.c2[1].cpu(), cpu.c2, rtol=0, atol=ATOL)
    n0 = _build.launch_count()
    arena, lsid = poly_frames(gpu, PipelineConfig())
    torch.cuda.synchronize()
    n_batch = _build.launch_count() - n0
    n0 = _build.launch_count()
    for i in range(4):
        a1, l1 = poly_frame(gpu[i], PipelineConfig())
        assert torch.equal(lsid[i], l1), i
        for f in a1._fields:
            assert torch.equal(getattr(arena, f)[i], getattr(a1, f)), (f, i)
    torch.cuda.synchronize()
    assert n_batch == _build.launch_count() - n0 - 2 * 3


def test_stream_supervisor_and_sharded_frames_on_card():
    """rect_frames_sharded over a 2 x 1 mesh of the one card equal to
    per-frame calls; the StreamSupervisor's default worker loop on two
    entries of the card, every frame equal to rect_frame's live_rects;
    an entry whose run_fn fails after its first frame is quarantined, its
    frame in flight dropped and its streams re-placed."""
    from rectdetect_tpu_torch.dist.mesh import make_mesh
    from rectdetect_tpu_torch.dist.stream import (StreamSupervisor,
                                                  rect_frames_sharded)
    from rectdetect_tpu_torch.pipeline.rect import live_rects
    _need_card()
    frames = torch.stack([_scene(seed=s) for s in range(4)])
    want = [rect_frame(frames[i].cuda(), TAN_AOV) for i in range(4)]
    res = rect_frames_sharded(frames, TAN_AOV,
                              make_mesh(2, 1, ["cuda:0"] * 2))
    for i in range(4):
        for f in want[i]._fields:
            assert torch.equal(getattr(res, f)[i], getattr(want[i], f))

    def same(got, sid):
        exp = live_rects(want[sid])
        assert len(got) == len(exp)
        for x, y in zip(got, exp):
            np.testing.assert_array_equal(x["c2"], y["c2"])
            assert x["status"] == y["status"] and x["value"] == y["value"]

    sup = StreamSupervisor(TAN_AOV, devices=["cuda:0"] * 2)
    for _ in range(2):
        for sid in range(4):
            assert sup.submit(sid, frames[sid].numpy())
        for sid in range(4):
            same(sup.collect(sid), sid)
    assert not sup.failures

    default_run = sup._run
    cur, used = {}, [0]

    def run_fn(bgr, device):
        if flaky._assign[cur["sid"]] == 1:
            used[0] += 1
            if used[0] > 1:
                raise RuntimeError("injected card fault")
        return default_run(bgr, device)

    flaky = StreamSupervisor(TAN_AOV, devices=["cuda:0"] * 2, run_fn=run_fn)
    dropped = 0
    for _ in range(2):
        for sid in range(4):
            cur["sid"] = sid
            assert flaky.submit(sid, frames[sid].numpy())
        for sid in range(4):
            got = flaky.collect(sid)
            if got is None:
                dropped += 1
            else:
                same(got, sid)
    assert [f[0] for f in flaky.failures] == [1] and dropped == 1
    assert set(flaky._assign.values()) == {0}


# the batch forms of the rect tail's dense kernels, on an odd frame and on
# one whose width is no multiple of 32 and whose tiles are crossed both
# ways
TAIL_CARD_SHAPES = [(37, 53), (144, 200)]


def _tail_stack(h, w, b=3):
    """The dense tail's maps of b scenes of h x w on the card: the front
    end's, the weak and strong labels, and each kernel's input, from the
    plain versions."""
    from rectdetect_tpu_torch.ops import morphology
    from rectdetect_tpu_torch.pipeline.rect import strength_labels
    fe = edge_frontend(torch.stack([_scene(h, w, seed=s)
                                    for s in range(b)]).cuda())
    s = morphology.strings_chain(fe.edge_bin, "rect")
    weak, strong = (torch.stack(m) for m in zip(*(
        strength_labels(s[i], fe.edge_thin[i]) for i in range(b))))
    blurred = regions.blblur(fe.packed0, (weak > 0).to(torch.int32))
    despeck = regions.quantize_despeckle(blurred, fe.edge_thin)
    mask = regions.junction_merge_mask(strong)
    seg = regions.label_merge(despeck, mask, strong)
    return fe, weak, strong, blurred, despeck, mask, seg


@pytest.mark.parametrize("h,w", TAIL_CARD_SHAPES)
def test_batch_forms_of_the_rect_tail_equal_single_calls(h, w):
    """K3 (every variant), blblur (at every fused round count, and the copy
    of iters = 0), quant_despeckle, merge_mask, the links CCL and
    despeckle2 on a stack of 3 frames: the kernels of one call for the
    stack by the library's counter, the result equal to the plain version
    and every frame to its own b = 1 call."""
    from rectdetect_tpu_torch.ops import morphology
    _need_card()
    fe, weak, strong, blurred, despeck, mask, seg = _tail_stack(h, w)
    weak_bin = (weak > 0).to(torch.int32)
    cases = [(f"strings_chain[{v}, {b2}]",
              lambda e, v=v, b2=b2: hopper_morph.strings_chain(e, v, b2),
              lambda e, v=v, b2=b2: morphology.strings_chain(e, v, b2),
              (fe.edge_bin,), 1)
             for v in ("rect", "poly_branch") for b2 in (False, True)]
    cases += [(f"blblur[F={f}]",
               lambda p, e, f=f: hopper_blblur.blblur_fused(p, e, 10, f),
               regions.blblur, (fe.packed0, weak_bin),
               hopper_blblur.launch_count(10, f))
              for f in hopper_blblur.TILES]
    cases += [
        ("blblur[iters=0]", lambda p, e: hopper_blblur.blblur(p, e, 0),
         lambda p, e: p, (fe.packed0, weak_bin), 0),
        ("quantize_despeckle", hopper_quant.quantize_despeckle,
         regions.quantize_despeckle, (blurred, fe.edge_thin), 1),
        ("junction_merge_mask", hopper_merge_mask.junction_merge_mask,
         regions.junction_merge_mask, (strong,), 1),
        ("label_merge", hopper_links.label_merge, regions.label_merge,
         (despeck, mask, strong), 3),
        ("sizes_despeckle2", hopper_despeckle2.sizes_despeckle2,
         regions.sizes_despeckle2, (seg,), 1)]
    for name, kernel, plain, args, kernels in cases:
        n0 = _build.launch_count()
        got = kernel(*args)
        torch.cuda.synchronize()
        assert _build.launch_count() - n0 == kernels, name
        assert got.shape == args[0].shape, name
        assert torch.equal(got, plain(*args)), name
        for i in range(3):
            assert torch.equal(got[i], kernel(*(a[i] for a in args))), \
                (name, i)
    assert int((fe.edge_bin > 0).sum()) > 0


def test_batch_forms_of_the_rect_tail_refuse_bad_stacks():
    """The C entry points refuse b = 0 and b = 65536 (cudaErrorInvalidValue,
    nothing launched), the wrappers an empty stack and one of more than
    65535 frames, and an offset (x0, w_total) with more than one frame."""
    _need_card()
    lib = _build.lib()
    x = torch.zeros((2, 8, 40), dtype=torch.int32, device="cuda")
    p = x.data_ptr()
    st = torch.cuda.current_stream().cuda_stream
    entries = {
        "strings_chain": lambda b: lib.rd_strings_chain(p, p, 8, 40, b, 0, 0,
                                                        0, 40, st),
        "blblur": lambda b: lib.rd_blblur(p, p, p, p, p, 8, 40, b, 10, 1, 0,
                                          40, st),
        "quant_despeckle": lambda b: lib.rd_quant_despeckle(
            p, p, p, 8, 40, b, 24, 24, 24, st),
        "merge_mask": lambda b: lib.rd_merge_mask(p, p, 8, 40, b, 0, 40, st),
        "label_merge": lambda b: lib.rd_label_merge(p, p, p, p, 8, 40, b, 0,
                                                    40, st),
        "despeckle2": lambda b: lib.rd_despeckle2(p, p, p, 8, 40, b, 16, st)}
    n0 = _build.launch_count()
    for name, fn in entries.items():
        for b in (0, 65536, -1):
            assert fn(b) == 1, (name, b)       # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert _build.launch_count() == n0
    for n in (0, _build.MAX_FRAMES + 1):
        big = torch.zeros((n, 1, 1), dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError):
            hopper_merge_mask.junction_merge_mask(big)
        with pytest.raises(ValueError):
            hopper_despeckle2.sizes_despeckle2(big)
    with pytest.raises(ValueError):
        hopper_merge_mask.junction_merge_mask(x[None])
    for kw in ({"x0": 3}, {"w_total": 80}):
        with pytest.raises(ValueError):
            hopper_morph.strings_chain(x, "rect", **kw)
        with pytest.raises(ValueError):
            hopper_blblur.blblur(x, x, **kw)
        with pytest.raises(ValueError):
            hopper_merge_mask.junction_merge_mask(x, **kw)
        with pytest.raises(ValueError):
            hopper_links.label_merge(x, x, x, **kw)
        one = x[:1]
        assert hopper_merge_mask.junction_merge_mask(one, **kw).shape == \
            one.shape


def test_rect_frames_runs_the_dense_tail_once_per_stack():
    """rect_frames at B = 3: 20 + 12 B kernels by the library's counter
    (RECT_STACK_KERNELS once for the stack, the rest once a frame), K3
    once for the stack's rect strings and once a frame inside the
    polylines, blblur, quant_despeckle, merge_mask, the links CCL and
    despeckle2 once; every frame bit-equal to its own rect_frame."""
    from rectdetect_tpu_torch.pipeline.rect import rect_frames
    _need_card()
    gpu = torch.stack([_scene(seed=s) for s in range(3)]).cuda()
    n0 = _build.launch_count()
    want = [rect_frame(gpu[i], TAN_AOV) for i in range(3)]
    torch.cuda.synchronize()
    per_frame = (_build.launch_count() - n0) // 3
    stack = (hopper_blblur, hopper_quant, hopper_merge_mask, hopper_links,
             hopper_despeckle2)
    for m in (hopper_morph, *stack):
        m.launches = 0
    n0 = _build.launch_count()
    res = _count_kernels(lambda: rect_frames(gpu, TAN_AOV))
    assert _build.launch_count() - n0 == RECT_STACK_KERNELS + 12 * 3
    assert per_frame == RECT_STACK_KERNELS + 12
    assert hopper_morph.launches == 1 + 3
    assert all(m.launches == 1 for m in stack)
    for i, w in enumerate(want):
        for f in w._fields:
            assert torch.equal(getattr(res, f)[i], getattr(w, f)), (f, i)


def test_host_packed_lab_against_the_card_packing():
    """The native host packing (runtime/native.py, built with g++) against
    core/color.py's packing on the card, on 2^20 random colours: each
    field within 1, at most 0.1% of colours differing."""
    from rectdetect_tpu_torch.core import color
    from rectdetect_tpu_torch.runtime import native
    _need_card()
    bgr = np.random.default_rng(5).integers(0, 256, (1024, 1024, 3),
                                            dtype=np.uint8)
    host = native.bgr_to_packedlab_host(bgr)
    card = color.pack_lab(color.bgr_to_labf(
        torch.from_numpy(bgr).cuda())).cpu().numpy()
    for shift, mask in ((0, 4095), (12, 1023), (22, 1023)):
        assert np.abs(((host >> shift) & mask) -
                      ((card >> shift) & mask)).max() <= 1
    assert (host != card).mean() <= 1e-3
