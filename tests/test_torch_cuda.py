"""PyTorch port on a CUDA card: each kernel against its plain version, and
the poly path and the rect path's region maps on the card against the
same paths on the CPU.

These tests need a card and skip without one.  They import neither JAX
nor the JAX package, so they run where only PyTorch is installed; the
repository's tests/conftest.py imports JAX, so on such a machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K3, K4, labels, strings, lsid and arena integer fields equal;
K1/K2 float outputs and arena floats within atol 2e-4 (the Pallas
kernels' contract; the plain version's float64 emulation of a fused
multiply-add may round twice on a tie), edge_thin > 0 equal.  The mkpl
kernel's arena is held bit-equal to the plain subdivision on the card
(the same float operations on both sides); seg_scan, blblur and
quant_despeckle are integer-valued and equal.
"""

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.ops import (hopper_blblur, hopper_ccl, hopper_grad,
                                      hopper_mkpl, hopper_morph, hopper_quant,
                                      hopper_scan, hopper_thin, mkpl,
                                      polyline, regions)
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.poly import poly_frame
from rectdetect_tpu_torch.pipeline.rect import (region_smoothing,
                                                weak_strong_labels)

pytestmark = pytest.mark.cuda

ATOL = 2e-4


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


def test_wrappers_check_their_inputs():
    _need_card()
    edge = _maps()[0].cuda()
    with pytest.raises(TypeError):
        hopper_morph.strings_chain(edge.float(), "rect")
    with pytest.raises(ValueError):
        hopper_ccl.label_components(edge.t(), 0)          # not contiguous
    with pytest.raises(ValueError):
        hopper_grad.edge_front(torch.zeros((8, 8, 2), device="cuda"))


def test_poly_frame_on_card_matches_cpu_and_counts_launches():
    _need_card()
    bgr = _scene()
    mods = (hopper_grad, hopper_thin, hopper_morph, hopper_ccl, hopper_mkpl)
    for m in mods:
        m.launches = 0
    ga, gl = poly_frame(bgr.cuda(), PipelineConfig())
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


@pytest.mark.parametrize("cap", [4096, 200, 180])
def test_mkpl_kernel_matches_plain(cap):
    """The arc slot list outnumbers the arena at every cap here; at 200
    and 180 the arena overflows during the subdivision (173 arcs, 284
    segments unbounded) and splits drop in id order."""
    _need_card()
    comp, (ga, gl), (pa, pl) = _mkpl_case(_polylines().cuda(), cap)
    assert comp.cap > cap > 173
    assert torch.equal(gl, pl)
    for f in pa._fields:
        assert torch.equal(getattr(ga, f), getattr(pa, f)), f
    if cap < 4096:
        assert int(ga.count) == cap - 1


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
