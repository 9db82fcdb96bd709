"""PyTorch port on a CUDA card: each kernel against its plain version, and
the poly path on the card against the same path on the CPU.

These tests need a card and skip without one.  They import neither JAX
nor the JAX package, so they run where only PyTorch is installed; the
repository's tests/conftest.py imports JAX, so on such a machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K3, K4, labels, strings, lsid and arena integer fields equal;
K1/K2 float outputs and arena floats within atol 2e-4 (the Pallas
kernels' contract; the plain version's float64 emulation of a fused
multiply-add may round twice on a tie), edge_thin > 0 equal.
"""

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.config import PipelineConfig
from rectdetect_tpu_torch.ops import (hopper_ccl, hopper_grad, hopper_morph,
                                      hopper_thin, polyline)
from rectdetect_tpu_torch.pipeline.frontend import edge_frontend
from rectdetect_tpu_torch.pipeline.poly import poly_frame

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
    cfg = PipelineConfig(mkpl_pallas=0)
    with pytest.raises(NotImplementedError, match="mkpl"):
        poly_frame(bgr.cuda(), PipelineConfig())
    with pytest.raises(NotImplementedError, match="mkpl"):
        polyline.polyline_execute(_maps()[0].cuda(), 1.0, 20, 256,
                                  PipelineConfig())
    mods = (hopper_grad, hopper_thin, hopper_morph, hopper_ccl)
    for m in mods:
        m.launches = 0
    ga, gl = poly_frame(bgr.cuda(), cfg)
    assert all(m.launches >= 1 for m in mods)
    ca, cl = poly_frame(bgr, cfg)
    assert torch.equal(gl.cpu(), cl)
    for f in ca._fields:
        got, want = getattr(ga, f).cpu(), getattr(ca, f)
        if want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        else:
            assert torch.equal(got, want), f
