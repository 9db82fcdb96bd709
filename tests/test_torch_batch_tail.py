"""PyTorch port, the batched rect tail on the CPU: the plain versions of
the six kernels whose batch forms rect_frames runs once per stack (K3's
rect strings, blblur #12, quant_despeckle #5, merge_mask #6, the links
CCL #9, despeckle2 #8), and the stage functions that call them
(pipeline/rect.py: rect_strings, region_smoothing, region_merge,
tail_hypotheses_frames), each on a leading frame axis.

The JAX references come from the `batch_tail` fixture
(tests/data/batch_tail.npz, tools/make_torch_fixture.py batch_tail): the
JAX package's dense tail stages under jax.vmap on two stacks, four 48x64
frames and two 144x200 frames (a width that is no multiple of 32, tiles
crossed both ways), from the same front-end maps.  Nothing here imports
JAX.  The batch forms' kernels run on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 9); on the CPU the
wrappers run these plain versions.

Tolerance: none.  Every map is an integer map: each batched result equals
the fixture element for element, each frame equals its own single-frame
call bit for bit, and a stack of one frame equals the call on that frame.
"""

import json
import os

import numpy as np
import pytest
import torch

from rectdetect_tpu_torch.config import EXTENDED_CONFIG, PipelineConfig
from rectdetect_tpu_torch.ops import (_build, hopper_blblur,
                                      hopper_despeckle2, hopper_links,
                                      hopper_merge_mask, hopper_morph,
                                      hopper_quant)
from rectdetect_tpu_torch.pipeline.rect import (rect_strings, region_merge,
                                                region_smoothing,
                                                strength_labels,
                                                tail_hypotheses,
                                                tail_hypotheses_frames)

# several test workers share the cores; these tensors are small
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = np.load(os.path.join(ROOT, "tests", "data", "batch_tail.npz"))
META = json.loads(str(FIX["meta"]))
CFG = PipelineConfig(max_groups=16)
STACKS = ("s48", "s144")


def _maps(stack, *names):
    return [torch.from_numpy(FIX[f"{stack}/{k}"]) for k in names]


def _check_batched(fn, args, want):
    """fn on the stacked args equals `want` element for element, each
    frame equals fn on that frame alone, and a stack of one frame equals
    the single-frame call."""
    got = fn(*args)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    for i in range(want.shape[0]):
        one = fn(*(a[i] for a in args))
        assert torch.equal(got[i], one), i
    assert torch.equal(fn(*(a[:1] for a in args))[0], got[0])


def test_fixture_describes_both_stacks():
    assert FIX["s48/edge_bin"].shape == (4, 48, 64)
    assert FIX["s144/edge_bin"].shape == (2, 144, 200)
    assert META["config"] == "PipelineConfig(**{'max_groups': 16})"
    for key, n in META["counts"].items():
        assert n > 0, key


@pytest.mark.parametrize("stack", STACKS)
def test_rect_strings_batched_match_fixture(stack):
    """K3's rect variant on the stack (rect_strings, hopper_morph)."""
    edge_bin, want = _maps(stack, "edge_bin", "strings")
    _check_batched(lambda e: rect_strings(e, CFG), (edge_bin,), want)
    _check_batched(lambda e: hopper_morph.strings_chain(e, "rect"),
                   (edge_bin,), want)


def test_rect_strings_bridge2_batched_match_fixture():
    """K3's bridge2 variant, EXTENDED_CONFIG's, on the 48x64 stack."""
    edge_bin, want = _maps("s48", "edge_bin", "strings_bridge2")
    assert EXTENDED_CONFIG.bridge_gap2
    _check_batched(lambda e: rect_strings(e, EXTENDED_CONFIG), (edge_bin,),
                   want)
    assert not torch.equal(want, _maps("s48", "strings")[0])


@pytest.mark.parametrize("stack", STACKS)
def test_strength_labels_per_frame_match_fixture(stack):
    """The labels-and-strength part, frame by frame, on the fixture's
    strings: the > 0 maps of the weak and strong labels (the JAX package
    numbers its labels otherwise where its fixed-pass labels stand)."""
    strings, edge_thin, weak, strong = _maps(stack, "strings", "edge_thin",
                                             "weak", "strong")
    for i in range(strings.shape[0]):
        wk, sg = strength_labels(strings[i], edge_thin[i], CFG)
        assert torch.equal(wk > 0, weak[i] > 0), i
        assert torch.equal(sg > 0, strong[i] > 0), i


KERNELS = {
    "blblur": (lambda p, e: hopper_blblur.blblur(p, e, CFG.blblur_iters),
               ("packed0", "weak_bin"), "blurred"),
    "quantize_despeckle": (
        lambda p, e: hopper_quant.quantize_despeckle(
            p, e, *(CFG.quantize_levels,) * 3),
        ("blurred", "edge_thin"), "despeck"),
    "junction_merge_mask": (hopper_merge_mask.junction_merge_mask,
                            ("strong",), "mask"),
    "label_merge": (hopper_links.label_merge, ("despeck", "mask", "strong"),
                    "seg0"),
    "sizes_despeckle2": (
        lambda l: hopper_despeckle2.sizes_despeckle2(l, CFG.despeckle2_thre),
        ("seg0",), "seg"),
}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("stack", STACKS)
def test_batched_plain_versions_match_fixture(stack, kernel):
    """Each region kernel's wrapper (its plain version on the CPU) on the
    stack of the fixture's own inputs."""
    fn, inputs, output = KERNELS[kernel]
    args = []
    for k in inputs:
        if k == "weak_bin":
            args.append((_maps(stack, "weak")[0] > 0).to(torch.int32))
        else:
            args += _maps(stack, k)
    _check_batched(fn, args, _maps(stack, output)[0])


@pytest.mark.parametrize("stack", STACKS)
def test_region_stages_batched_match_fixture(stack):
    """region_smoothing and region_merge once on the stack, as
    rect_frames runs them."""
    packed0, edge_thin, weak, strong = _maps(stack, "packed0", "edge_thin",
                                             "weak", "strong")
    blurred, despeck = region_smoothing(packed0, weak, edge_thin, CFG)
    mask, seg = region_merge(despeck, strong, CFG)
    for k, got in zip(("blurred", "despeck", "mask", "seg"),
                      (blurred, despeck, mask, seg)):
        assert torch.equal(got, _maps(stack, k)[0]), k
    for i in range(packed0.shape[0]):
        b1, d1 = region_smoothing(packed0[i], weak[i], edge_thin[i], CFG)
        m1, s1 = region_merge(d1, strong[i], CFG)
        for k, a, b in (("blurred", blurred, b1), ("despeck", despeck, d1),
                        ("mask", mask, m1), ("seg", seg, s1)):
            assert torch.equal(a[i], b), (k, i)


def test_tail_hypotheses_frames_equals_per_frame_calls():
    """The batched tail on the 48x64 stack: every frame's maps and
    hypotheses equal tail_hypotheses on that frame alone, and its region
    labels the fixture's."""
    packed0, edge_thin, edge_bin, seg = _maps("s48", "packed0", "edge_thin",
                                              "edge_bin", "seg")
    got = tail_hypotheses_frames(packed0, edge_thin, edge_bin, CFG)
    assert len(got) == packed0.shape[0]
    for i, hyp in enumerate(got):
        want = tail_hypotheses(packed0[i], edge_thin[i], edge_bin[i], CFG)
        for f in want._fields:
            assert torch.equal(getattr(hyp, f), getattr(want, f)), (f, i)
        assert torch.equal(hyp.seg, seg[i]), i


def test_batch_form_frame_counts_and_offsets():
    """The wrappers' checks on the card, as pure functions: a map of one
    frame or a stack of 1..MAX_FRAMES frames, and the offset form
    (x0, w_total) only with one frame."""
    assert _build.frames((), "x") == 1
    assert _build.frames((3,), "x") == 3
    assert _build.frames((_build.MAX_FRAMES,), "x") == 65535
    for lead in ((0,), (_build.MAX_FRAMES + 1,), (2, 3)):
        with pytest.raises(ValueError):
            _build.frames(lead, "x")
    assert _build.frame_columns(1, 0, None, 40) == (0, 40)
    assert _build.frame_columns(1, 7, 120, 40) == (7, 120)
    assert _build.frame_columns(4, 0, None, 40) == (0, 40)
    for x0, w_total in ((7, None), (0, 40)):
        with pytest.raises(ValueError):
            _build.frame_columns(2, x0, w_total, 40)
