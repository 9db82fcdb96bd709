"""The check that decides `correct` fails what it should: the control (the
reference in bfloat16 in the program's place) and the faults a cell can
have, each planted under a whole CPU run at a tiny size with the
harness's look for a card skipped.  One card has no exchange between
chips and one camera no batch, so those faults have no place here."""

from __future__ import annotations

import pytest

from portbench import compare, control
from portbench.tests.conftest import cpu_run, tiny_cell

CELLS = ["vidrect.uhd1", "vidpoly.uhd1"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    nums = control.control_numbers(cell, 2 ** 31 + 3, "cpu")
    ok, _ = compare.judge(nums, cell.config["limits"])
    assert not ok, nums


def _every_step_checked(cell):
    cell.traffic["sample_steps"] = 1000
    return cell


@pytest.mark.parametrize("name", ["vidrect.uhd1", "vidpoly.uhd1"])
def test_state_left_unchanged(name, monkeypatch):
    """poll hands back the first frame's result for every frame."""
    import rectdetect_tpu_torch.pipeline.video as video
    attr = "live_rects" if name.startswith("vidrect") else "live_segments"
    orig, first = getattr(video, attr), []

    def stale(result):
        if not first:
            first.append(orig(result))
        return first[0]

    monkeypatch.setattr(video, attr, stale)
    line, _ = cpu_run(_every_step_checked(tiny_cell(name)), seconds=6.0)
    assert line["checked"]["frames"] and line["correct"] is False, line


def test_answer_altered_rect(monkeypatch):
    """rect_geometry moves the first corner of every group by 2 px."""
    import rectdetect_tpu_torch.pipeline.rect as rect
    orig = rect.rect_geometry

    def altered(*a, **k):
        res = orig(*a, **k)
        c2 = res.c2.clone()
        c2[:, 0] += 2.0
        return res._replace(c2=c2)

    monkeypatch.setattr(rect, "rect_geometry", altered)
    line, _ = cpu_run(tiny_cell("vidrect.uhd1"))
    assert line["checked"]["frames"] and line["correct"] is False, line


def test_answer_altered_poly(monkeypatch):
    """poly_frame moves the start of every segment by 2 px."""
    import rectdetect_tpu_torch.pipeline.video as video
    orig = video.poly_frame

    def altered(*a, **k):
        arena, lsid = orig(*a, **k)
        return arena._replace(sx=arena.sx + 2.0), lsid

    monkeypatch.setattr(video, "poly_frame", altered)
    line, _ = cpu_run(tiny_cell("vidpoly.uhd1"))
    assert line["checked"]["frames"] and line["correct"] is False, line


def test_sound_run_is_correct():
    line, _ = cpu_run(_every_step_checked(tiny_cell("vidrect.uhd1")))
    assert line["correct"] is True, line["compared"]
