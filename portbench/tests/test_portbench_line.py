"""The result line a run prints, driven on the CPU at tiny sizes, and the
CLI's refusal where the card is missing."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import cpu_run, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


# windows long enough for a few frames on a loaded CPU
@pytest.mark.parametrize("name,seconds", [("vidrect.uhd1", 12.0),
                                          ("vidpoly.uhd1", 8.0)])
def test_line(name, seconds):
    cell = tiny_cell(name)
    line, err = cpu_run(cell, seconds=seconds)
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["compared"]) == set(cell.config["limits"])
    assert line["checked"]["frames"] >= 1
    assert err[-len(line["compared"]):] == [
        f"compared {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in line["compared"].items()]
    json.dumps(line, allow_nan=False)


def test_cli_refuses_without_the_card(cuda_absent):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "vidrect.uhd1",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cli_refuses_an_unknown_cell():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "nope",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
