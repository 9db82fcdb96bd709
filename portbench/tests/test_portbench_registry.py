"""BENCHMARK.json against the contract the harness is built to, and every
cell's files found by name."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and \
            (harness.CHECKOUT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert all(c in CELLS for c in m["workloads"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        c = harness.resolve(BENCH, cell)
        assert "setup_s" in [m["name"] for m in c.end_to_end]
        assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.resolve(BENCH, cell)
    assert c.config["entry"] in ("rect", "poly")
    assert c.config["limits"]
    assert harness.driver_module(c).make
    for m in c.end_to_end + c.per_layer:
        mod = harness.reader(m["name"])
        assert callable(mod.read)
        for module, attr in getattr(mod, "WRAPS", ()):
            assert mod.SPAN


def test_cell_added_by_files_and_an_entry(tmp_path):
    """A copy of the benchmark gains a traffic mix, a driver and a metric as
    new files, and a cell as a new entry; no file that was there changes,
    and the new cell runs on the CPU with the new metric in its line."""
    src = harness.ROOT
    dst = tmp_path / "portbench"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(dst): p.read_bytes() for p in dst.rglob("*")
              if p.is_file()}
    (dst / "traffic" / "pair.json").write_text(json.dumps({
        "name": "pair", "cameras": 2, "width": 128, "height": 96, "ring": 2,
        "in_flight": 1, "drivers": {"poly": "pair_poly"},
        "sample_steps": 1, "trace_steps": 1}))
    (dst / "drivers" / "pair_poly.py").write_text(
        "from portbench.loops import VideoLoop\n\n\n"
        "def make(s):\n"
        "    from rectdetect_tpu_torch.pipeline.video import "
        "VideoPolyDetector\n"
        "    c = s.config\n"
        "    return VideoLoop(VideoPolyDetector(s.cfg, c['minerror'], "
        "c['size_thre'], c['strength'], device=s.device), s)\n")
    (dst / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "vidpoly.pair", "config": "vidpoly",
                               "traffic": "pair", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["vidpoly.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(dst): p.read_bytes() for p in dst.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
    code = ("import time, json\nfrom portbench import harness\n"
            "harness.WARM_SECONDS = 0.0\n"
            "c = harness.resolve(harness.load_benchmark(), 'vidpoly.pair')\n"
            "line, _ = harness.run_cell(c, 3, 1.0, False, time.perf_counter(),"
            " device='cpu')\nprint(json.dumps(line))\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}"
               f"{harness.CHECKOUT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["frames_done"]["value"] > 0
    assert line["correct"] is True
