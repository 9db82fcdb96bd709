"""The metric arithmetic on made-up spans and a made-up trace."""

from __future__ import annotations

import pytest

from portbench import roofline, stats, trace
from portbench.harness import Run
from portbench.loops import Done, Spans
from portbench.metrics import (device_idle_share, enqueue_ms, frame_p95_ms,
                               frames_per_s, kernels_roofline,
                               launches_per_frame)


def test_percentile_nearest_rank():
    assert stats.percentile([], 95) is None
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs[::-1], 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_union_busy_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union(iv) == [(0, 3), (5, 6), (9, 12)]
    assert stats.busy(iv, 0, 10) == pytest.approx(5)
    assert stats.busy(iv, 1, 5.5) == pytest.approx(2.5)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def _run(frames, seconds=10.0, spans=None, trace=None):
    return Run(seconds, 100.0, 100.0 + seconds, 5.0, spans or Spans(),
               frames, len(frames), trace)


def test_rate_over_the_whole_window_and_p95_over_all_frames():
    # 40 frames done inside the 10 s window, one after it
    frames = [Done(i, 0, 0, 100.0 + i * 0.2, 100.0 + i * 0.2 + 0.01 * (i + 1),
                   None) for i in range(40)]
    frames.append(Done(40, 0, 0, 109.9, 110.5, None))
    run = _run(frames)
    assert frames_per_s.read(run) == pytest.approx(4.0)
    # latencies 10..400 ms: the 38th of 40 is the 95th percentile
    assert frame_p95_ms.read(run) == pytest.approx(380.0)


def test_span_readers():
    s = Spans()
    s.by_name["enqueue"] = [(100.0, 100.002), (101.0, 101.004), (99.0, 99.5)]
    run = _run([None] * 2, spans=s)
    # the span before the window is left out; 6 ms over 2 frames
    assert enqueue_ms.read(run) == pytest.approx(3.0)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_summary_idle_from_overlapping_intervals():
    port = "(anonymous namespace)::hyp_kernel(float const*, int, int)"
    events = [
        _ev("user_annotation", "portbench.stretch", 1000, 1000),
        _ev("user_annotation", "portbench.hypotheses", 1100, 300),
        _ev("user_annotation", "portbench.poll", 1600, 200),
        _ev("kernel", "void at::native::elementwise_kernel<128>(int)",
            1000, 100),
        _ev("kernel", port, 1050, 100),          # overlaps the first
        _ev("gpu_memcpy", "Memcpy HtoD", 1400, 100),
        _ev("kernel", port, 1900, 200),          # runs past the stretch
        _ev("cuda_runtime", "cudaLaunchKernel", 1000, 5),
    ]
    calls = [("rd_hyp", (0, 0, 0, 0, 384, 48, 24, 0.0), 1),
             ("rd_hyp", (0, 0, 0, 0, 384, 48, 24, 0.0), 1)]
    t = trace.summarize(events, 4, calls)
    assert t["window_s"] == pytest.approx(1e-3)
    # busy: [1000,1150] + [1400,1500] + [1900,2000] = 350 us
    assert t["busy_s"] == pytest.approx(350e-6)
    assert t["kernels"] == 3 and t["port_kernels"] == 2
    assert t["library_kernels"] == 2
    assert t["port_kernel_s"] == pytest.approx(300e-6)
    gaps = dict(t["idle_gaps"])
    # [1150,1400] in hypotheses, [1500,1900] in poll (midpoint 1700)
    assert gaps == pytest.approx({"hypotheses": 250e-6, "poll": 400e-6})
    run = _run([], trace=t)
    assert device_idle_share.read(run) == pytest.approx(0.65)
    assert launches_per_frame.read(run) == pytest.approx(0.75)
    bound = 2 * roofline.bound_seconds("rd_hyp", calls[0][1])
    assert kernels_roofline.read(run) == pytest.approx(100 * bound / 300e-6)
    assert 0 < kernels_roofline.read(run) < 100
    assert trace.summarize(events[1:], 4, calls) is None


def test_roofline_counts():
    assert roofline.kernel_base(
        "void (anonymous namespace)::chain_kernel<1, false>(int const*)") \
        == "chain_kernel"
    assert roofline.is_port_kernel(
        "rd::(anonymous namespace)::flatten_kernel(int*, int)")
    assert roofline.is_port_kernel(
        "(anonymous namespace)::mkpl_kernel((anonymous namespace)::Args)")
    assert not roofline.is_port_kernel(
        "void at::native::(anonymous namespace)::foo_kernel(int)")
    # K1 at 720p: 24 bytes a pixel over 3.35 TB/s
    assert roofline.bound_seconds("rd_edge_front", (0, 0, 0, 720, 1280, 1)) \
        == pytest.approx(24 * 720 * 1280 / 3.35e12)
    assert roofline.bound_seconds("rd_unknown", ()) == 0.0
    assert roofline.bound_seconds("rd_mkpl", (0,) * 13) == 0.0
    # the pose at 384 groups is bound by its operations
    a = (0, 0, 0, 0, 384, 1280.0, 720.0, 0.7, 12, 10)
    nbytes, ops = roofline.ENTRIES["rd_pose"](a)
    assert ops / roofline.F32_OPS_PER_S > nbytes / roofline.HBM_BYTES_PER_S
