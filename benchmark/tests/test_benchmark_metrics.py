"""The metric readers on a synthetic run: the rate, the p95 over all calls,
the idle share of a trace with overlapping intervals, the breakdown, and a
trace reader that fails on a trace without device events."""

import pytest

from benchmark.core import cell as cells
from benchmark.core import devtrace
from benchmark.core.record import Call, Run, percentile


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid}


def _trace_events():
    """A 100 µs window: kernels at 10–30 and 20–40 (overlapping), a copy at
    50–60, a kernel at 90–120 (cut at the window's end); the host in
    ``benchmark.predict`` 0–45 and ``aten::copy_`` 45–70 on the main thread,
    and a busy other thread that must not name a gap."""
    return [
        _ev(devtrace.WINDOW, "user_annotation", 0, 100),
        _ev("benchmark.predict", "user_annotation", 0, 45),
        _ev("aten::copy_", "cpu_op", 45, 25),
        _ev("cudaMemcpyAsync", "cuda_runtime", 46, 20),
        _ev("other_thread_op", "cpu_op", 0, 100, tid=2),
        _ev("void reduced_chain<true, 8>(RedArgs)", "kernel", 10, 20),
        _ev("void reduced_chain<true, 8>(RedArgs)", "kernel", 20, 20),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 50, 10),
        _ev("benchmark.predict", "gpu_user_annotation", 0, 100),
        _ev("gemv2T_kernel", "kernel", 90, 30),
        _ev("late_kernel", "kernel", 150, 10),
    ]


def test_trace_union_idle_and_breakdown():
    tr = devtrace.parse(_trace_events())
    assert tr.window_s == pytest.approx(100e-6)
    # busy: [10, 40] ∪ [50, 60] ∪ [90, 100]: 30 + 10 + 10 µs
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.idle_gaps() == [(0, 10), (40, 50), (60, 90)]
    ops = dict(tr.device_ops())
    assert ops["void reduced_chain<true, 8>(RedArgs)"] == pytest.approx(40e-6)  # sum, not union
    assert "late_kernel" not in ops
    idle = dict(tr.idle_by_host())
    # 0–10 and 40–45 lie in benchmark.predict's span; 60–90 in aten::copy_'s
    # outside cudaMemcpyAsync (46–66): the gap's middle, 75, is in neither
    assert idle["benchmark.predict"] == pytest.approx(10e-6)
    assert idle["(host outside any event)"] == pytest.approx(30e-6)
    assert tr.kernel_count("reduced_chain") == 2 and tr.kernel_count("reduced") == 0


def test_gap_named_by_innermost_host_event():
    events = [_ev(devtrace.WINDOW, "user_annotation", 0, 100),
              _ev("benchmark.fit", "user_annotation", 0, 100),
              _ev("aten::item", "cpu_op", 40, 20),
              _ev("cudaStreamSynchronize", "cuda_runtime", 45, 10),
              _ev("k", "kernel", 0, 40), _ev("k", "kernel", 60, 40)]
    assert devtrace.parse(events).idle_by_host() == [["cudaStreamSynchronize", pytest.approx(20e-6)]]


def test_no_device_events_fails_not_falls_back():
    events = [e for e in _trace_events() if e["cat"] not in devtrace.DEVICE_CATEGORIES]
    with pytest.raises(devtrace.NoDeviceEvents):
        devtrace.parse(events)
    with pytest.raises(ValueError):
        devtrace.parse([_ev("k", "kernel", 0, 1)])  # no window


def test_launch_mismatch():
    tr = devtrace.parse(_trace_events())
    kernels = {"reduced_recurrence": ["reduced_chain"], "lstm_recurrence": ["recurrence_chain"]}
    assert devtrace.launch_mismatch(tr, {"reduced_recurrence": 2, "lstm_recurrence": 0}, kernels) == {}
    assert devtrace.launch_mismatch(tr, {"reduced_recurrence": 3}, kernels) == {"reduced_recurrence": (3, 2)}


def _run(trace=None):
    # 20 calls of 10 ms but one of 50 ms and one failed; 1000 frames each
    calls, t = [], 0.0
    for i in range(20):
        dur = 0.050 if i == 7 else 0.010
        calls.append(Call(t, t + 0.001, t + dur, 1000, 2e9, 1e-4, ok=(i != 3)))
        t += dur
    return Run(workload="w", seed=1, setup_s=4.5, t_start=0.0, calls=calls, layers=2, steps=1000,
               trace=trace)


def read(name, run):
    return cells.metric_reader(name)(run)


def test_rate_p95_and_host_span():
    run = _run()
    window = 0.010 * 19 + 0.050
    assert read("frames_per_s", run) == pytest.approx(19 * 1000 / window)
    # 19 completed calls: the nearest-rank p95 is the 19th smallest, the 50 ms call
    assert read("seq_p95_ms", run) == pytest.approx(50.0)
    assert percentile(list(range(1, 101)), 95) == 95 and percentile([3.0], 95) == 3.0
    assert read("setup_s", run) == 4.5
    assert read("entry.host_ms", run) == pytest.approx(1.0)
    assert read("step.mfu_pct", run) == pytest.approx(100 * 19 * 2e9 / (window * 67e12))
    for name in ("kernels_roofline", "kernels.us_per_layer_step", "device.idle_pct"):
        assert read(name, run) is None  # no trace: nothing to read, never 0


def test_trace_metrics():
    run = _run(devtrace.parse(_trace_events()))
    assert read("device.idle_pct", run) == pytest.approx(50.0)
    assert read("kernels_roofline", run) == pytest.approx(100 * 19 * 1e-4 / 50e-6)
    assert read("kernels.us_per_layer_step", run) == pytest.approx(50e-6 / 19 / 2000 * 1e6)
