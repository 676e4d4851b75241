"""Profiler trace capture and a per-op time breakdown, on ``torch.profiler``.

Counterpart of ``svd_lstm_tpu/bench/trace.py``. :func:`capture_trace`
writes a Chrome trace of one call (viewable in https://ui.perfetto.dev or
chrome://tracing) and :func:`op_breakdown` aggregates its complete events
by name. On the card only the device's events count (kernels, copies,
sets); a trace with none, as on the CPU, falls back to its CPU ops, each
counted where it is not inside another one, so the rows add up to no more
than the call. ``bench.devtime.device_time_ms`` stays the timing primitive;
this module is the diagnostic surface.

torch.profiler's device trace has dropped kernels on the H100 before (a
call once listed one of its five), so a launch count that matters is read
from the wrappers' own counters (``ops.cuda_lstm.LAUNCHES``), and the
breakdown is held against them where both exist (``chip_smoke.py`` 9b).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Callable, NamedTuple, Sequence

import torch

TRACE_FILE = "trace.json"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CALL = "bench.trace.call"  # the annotation around the traced call
# profiler and runtime scaffolding, not work: CUDA API calls (by category,
# and by name: cudaLaunchKernel, cuLaunchKernel), Python frames, annotations
# (ours and ProfilerStep#), profiler internals
_SCAFFOLD_CATEGORIES = ("cuda_runtime", "python_function", "user_annotation", "gpu_user_annotation",
                        "Trace", "overhead")
_SCAFFOLD_NAME = re.compile(r"^(ProfilerStep#|cudaLaunch|cuda[A-Z]|cu[A-Z]|\[memory\]|<built-in)"
                            r"|profiler|\.py\(\d+\)")


class OpStat(NamedTuple):
    """Aggregated time of one op or kernel name."""

    name: str
    count: int
    total_ms: float


def _is_workload(e: dict) -> bool:
    name = str(e.get("name", ""))
    if e.get("ph") != "X" or not name or e.get("cat") in _SCAFFOLD_CATEGORIES:
        return False
    return not _SCAFFOLD_NAME.search(name)


def capture_trace(fn: Callable, *args, out_dir: str, warmup: int = 1) -> str:
    """Run ``fn(*args)`` ``warmup`` times, then once under ``torch.profiler``
    (CPU activity, and CUDA activity wherever a card is present: a call on
    CPU tensors then records no device event), synchronised inside the
    trace, and write ``out_dir/trace.json``. Returns ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(max(warmup, 0)):
        fn(*args)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(_CALL):
            fn(*args)
            sync()
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
    return out_dir


def trace_events(trace_dir: str) -> list:
    """The events of the newest Chrome trace (``*.json``) in ``trace_dir``."""
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    if not files:
        raise FileNotFoundError(f"no trace (*.json) in {trace_dir}")
    with open(max(files, key=os.path.getmtime)) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _outermost(events: list) -> list:
    """The events not inside another of ``events`` on the same thread."""
    out, ends = [], {}
    for e in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"), e["ts"], -e.get("dur", 0))):
        key = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(key, float("-inf")):
            out.append(e)
            ends[key] = e["ts"] + e.get("dur", 0)
    return out


def _work(events: list) -> list:
    """The events a breakdown counts: the device's where there are any,
    else the outermost CPU ops."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES and _is_workload(e)]
    if device:
        return device
    return _outermost([e for e in events if _is_workload(e) and "ts" in e])


def op_breakdown(trace_dir, top: int = 0) -> list:
    """Aggregate complete ('X') events by name, sorted by total time,
    descending; ``top`` truncates (0: all). ``trace_dir`` is a directory of
    :func:`capture_trace` or a list of Chrome-trace events. Only device
    events count where the trace has any; scaffolding (``ProfilerStep#``,
    CUDA runtime calls, Python frames, annotations, profiler internals) is
    dropped."""
    events = trace_events(trace_dir) if isinstance(trace_dir, (str, os.PathLike)) else trace_dir
    totals: dict = {}
    for e in _work(events):
        acc = totals.setdefault(str(e["name"]), [0, 0.0])
        acc[0] += 1
        acc[1] += e.get("dur", 0) / 1000.0
    stats = sorted((OpStat(n, c, t) for n, (c, t) in totals.items()), key=lambda s: -s.total_ms)
    return stats[:top] if top else stats


def format_breakdown(stats: Sequence[OpStat], total_ms: float | None = None) -> str:
    """Render an op table; ``total_ms`` adds a % column."""
    if not stats:
        return "(no workload events in trace)"
    width = min(max(len(s.name) for s in stats), 60)
    lines = [f"{'op':<{width}}  {'count':>6}  {'ms':>10}" + (f"  {'%':>6}" if total_ms else "")]
    for s in stats:
        name = s.name if len(s.name) <= width else s.name[: width - 1] + "…"
        row = f"{name:<{width}}  {s.count:>6}  {s.total_ms:>10.3f}"
        if total_ms:
            row += f"  {100.0 * s.total_ms / total_ms:>5.1f}%"
        lines.append(row)
    return "\n".join(lines)


def _span_ms(events: list) -> float:
    start = min(e["ts"] for e in events)
    return (max(e["ts"] + e.get("dur", 0) for e in events) - start) / 1000.0


def device_ms(events: list) -> float:
    """On the card, the span from the first device event to the end of the
    last; in a trace without any, the traced call's own span."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES and _is_workload(e)]
    if device:
        return _span_ms(device)
    call = [e for e in events if e.get("name") == _CALL and e.get("ph") == "X"
            and e.get("cat") != "gpu_user_annotation"]
    return _span_ms(call) if call else 0.0


def summarize(fn: Callable, *args, out_dir: str, top: int = 15, warmup: int = 1) -> dict:
    """Capture a trace of ``fn(*args)`` and summarise it:
    ``{"trace_dir", "device_ms", "ops": [OpStat, ...]}`` (see
    :func:`device_ms`, :func:`op_breakdown`)."""
    capture_trace(fn, *args, out_dir=out_dir, warmup=warmup)
    events = trace_events(out_dir)
    return {"trace_dir": out_dir, "device_ms": device_ms(events), "ops": op_breakdown(events, top=top)}
