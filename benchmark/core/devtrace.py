"""Reading torch.profiler's Chrome trace of a window.

Device events are the kernels, copies and sets (categories ``kernel``,
``gpu_memcpy``, ``gpu_memset``). A trace without any raises
:class:`NoDeviceEvents`: there is no fallback to host events, since a host
op's time is not the device's. The window is the benchmark's own
annotation around the timed loop (:data:`WINDOW`); the device is busy where
any device event runs (the union of their intervals, so overlapping events
count once) and idle elsewhere in the window. An idle gap is named by what
the host's main thread was doing at its middle: the innermost event on the
thread that opened the window.

torch.profiler has dropped kernels on the H100 before, so the kernels of
the program's launch counters are counted in the trace as well
(:func:`launch_mismatch`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Iterable

WINDOW = "benchmark.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_SKIP = ("ac2g", "gpu_user_annotation", "Trace", "overhead") + DEVICE_CATEGORIES
NAME_CHARS = 160  # a breakdown row's name is cut to this many characters


class NoDeviceEvents(RuntimeError):
    """The trace holds no kernel, copy or set."""


@dataclasses.dataclass
class Trace:
    """A window's device and host events, in µs on the trace's clock:
    ``window`` (start, end); ``device`` [(start, end, name)] inside it,
    sorted; ``host`` [(start, end, name)] of the main thread, sorted by
    start and outermost first."""

    window: tuple
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, sorted."""
        merged: list = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """[(start, end)] of the window where no device event runs."""
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window[1]:
            gaps.append((t, self.window[1]))
        return gaps

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]]: device time by name, largest first."""
        totals: dict = {}
        for s, e, name in self.device:
            totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:NAME_CHARS], v] for n, v in rows]

    def idle_by_host(self, top: int = 10) -> list:
        """[[what the host did, seconds]]: the idle gaps' time by the
        innermost main-thread event at each gap's middle, largest first."""
        totals: dict = {}
        stack: list = []
        j = 0
        for s, e in self.idle_gaps():  # in time order: one sweep of the nested host events
            mid = (s + e) / 2
            while j < len(self.host) and self.host[j][0] <= mid:
                while stack and stack[-1][1] <= self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2] if stack else "(host outside any event)"
            totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:NAME_CHARS], v] for n, v in rows]

    def kernel_count(self, kernel: str) -> int:
        """Device events whose name holds ``kernel`` as a whole word."""
        pat = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(kernel)}(?![A-Za-z0-9_])")
        return sum(1 for _, _, name in self.device if pat.search(name))


def parse(events: Iterable[dict]) -> Trace:
    """A :class:`Trace` of Chrome-trace ``events`` holding one
    :data:`WINDOW` annotation. Raises :class:`NoDeviceEvents` when no
    device event lies inside it, ``ValueError`` without the annotation."""
    events = [e for e in events if e.get("ph") == "X" and "ts" in e]
    wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(wins) != 1:
        raise ValueError(f"expected one {WINDOW!r} annotation in the trace, found {len(wins)}")
    w = wins[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0))
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            s, t = max(s, w0), min(t, w1)
            if t > s:
                device.append((s, t, str(e.get("name", ""))))
    if not device:
        raise NoDeviceEvents(
            "the trace holds no device event (kernel, gpu_memcpy, gpu_memset) inside the "
            "window: the profiler did not trace the card")
    device.sort()
    main = (w.get("pid"), w.get("tid"))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), str(e.get("name", "")))
            for e in events
            if (e.get("pid"), e.get("tid")) == main and e.get("cat") not in _HOST_SKIP
            and e is not w]
    host.sort(key=lambda h: (h[0], -h[1]))
    return Trace(window=(w0, w1), device=device, host=host)


def launch_mismatch(trace: Trace, launched: dict, kernels: dict) -> dict:
    """``{counter: (launched, traced)}`` for each counter of ``launched``
    (the program's launch counters over the window) whose kernel
    (``kernels``: counter -> kernel names) the trace lists another number
    of times. Counters without a kernel name are not checked."""
    out = {}
    for counter, n in launched.items():
        if n and counter in kernels:
            traced = sum(trace.kernel_count(k) for k in kernels[counter])
            if traced != n:
                out[counter] = (n, traced)
    return out
