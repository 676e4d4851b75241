"""What a run records: its calls on the host clock, its set-up, and, in a
traced run, the device trace. The metric readers take everything from here."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional


@dataclasses.dataclass
class Call:
    """One call of the system under test, on ``time.perf_counter``: issued
    at ``t0``, returned to the benchmark at ``t_ret`` (before any
    synchronise), its output on the host at ``t_done``. ``frames``: the
    16-sample frames it processed; ``flops`` and ``bound_s``: its model
    FLOPs and the least time the H100 could take for it
    (``counts/lstm.py``). ``ok``: it returned without an error."""

    t0: float
    t_ret: float
    t_done: float
    frames: int
    flops: float
    bound_s: float
    ok: bool = True


@dataclasses.dataclass
class Run:
    """A run of one cell: ``calls`` made in the window, which opened at
    ``t_start``; ``setup_s`` from process start to the first timed call;
    ``layers`` and ``steps`` (time steps a call) of the model; ``trace``
    (``core.devtrace.Trace``) in a traced run."""

    workload: str
    seed: int
    setup_s: float
    t_start: float
    calls: list
    layers: int
    steps: int
    trace: Optional[Any] = None

    @property
    def done(self) -> list:
        return [c for c in self.calls if c.ok]

    @property
    def window_s(self) -> float:
        """From the window's opening to the last call's output on the host."""
        return max(c.t_done for c in self.calls) - self.t_start


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q ≤ 100): the smallest
    value that at least q % of the values do not exceed."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    return vals[max(math.ceil(q / 100.0 * len(vals)), 1) - 1]
