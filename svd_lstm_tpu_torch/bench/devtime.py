"""Device-time measurement with CUDA events.

Counterpart of ``svd_lstm_tpu/bench/devtime.py``, which read executable
durations from a ``jax.profiler`` trace. Here a pair of
``torch.cuda.Event``s brackets each call on the current stream, so the time
is the span the call occupies on the card, including any idle gaps the host
leaves while it enqueues the call's work. There is no CPU fallback: a
measurement that finds no card fails.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def device_time_ms(fn: Callable, *args, warmup: int = 1, repeats: int = 5) -> float:
    """Median over ``repeats`` of the device time of ``fn(*args)`` in ms,
    after ``warmup`` untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_time_ms needs a CUDA device; none is available")
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
