"""Full-vs-reduced inference timing: whole-run batch-1 ``predict`` of the
dense and the reduced model, each timed on the card with
:func:`svd_lstm_tpu_torch.bench.devtime.device_time_ms`.

Counterpart of ``svd_lstm_tpu/bench/timing.py`` for ``predict``'s own
routing (``impl="auto"``). Its ``"pallas"`` impl (the fused reduced stack,
TPU kernel K4) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from svd_lstm_tpu_torch.api import predict
from svd_lstm_tpu_torch.bench.devtime import device_time_ms


@dataclasses.dataclass
class TimingResult:
    full_ms: float
    reduced_ms: float
    T: int

    @property
    def ratio(self) -> float:
        """timing(reduced)/timing(full) — the reference's headline metric."""
        return self.reduced_ms / self.full_ms


def time_full_vs_reduced(full, reduced, x: torch.Tensor) -> TimingResult:
    """Time ``predict(full, x)`` and ``predict(reduced, x)``, each the median
    of 5 after a warm-up; x is (T, d) on the card."""
    full_ms = device_time_ms(lambda: predict(full, x))
    red_ms = device_time_ms(lambda: predict(reduced, x))
    return TimingResult(full_ms=full_ms, reduced_ms=red_ms, T=x.shape[0])
