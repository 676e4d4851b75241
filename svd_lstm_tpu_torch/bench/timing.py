"""Full-vs-reduced inference timing: whole-run batch-1 inference of the
dense and the reduced model, each timed on the card with
:func:`svd_lstm_tpu_torch.bench.devtime.device_time_ms`, across
implementations.

Counterpart of ``svd_lstm_tpu/bench/timing.py``:

* ``auto``   — ``predict``'s own routing;
* ``scan``   — the plain time loops (``stacked_lstm_apply``, and the
  two-step ``reduced_lstm_apply`` for the reduced model);
* ``pallas`` — one kernel for the whole stack: K1 (``fused_dense_stack``)
  for the dense model, K4 (``fused_reduced_stack``, both sides factored)
  for the reduced one;
* ``hybrid`` — matmul x-side projections + the recurrence kernels.

The default is ``"auto"``, where the JAX package's is ``"pallas"``: there
the fused kernels were the fast path the harness was written for, while on
the H100 ``predict``'s routing is what a user runs (it takes K1 for narrow
stacks and the hybrids for wide ones, where the single-CTA K1 and K4 read
every wide weight matrix each step), and ``chip_smoke.py`` times it.

``precision`` is ``predict``'s batch-1 mode: ``"exact"`` (the JAX harness's
only mode) or ``"fast"``, which runs the kernels' bf16-operand variants
(``dot_precision="default"``; ``predict(precision="fast")`` for ``auto``).
``scan`` is the exact float32 loop in both, as in ``predict``. Everything
else runs with TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from svd_lstm_tpu_torch.api import predict
from svd_lstm_tpu_torch.bench.devtime import device_time_ms
from svd_lstm_tpu_torch.models.lstm import stacked_lstm_apply
from svd_lstm_tpu_torch.models.reduced import reduced_lstm_apply
from svd_lstm_tpu_torch.ops import cuda_lstm
from svd_lstm_tpu_torch.utils.precision import exact_matmul

IMPLS = ("auto", "scan", "pallas", "hybrid")
PRECISIONS = ("exact", "fast")


@dataclasses.dataclass
class TimingResult:
    full_ms: float
    reduced_ms: float
    T: int

    @property
    def ratio(self) -> float:
        """timing(reduced)/timing(full) — the reference's headline metric."""
        return self.reduced_ms / self.full_ms

    @property
    def full_us_per_step(self) -> float:
        return self.full_ms * 1e3 / self.T

    @property
    def reduced_us_per_step(self) -> float:
        return self.reduced_ms * 1e3 / self.T


def _exact(fn):
    def run(model, x):
        with exact_matmul(), torch.no_grad():
            return fn(model, x)

    return run


def forward_fns(impl: str, precision: str = "exact"):
    """(full, reduced) forward functions of ``impl`` in ``precision``, each
    ``(model, x (T, d)) -> (T, out)``. An unknown impl or precision raises
    ``ValueError``."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    dp = "default" if precision == "fast" else None
    if impl == "auto":
        fn = lambda m, x: predict(m, x, precision=precision)
        return fn, fn
    if impl == "scan":
        full = lambda m, x: stacked_lstm_apply(m, x[None])[0]
        red = lambda m, x: reduced_lstm_apply(m, x[None])[0]
    elif impl == "pallas":
        full = lambda m, x: cuda_lstm.fused_dense_stack(m, x, dot_precision=dp)
        red = lambda m, x: cuda_lstm.fused_reduced_stack(m, x, dot_precision=dp)
    elif impl == "hybrid":
        full = lambda m, x: cuda_lstm.dense_forward_hybrid(m, x, dot_precision=dp)
        red = lambda m, x: cuda_lstm.reduced_forward_hybrid(m, x, dot_precision=dp)
    else:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return _exact(full), _exact(red)


def time_full_vs_reduced(full, reduced, x: torch.Tensor, impl: str = "auto",
                         repeats: int = 5, precision: str = "exact") -> TimingResult:
    """Time the full and the reduced model's forward of ``impl`` in
    ``precision``, each the median of ``repeats`` after a warm-up; x is
    (T, d) on the card."""
    full_fn, red_fn = forward_fns(impl, precision)
    full_ms = device_time_ms(full_fn, full, x, repeats=repeats)
    red_ms = device_time_ms(red_fn, reduced, x, repeats=repeats)
    return TimingResult(full_ms=full_ms, reduced_ms=red_ms, T=x.shape[0])


def time_all_impls(full, reduced, x: torch.Tensor, impls=("scan", "pallas", "hybrid"),
                   repeats: int = 5, precision: str = "exact") -> Dict[str, TimingResult]:
    return {impl: time_full_vs_reduced(full, reduced, x, impl, repeats, precision)
            for impl in impls}
