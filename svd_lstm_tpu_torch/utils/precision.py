"""Named inference precision modes.

Counterpart of ``svd_lstm_tpu/utils/precision.py``. On the H100:

* ``"exact"``: float32 matmuls in full float32 (TF32 off, float32 matmul
  precision "highest"), the analogue of the JAX package's
  ``jax_default_matmul_precision=float32``;
* ``"high"``: TF32 on for float32 matmuls (precision "high"), the card's
  nearest counterpart of JAX's ``default_matmul_precision("tensorfloat32")``.
  On the TPU that was 3-pass bf16 (relative error ~1e-4); TF32 keeps 10
  mantissa bits, so it is coarser (its error against exact is measured by
  ``chip_smoke.py`` and recorded in PERF.md);
* ``"fast"``: a no-op scope. Fast mode gets its speed from bf16 operands
  (``ops/cuda_batched.py``), not from a global setting.

Every scope restores the previous settings on exit. Nothing is set at
import.
"""

from __future__ import annotations

import contextlib
import copy

import torch

PRECISION_MODES = ("exact", "high", "fast")
_FLOAT32_PRECISION = {"exact": "highest", "high": "high"}


@contextlib.contextmanager
def _float32_matmul(mode: str):
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = mode == "high"
    torch.set_float32_matmul_precision(_FLOAT32_PRECISION[mode])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        # set the TF32 switch only where the precision did not restore it: a
        # needless set mixes torch's two APIs and makes the precision unreadable
        if torch.backends.cuda.matmul.allow_tf32 != allow_tf32:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def matmul_scope(precision: str):
    """Context manager selecting the float32 matmul mode of a named
    precision mode: 'exact' TF32 off, 'high' TF32 on, 'fast' untouched."""
    if precision not in PRECISION_MODES:
        raise ValueError(f"unknown precision: {precision!r}")
    if precision == "fast":
        return contextlib.nullcontext()
    return _float32_matmul(precision)


def exact_matmul():
    """float32 matmuls in full float32 (TF32 off, precision "highest") for
    the duration of the block; the previous settings are restored after."""
    return matmul_scope("exact")


def cast_params(model: torch.nn.Module, dtype=torch.bfloat16) -> torch.nn.Module:
    """A copy of ``model`` with every floating parameter cast to ``dtype``;
    the model itself is left as it is."""
    return copy.deepcopy(model).to(dtype)
