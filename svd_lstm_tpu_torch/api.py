"""High-level inference API: ``predict(model, x)``.

Counterpart of ``svd_lstm_tpu/api.py`` for exact mode.

Routing (``impl="auto"``):

* CPU tensors take the plain versions: the ``scan`` time loops of
  ``models/*``.
* Batch-1 ``(T, d)`` CUDA input takes the kernels in ``ops/cuda_lstm.py``:
  every layer n ≤ 128 → ``fused`` (the whole stack in one kernel; singular
  and reduced models after their exact dense reconstruction), anything
  wider → ``hybrid`` (matmul x-side projections + the recurrence kernel:
  dense for dense and singular models, the folded two-step for reduced).
  On the TPU the JAX package sent the wide dense model in exact mode to its
  XLA scan, because the f32-forced 3-pass MXU emulation made its kernel
  slower there. That reason does not hold on the H100, whose CUDA cores run
  f32 natively, so the wide dense model takes its kernel here as well.
* Batched ``(B, T, d)`` input runs the plain scan, as the JAX package ran
  its XLA scan there.

``impl="scan"`` keeps the plain loop reachable for any input.

Exact mode is set per call: inside :func:`predict`, TF32 is off and the
float32 matmul precision is "highest"; both settings are restored on exit.
Nothing is set at import.
"""

from __future__ import annotations

import contextlib

import torch

from svd_lstm_tpu_torch.factor.svd import singular_to_dense
from svd_lstm_tpu_torch.models.lstm import StackedLSTM, stacked_lstm_apply
from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
from svd_lstm_tpu_torch.models.singular import SingularLSTM, singular_lstm_apply
from svd_lstm_tpu_torch.ops import cuda_lstm, layouts

IMPLS = ("auto", "scan", "fused", "hybrid")
PRECISION_MODES = ("exact", "high", "fast")
_FUSED_MAX_UNITS = 128


def model_input_dim(model) -> int:
    """Frame width the model consumes: layer 0's ``input_dim``."""
    return int(model.layers[0].input_dim)


def _max_units(model) -> int:
    return max(l.units for l in model.layers)


def valid_impls(model, x) -> list:
    """Implementations with distinct execution paths for this (model,
    input): batched input has only the scan; batch-1 input has the scan,
    the hybrid and, where every layer n ≤ 128, the fused kernel."""
    if x.ndim == 3:
        return ["scan"]
    cands = ["scan", "hybrid"]
    if _max_units(model) <= _FUSED_MAX_UNITS:
        cands.insert(1, "fused")
    return cands


@contextlib.contextmanager
def exact_matmul():
    """float32 matmuls in full float32 (TF32 off, precision "highest") for
    the duration of the block; the previous settings are restored after."""
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def predict(model, x: torch.Tensor, impl: str = "auto", precision: str = "exact"):
    """Whole-run inference. x: (T, d) for batch-1 or (B, T, d) batched.
    Returns (T, out) / (B, T, out). impl: 'auto' | 'scan' | 'fused' |
    'hybrid' (see the module docstring for the routing)."""
    if precision not in PRECISION_MODES:
        raise ValueError(f"unknown precision: {precision!r}")
    if precision != "exact":
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP queue 1, item 5: "
            "batched inference and precision modes); use precision='exact'"
        )
    if impl not in IMPLS:
        # a typo'd impl must not silently route to the slow exact scan
        raise ValueError(
            f"unknown impl {impl!r}; expected 'auto' | 'scan' | 'fused' | 'hybrid'"
        )
    if not isinstance(model, (StackedLSTM, SingularLSTM, ReducedLSTM)):
        raise TypeError(f"unknown model params: {type(model)}")
    batched = x.ndim == 3
    if batched and impl in ("fused", "hybrid"):
        raise ValueError(
            f"impl={impl!r} kernels are batch-1 only; use impl='auto' or "
            "impl='scan' for (B, T, d) input"
        )
    if impl == "fused" and _max_units(model) > _FUSED_MAX_UNITS:
        # an explicit impl request must not silently run another path
        raise ValueError(
            f"impl='fused' requires every layer n <= 128 (got "
            f"{_max_units(model)}); use impl='hybrid' (wide-model kernel) "
            "or impl='auto'"
        )
    with exact_matmul(), torch.no_grad():
        return _dispatch(model, x, impl, batched)


def _dispatch(model, x, impl: str, batched: bool):
    if impl == "auto":
        if batched or x.device.type != "cuda":
            impl = "scan"
        else:
            impl = "fused" if _max_units(model) <= _FUSED_MAX_UNITS else "hybrid"

    if impl == "scan":
        xb = x if batched else x[None]
        if isinstance(model, StackedLSTM):
            out = stacked_lstm_apply(model, xb)
        elif isinstance(model, SingularLSTM):
            out = singular_lstm_apply(model, xb)
        else:
            out = layouts.reduced_forward_dense_recurrent(model, xb)
        return out if batched else out[0]

    if impl == "fused":
        if isinstance(model, StackedLSTM):
            return cuda_lstm.fused_dense_stack(model, x)
        if isinstance(model, SingularLSTM):
            return layouts.singular_forward_fused(model, x)
        return layouts.reduced_forward_fused(model, x)

    # hybrid
    if isinstance(model, StackedLSTM):
        return cuda_lstm.dense_forward_hybrid(model, x)
    if isinstance(model, SingularLSTM):
        return cuda_lstm.dense_forward_hybrid(singular_to_dense(model), x)
    return cuda_lstm.reduced_forward_hybrid(model, x)
