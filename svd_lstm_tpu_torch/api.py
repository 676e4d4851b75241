"""High-level inference API: ``predict(model, x)``.

Counterpart of ``svd_lstm_tpu/api.py``.

Routing (``impl="auto"``):

* CPU tensors take the plain versions: the ``scan`` time loops of
  ``models/*``, and K5's plain version in batched fast mode.
* Batch-1 ``(T, d)`` CUDA input takes the kernels in ``ops/cuda_lstm.py``:
  every layer n ≤ 128 → ``fused`` (the whole stack in one kernel; singular
  and reduced models after their exact dense reconstruction), anything
  wider → ``hybrid`` (matmul x-side projections + the recurrence kernel:
  dense for dense and singular models, the folded two-step for reduced).
  On the TPU the JAX package sent the wide dense model in exact mode to its
  XLA scan, because the f32-forced 3-pass MXU emulation made its kernel
  slower there. That reason does not hold on the H100, whose CUDA cores run
  f32 natively, so the wide dense model takes its kernel here as well.
* Batched ``(B, T, d)`` input runs the plain scan in ``"exact"`` and
  ``"high"``; in ``"fast"`` it runs ``ops/cuda_batched.batched_forward_fast``
  (bf16 x-side products, the K5 recurrence per layer) on the exact dense
  reconstruction of the model.

``impl="scan"`` keeps the exact float32 plain loop reachable for any input
and any precision.

Precision modes (``utils/precision.py``), set per call and restored on exit;
nothing is set at import:

* ``"exact"``: TF32 off, float32 matmul precision "highest";
* ``"high"``: batched input runs the scan with TF32 on; batch-1 input runs
  the exact path, as in the JAX package;
* ``"fast"``: batched input only. Its bf16 products are explicit, the rest
  (the dense reconstruction, the head) runs in exact float32. Batch-1
  ``"fast"`` needs bf16-operand variants of K1–K3 and raises until then.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.factor.svd import singular_to_dense
from svd_lstm_tpu_torch.models.lstm import StackedLSTM, stacked_lstm_apply
from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
from svd_lstm_tpu_torch.models.singular import SingularLSTM, singular_lstm_apply
from svd_lstm_tpu_torch.ops import cuda_batched, cuda_lstm, layouts
from svd_lstm_tpu_torch.utils.precision import (  # exact_matmul: exported here
    PRECISION_MODES,
    exact_matmul,
    matmul_scope,
)

IMPLS = ("auto", "scan", "fused", "hybrid")
_FUSED_MAX_UNITS = 128


def model_input_dim(model) -> int:
    """Frame width the model consumes: layer 0's ``input_dim``."""
    return int(model.layers[0].input_dim)


def _max_units(model) -> int:
    return max(l.units for l in model.layers)


def valid_impls(model, x, precision: str = "exact") -> list:
    """Implementations with distinct execution paths for this (model,
    input, precision): batched input has the scan and, in fast mode on the
    card, 'auto' (the K5 path); batch-1 input has the scan, the hybrid and,
    where every layer n ≤ 128, the fused kernel."""
    if x.ndim == 3:
        if precision == "fast" and x.device.type == "cuda":
            return ["auto", "scan"]
        return ["scan"]
    cands = ["scan", "hybrid"]
    if _max_units(model) <= _FUSED_MAX_UNITS:
        cands.insert(1, "fused")
    return cands


def _dense(model) -> StackedLSTM:
    """The exact dense form of a model (float32), for the batched fast path."""
    if isinstance(model, ReducedLSTM):
        return layouts.reconstruct_dense_model(model)
    if isinstance(model, SingularLSTM):
        return singular_to_dense(model)
    return model


def predict(model, x: torch.Tensor, impl: str = "auto", precision: str = "exact"):
    """Whole-run inference on the device of ``model`` and ``x``. x: (T, d)
    for batch-1 or (B, T, d) batched. Returns (T, out) / (B, T, out).
    impl: 'auto' | 'scan' | 'fused' | 'hybrid'; precision: 'exact' |
    'high' | 'fast' (see the module docstring for the routing).

    Batched 'fast' with impl='auto' runs K5 on a CUDA input and K5's plain
    version on a CPU input: one mode has one meaning on both devices (the
    JAX package's off-TPU fallback to an all-bf16 scan is not carried
    over). impl='scan' is the exact float32 loop in every mode."""
    if precision not in PRECISION_MODES:
        raise ValueError(f"unknown precision: {precision!r}")
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
    if precision == "fast" and not batched:
        raise NotImplementedError(
            "batch-1 precision='fast' needs bf16-operand variants of the batch-1 "
            "kernels, not ported yet (ROADMAP queue 1, item 5); use precision='exact' "
            "or batched (B, T, d) input"
        )
    # only batched 'high' runs with TF32: batch-1 'high' is the exact path, as
    # in JAX, and fast mode's bf16 products are explicit (the rest is exact)
    scope = "high" if batched and precision == "high" else "exact"
    with matmul_scope(scope), torch.no_grad():
        if precision == "fast" and impl == "auto":
            return cuda_batched.batched_forward_fast(_dense(model), x)
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
