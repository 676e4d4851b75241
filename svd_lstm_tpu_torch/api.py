"""High-level inference API: ``predict(model, x)``.

Counterpart of ``svd_lstm_tpu/api.py``.

Routing (``impl="auto"``):

* Batch-1 ``(T, d)`` CUDA input in exact mode takes the kernels in
  ``ops/cuda_lstm.py``: every layer n ≤ 128 → ``fused`` (the whole stack in
  one kernel; singular and reduced models after their exact dense
  reconstruction), anything wider → ``hybrid`` (matmul x-side projections +
  the recurrence kernel: dense for dense and singular models, the folded
  two-step for reduced). On the TPU the JAX package sent the wide dense
  model in exact mode to its XLA scan, because the f32-forced 3-pass MXU
  emulation made its kernel slower there. That reason does not hold on the
  H100, whose CUDA cores run f32 natively, so the wide dense model takes its
  kernel here as well. CPU tensors in exact mode take the ``scan`` time
  loops of ``models/*``.
* Batch-1 input in ``"fast"`` mode follows ``svd_lstm_tpu/api.py:212-290``
  with ``dot_precision="default"`` (the kernels' bf16-operand variants):

  ========  ===========================  =====================  ======================
  family    n ≤ 128 (auto, fused)        n ≥ 256, or hybrid     128 < n < 256 (auto)
  ========  ===========================  =====================  ======================
  dense     K1                           dense hybrid (K3)      dense hybrid (K3)
  singular  K1 on the dense collapse     dense hybrid (K3) on   as n ≥ 256
                                         the dense collapse
  reduced   K1 on the reconstruction     reduced hybrid (K2)    dense hybrid (K3) of
                                                                the reconstruction
  ========  ===========================  =====================  ======================

  on either device: CPU tensors run the same route through the kernels'
  plain fast versions, so one mode has one meaning on both.
* Batched ``(B, T, d)`` input runs the plain scan in ``"exact"`` and
  ``"high"``; in ``"fast"`` it runs ``ops/cuda_batched.batched_forward_fast``
  (bf16 x-side products, the K5 recurrence per layer) on the exact dense
  reconstruction of the model.

``impl="scan"`` keeps the exact float32 plain loop reachable for any input
and any precision.

Conv hybrids (``models/conv.py``) peel their front end first: the causal
conv and relu run on the model's device in the exact scope (TF32 off for
cuDNN too), and the stack then takes the routes above on the conv's output,
as a bare stack would, with the same ``impl`` and ``precision``.

Precision modes (``utils/precision.py``), set per call and restored on exit;
nothing is set at import:

* ``"exact"``: TF32 off, float32 matmul precision "highest";
* ``"high"``: batched input runs the scan with TF32 on; batch-1 input runs
  the exact path, as in the JAX package;
* ``"fast"``: its bf16 products are explicit (bf16-rounded operands, or bf16
  tensors in the batched path); the rest (the dense reconstruction, the
  head, the float32 products of rounded operands) runs with TF32 off.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.bench.autotune import cached_impl
from svd_lstm_tpu_torch.factor.svd import singular_to_dense
from svd_lstm_tpu_torch.models.conv import CONV_TYPES, conv_front, inner_stack
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
_REDUCED_HYBRID_MIN_UNITS = 256  # batch-1 fast: narrower reduced models run dense


def model_input_dim(model) -> int:
    """Frame width the model consumes: the conv front end's channel count
    for the conv hybrids, else layer 0's ``input_dim``."""
    if isinstance(model, CONV_TYPES):
        return int(model.conv.in_channels)
    return int(model.layers[0].input_dim)


def _max_units(model) -> int:
    return max(l.units for l in model.layers)


def valid_impls(model, x, precision: str = "exact") -> list:
    """Implementations with distinct execution paths for this (model,
    input, precision): batched input has the scan and, in fast mode on the
    card, 'auto' (the K5 path); batch-1 input has the scan, the hybrid and,
    where every layer n ≤ 128, the fused kernel. Conv hybrids route on
    their stack."""
    model = inner_stack(model)
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


def predict(model, x: torch.Tensor, impl: str = "auto", precision: str = "exact",
            consult_cache: bool = True):
    """Whole-run inference on the device of ``model`` and ``x``. x: (T, d)
    for batch-1 or (B, T, d) batched. Returns (T, out) / (B, T, out).
    impl: 'auto' | 'scan' | 'fused' | 'hybrid'; precision: 'exact' |
    'high' | 'fast' (see the module docstring for the routing).

    'fast' with impl='auto' runs the kernels' bf16-operand variants on a
    CUDA input and their plain versions on a CPU input: one mode has one
    meaning on both devices (the JAX package's off-TPU fallbacks, the exact
    scan for batch-1 and an all-bf16 scan for batched input, are not
    carried over). impl='scan' is the exact float32 loop in every mode.

    impl='auto' first consults the autotune cache
    (``bench.autotune.cached_impl``, keyed by the card's name): where this
    (model shape, input shape, precision) was measured on this device (the
    ``tune`` command, ``tuned_impl``), the measured winner runs in place of
    the table above. A winner no longer in ``valid_impls`` is ignored, and
    with no cache entry the routing is the table's. ``consult_cache=False``
    skips the lookup (``autotune`` measures with it off)."""
    if precision not in PRECISION_MODES:
        raise ValueError(f"unknown precision: {precision!r}")
    if impl not in IMPLS:
        # a typo'd impl must not silently route to the slow exact scan
        raise ValueError(
            f"unknown impl {impl!r}; expected 'auto' | 'scan' | 'fused' | 'hybrid'"
        )
    if not isinstance(model, (StackedLSTM, SingularLSTM, ReducedLSTM, *CONV_TYPES)):
        raise TypeError(f"unknown model params: {type(model)}")
    if impl == "auto" and consult_cache:
        hit = cached_impl(model, x, precision)
        # 'auto' as the winner means the table's route is the measured best
        if hit is not None and hit != "auto" and hit in valid_impls(model, x, precision):
            impl = hit
    batched = x.ndim == 3
    if isinstance(model, CONV_TYPES):
        # the front end first, exact, then the stack's own dispatch
        with matmul_scope("exact"), torch.no_grad():
            h = conv_front(model.conv, x if batched else x[None])
        return predict(inner_stack(model), h if batched else h[0], impl=impl,
                       precision=precision, consult_cache=consult_cache)
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
    # only batched 'high' runs with TF32: batch-1 'high' is the exact path, as
    # in JAX, and fast mode's bf16 products are explicit (the rest is exact)
    scope = "high" if batched and precision == "high" else "exact"
    # batch-1 fast: the kernels' bf16-operand variants (JAX api.py:219)
    dp = "default" if precision == "fast" and not batched else None
    with matmul_scope(scope), torch.no_grad():
        if precision == "fast" and batched and impl == "auto":
            return cuda_batched.batched_forward_fast(_dense(model), x)
        return _dispatch(model, x, impl, batched, dp)


def _dispatch(model, x, impl: str, batched: bool, dp=None):
    """Run the resolved impl; ``dp`` is the batch-1 kernels' dot_precision
    (None: exact, "default": fast)."""
    auto = impl == "auto"
    if auto:
        if batched or (x.device.type != "cuda" and dp is None):
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
            return cuda_lstm.fused_dense_stack(model, x, dot_precision=dp)
        if isinstance(model, SingularLSTM):
            return layouts.singular_forward_fused(model, x, dot_precision=dp)
        return layouts.reduced_forward_fused(model, x, dot_precision=dp)

    # hybrid
    if isinstance(model, StackedLSTM):
        return cuda_lstm.dense_forward_hybrid(model, x, dot_precision=dp)
    if isinstance(model, SingularLSTM):
        return cuda_lstm.dense_forward_hybrid(singular_to_dense(model), x, dot_precision=dp)
    if auto and dp is not None and _max_units(model) < _REDUCED_HYBRID_MIN_UNITS:
        # mid-width (128 < n < 256) fast mode: the exact dense reconstruction
        # through the dense hybrid, as JAX api.py:280-290
        return cuda_lstm.dense_forward_hybrid(
            layouts.reconstruct_dense_model(model), x, dot_precision=dp
        )
    return cuda_lstm.reduced_forward_hybrid(model, x, dot_precision=dp)
