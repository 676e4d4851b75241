"""Named inference precision modes.

Counterpart of ``svd_lstm_tpu/utils/precision.py``. On the H100:

* ``"exact"``: float32 matmuls in full float32 (TF32 off, float32 matmul
  precision "highest"), the analogue of the JAX package's
  ``jax_default_matmul_precision=float32``. cuDNN's TF32 switch
  (``torch.backends.cudnn.allow_tf32``, on by default) is turned off too,
  so a convolution in the scope (the conv hybrids' front end) runs in full
  float32 as well;
* ``"high"``: TF32 on for float32 matmuls (precision "high") and for cuDNN's
  convolutions, the card's
  nearest counterpart of JAX's ``default_matmul_precision("tensorfloat32")``.
  On the TPU that was 3-pass bf16 (relative error ~1e-4); TF32 keeps 10
  mantissa bits, so it is coarser (its error against exact is measured by
  ``chip_smoke.py`` and recorded in PERF.md);
* ``"fast"``: a no-op scope. Fast mode gets its speed from bf16 operands
  (``ops/cuda_batched.py``), not from a global setting.

Training has its own scope, :func:`train_matmul_scope`, for the JAX
package's ``TrainConfig.matmul_precision`` (the ``jax.default_matmul_precision``
that its ``fit`` wraps the loss in):

* ``"float32"``: every product exact (TF32 off);
* ``"tensorfloat32"``: the ``"high"`` mode above over the whole block, so
  every float32 product of the step, forward and backward, runs in TF32 as
  a native product, as every unpinned dot of the JAX step does;
* ``"bfloat16"``: the products of the train step that go through :func:`dot`
  or :func:`einsum` (the scans, the σ and two-step applies, the head, the
  orthogonality penalty) run as the TPU's ``Precision.DEFAULT``: both
  operands rounded to bf16 (round to nearest even), the products exact and
  summed in float32, the result float32 and not rounded. The backward's
  products are DEFAULT products too: the cotangent and the other operand
  are rounded before each one (:class:`_Bf16Product`). ``torch.autocast``
  (which rounds the result) and float32 matmul precision "medium" (no
  promise of bf16 on the card) would be other numerics. Everything else
  runs exact.

The dense-view reconstruction of the σ fine-tune and of the recovery goes
through :func:`exact_products`, exact forward and backward in every regime,
as the JAX package runs it at HIGHEST. Every scope restores the previous
settings on exit. Nothing is set at import.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import functools

import torch

from svd_lstm_tpu_torch.config import TRAIN_PRECISIONS

PRECISION_MODES = ("exact", "high", "fast")
_FLOAT32_PRECISION = {"exact": "highest", "high": "high"}
# the regime of the train step's products; "float32": plain products under
# the caller's settings
_TRAIN_PRECISION = contextvars.ContextVar("svd_lstm_tpu_torch_train_precision", default="float32")


@contextlib.contextmanager
def _float32_matmul(mode: str):
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = mode == "high"
    torch.backends.cudnn.allow_tf32 = mode == "high"
    torch.set_float32_matmul_precision(_FLOAT32_PRECISION[mode])
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(prec)
        # set the TF32 switch only where the precision did not restore it: a
        # needless set mixes torch's two APIs and makes the precision unreadable
        if torch.backends.cuda.matmul.allow_tf32 != allow_tf32:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def matmul_scope(precision: str):
    """Context manager selecting the float32 matmul mode of a named
    precision mode: 'exact' TF32 off, 'high' TF32 on (matmuls and cuDNN's
    convolutions alike), 'fast' untouched."""
    if precision not in PRECISION_MODES:
        raise ValueError(f"unknown precision: {precision!r}")
    if precision == "fast":
        return contextlib.nullcontext()
    return _float32_matmul(precision)


def exact_matmul():
    """float32 matmuls and convolutions in full float32 (TF32 off for both,
    precision "highest") for the duration of the block; the previous
    settings are restored after."""
    return matmul_scope("exact")


def cast_params(model: torch.nn.Module, dtype=torch.bfloat16) -> torch.nn.Module:
    """A copy of ``model`` with every floating parameter cast to ``dtype``;
    the model itself is left as it is."""
    return copy.deepcopy(model).to(dtype)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even) and kept in its dtype:
    the operand of a product in fast mode."""
    return t.to(torch.bfloat16).to(t.dtype)


@contextlib.contextmanager
def train_matmul_scope(matmul_precision: str):
    """The train step's products in ``matmul_precision`` ("float32",
    "tensorfloat32" or "bfloat16", see the module docstring) for the
    duration of the block: TF32 on in "tensorfloat32", off otherwise; the
    previous settings are restored after. Wraps the forward and the
    backward."""
    if matmul_precision not in TRAIN_PRECISIONS:
        raise ValueError(
            f"unknown matmul_precision {matmul_precision!r}; expected one of {TRAIN_PRECISIONS}"
        )
    token = _TRAIN_PRECISION.set(matmul_precision)
    try:
        with matmul_scope("high" if matmul_precision == "tensorfloat32" else "exact"):
            yield
    finally:
        _TRAIN_PRECISION.reset(token)


def _vjp(fn, args, needs, g):
    """The cotangents of ``fn(*args)`` for the arguments flagged in
    ``needs`` (None for the others), taken by autograd."""
    xs = [a.detach().requires_grad_(n) for a, n in zip(args, needs)]
    wrt = [x for x in xs if x.requires_grad]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(fn(*xs), wrt, g)) if wrt else iter(())
    return tuple(next(grads) if n else None for n in needs)


class _Bf16Product(torch.autograd.Function):
    """``fn(a, b)`` for a function ``fn`` linear in each argument (a matmul,
    an einsum) as the TPU's DEFAULT dot: ``a`` and ``b`` rounded to bf16
    before the product, and the cotangent rounded before each product of
    the backward (with the rounded other operand), as the VJP of a DEFAULT
    dot is DEFAULT dots. The backward's products are ``fn``'s own VJP,
    taken by autograd on the saved (rounded) operands. A product of bf16
    values is exact in float32 and TF32 alike, so no setting is needed."""

    @staticmethod
    def forward(ctx, fn, a, b):
        a, b = bf16_round(a), bf16_round(b)
        ctx.fn = fn
        ctx.save_for_backward(a, b)
        return fn(a, b)

    @staticmethod
    def backward(ctx, g):
        return None, *_vjp(ctx.fn, ctx.saved_tensors, ctx.needs_input_grad[1:], bf16_round(g))


class _ExactProducts(torch.autograd.Function):
    """``fn(*args)`` with TF32 off in the forward and in the backward (the
    VJP taken by autograd on the saved arguments)."""

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.save_for_backward(*args)
        with exact_matmul():
            return fn(*args)

    @staticmethod
    def backward(ctx, g):
        with exact_matmul():
            return None, *_vjp(ctx.fn, ctx.saved_tensors, ctx.needs_input_grad[1:], g)


def exact_products(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)`` with its products exact, forward and backward, in every
    training regime (the dense-view reconstructions, which the JAX package
    pins to HIGHEST). Only the "tensorfloat32" scope turns TF32 on, so
    elsewhere this is the plain ``fn(*args)``."""
    if _TRAIN_PRECISION.get() != "tensorfloat32":
        return fn(*args)
    return _ExactProducts.apply(fn, *args)


def product(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fn(a, b)`` (linear in each argument) in the regime of the innermost
    :func:`train_matmul_scope`: the DEFAULT dot in "bfloat16", else the
    plain ``fn(a, b)`` under the scope's settings (or the caller's, outside
    any)."""
    if _TRAIN_PRECISION.get() == "bfloat16":
        return _Bf16Product.apply(fn, a, b)
    return fn(a, b)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)`` in the training regime (:func:`product`)."""
    return product(torch.matmul, a, b)


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` in the training regime
    (:func:`product`)."""
    return product(functools.partial(torch.einsum, equation), a, b)
