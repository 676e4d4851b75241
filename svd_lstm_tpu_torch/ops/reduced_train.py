"""Kernel training path for the truncated (reduced) model: post-truncation
recovery.

Counterpart of ``svd_lstm_tpu/ops/reduced_train.py``. A reduced layer's
two-step factors give the dense view

    W~ = B · [I | C] = [ B | B·C ]        (the column order of V = [V₁ V₂]),

which is bilinear in (B, C). So the recovery fine-tune reconstructs the
dense weights inside the step and runs them through the dense training
dispatch (``ops/cuda_train.stacked_lstm_apply_fast_train``, with
``compact="auto"``: K8 for narrow stacks at B ≥ 128, K7 below, K9 for
uniform wide stacks), as the singular fine-tune does
(``ops/singular_train.py``). The kernels' backward gives dW/dU/db, and torch
autograd of the reconstruction carries them on to the factors:

    dB = dW₁ + dW₂·Cᵀ ,   dC = Bᵀ·dW₂      (dW = [dW₁ | dW₂]).

Training B and C keeps the two-step parameterization, so the recovered model
runs through the same reduced inference paths unchanged. The reconstruction
runs in float32 with TF32 off, forward and backward, in every training
regime (``utils.precision.exact_products``), the counterpart of the JAX
view's HIGHEST-precision reconstruction; ``bf16`` picks the kernels'
bf16-operand variants.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
from svd_lstm_tpu_torch.ops.cuda_train import DenseView, LayerView, stacked_lstm_apply_fast_train
from svd_lstm_tpu_torch.ops.layouts import _two_step_dense
from svd_lstm_tpu_torch.utils.precision import exact_products


def _exact_two_step_dense(Bs, Cs, split: bool) -> torch.Tensor:
    """``_two_step_dense`` with its products exact in every regime."""
    if not split:
        return exact_products(lambda B, C: _two_step_dense(B, C, False), Bs, Cs)
    k = len(Bs)
    return exact_products(lambda *f: _two_step_dense(f[:k], f[k:], True), *Bs, *Cs)


def reduced_dense_view(model: ReducedLSTM) -> DenseView:
    """Differentiable dense reconstruction of a reduced model: the values of
    ``ops.layouts.reconstruct_dense_model`` (the one source of the [B | B·C]
    column order, merged or per gate), but the tensors stay in the autograd
    graph of the factors."""
    layers = tuple(
        LayerView(
            W=_exact_two_step_dense(l.wB, l.wC, l.split),
            U=_exact_two_step_dense(l.uB, l.uC, l.split),
            b=l.b,
        )
        for l in model.layers
    )
    return DenseView(layers=layers, head=model.head)


def reduced_lstm_apply_fast_train(
    model: ReducedLSTM, x_seq: torch.Tensor, return_sequences: bool = True, bf16: bool = False
) -> torch.Tensor:
    """Drop-in training apply for the recovery fine-tune through the dense
    train kernels (their bf16-operand variants with ``bf16``). x_seq (B, T,
    d) -> (B, T, out) / (B, out)."""
    return stacked_lstm_apply_fast_train(reduced_dense_view(model), x_seq, return_sequences,
                                         bf16=bf16)
