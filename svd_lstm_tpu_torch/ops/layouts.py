"""Execution layouts for singular and reduced models.

Counterpart of ``svd_lstm_tpu/ops/layouts.py``. A reduced model's stored
form (the exact two-step (B, C) pairs) is independent of the layout it runs
in. At n ≤ 128 the per-step chain is latency-bound, so the batch-1 path
reconstructs the exact dense weights (``U_rec = B @ [I|C]``) and runs them
through the fused dense-stack kernel: one matrix-vector product per step in
place of two dependent ones.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.factor.svd import singular_to_dense
from svd_lstm_tpu_torch.models.lstm import LSTMLayer, StackedLSTM, scan_recurrence
from svd_lstm_tpu_torch.models.reduced import ReducedLSTM, reduced_projection
from svd_lstm_tpu_torch.ops.cuda_lstm import fused_dense_stack
from svd_lstm_tpu_torch.utils.linalg import fold_IC


def _two_step_dense(Bs, Cs, split: bool) -> torch.Tensor:
    if split:
        return torch.cat([torch.matmul(B, fold_IC(B, C)) for B, C in zip(Bs, Cs)], dim=1)
    return torch.matmul(Bs, fold_IC(Bs, Cs))


def reconstruct_recurrent_dense(layer) -> torch.Tensor:
    """(n, 4n) dense recurrent kernel from (B, C) pairs — exact."""
    return _two_step_dense(layer.uB, layer.uC, layer.split)


@torch.no_grad()
def reconstruct_dense_model(model: ReducedLSTM) -> StackedLSTM:
    """Exact dense model from a reduced one (both sides reconstructed) — an
    execution layout only; the compressed form stays the stored one."""
    layers = [
        LSTMLayer(
            W=_two_step_dense(l.wB, l.wC, l.split),
            U=reconstruct_recurrent_dense(l),
            b=l.b.detach().clone(),
        )
        for l in model.layers
    ]
    return StackedLSTM(layers, model.head)


def singular_forward_fused(smodel, x: torch.Tensor) -> torch.Tensor:
    """Batch-1 evaluation of a (full-rank) singular model: exact dense
    collapse W = (U·Σ)·Vᵀ through the fused kernel. x: (T, d)."""
    return fused_dense_stack(singular_to_dense(smodel), x)


def reduced_forward_fused(model: ReducedLSTM, x: torch.Tensor) -> torch.Tensor:
    """Batch-1 evaluation of a reduced model: exact dense reconstruction
    through the fused kernel. x: (T, d) -> (T, head_dim)."""
    return fused_dense_stack(reconstruct_dense_model(model), x)


@torch.no_grad()
def reduced_forward_dense_recurrent(
    model: ReducedLSTM, x_seq: torch.Tensor, return_sequences: bool = True
) -> torch.Tensor:
    """Reduced-model forward with a factored x-side and a dense-reconstructed
    h-side, as a plain time loop. x_seq: (B, T, d)."""
    h = x_seq
    for layer in model.layers:
        xp = reduced_projection(layer, h, "w") + layer.b
        U = reconstruct_recurrent_dense(layer)
        h = scan_recurrence(xp, lambda hh: torch.matmul(hh, U), None, None)[0]
    if not return_sequences:
        h = h[:, -1]
    return model.head(h)
