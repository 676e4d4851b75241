"""Execution layouts for singular and reduced models.

Counterpart of ``svd_lstm_tpu/ops/layouts.py``. A reduced model's stored
form (the exact two-step (B, C) pairs) is independent of the layout it runs
in. At n ≤ 128 the per-step chain is latency-bound, so the batch-1 path
reconstructs the exact dense weights (``U_rec = B @ [I|C]``) and runs them
through the fused dense-stack kernel: one matrix-vector product per step in
place of two dependent ones. The reconstruction is cached per model
(:func:`cached_dense`), so a repeated ``predict`` pays it once.
"""

from __future__ import annotations

import weakref

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


# model -> (the key of its parameters, its dense reconstruction); held
# outside the model (an attribute would register a submodule and change its
# state_dict() and parameters()), dropped with the model
_DENSE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _parameters_key(model) -> tuple:
    """Each parameter's identity, version counter (bumped by every in-place
    update: an optimizer step, ``mul_``), storage, dtype, device and shape:
    equal keys mean the same values."""
    return tuple((id(p), p._version, p.data_ptr(), p.dtype, p.device, tuple(p.shape))
                 for p in model.parameters())


def cached_dense(model, build) -> StackedLSTM:
    """``build(model)``, the model's exact dense reconstruction, built once
    and reused while no parameter of the model is replaced or updated in
    place (:func:`_parameters_key`). The reconstruction is exact float32 in
    every precision mode, so exact and fast calls share it; a cached one
    gives the outputs of a fresh one bit for bit."""
    key = _parameters_key(model)
    hit = _DENSE_CACHE.get(model)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        dense = build(model)
    _DENSE_CACHE[model] = (key, dense)
    return dense


def singular_forward_fused(smodel, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Batch-1 evaluation of a (full-rank) singular model: exact dense
    collapse W = (U·Σ)·Vᵀ (cached) through the fused kernel, in the kernel's
    ``dot_precision`` (the collapse itself stays exact). x: (T, d)."""
    return fused_dense_stack(cached_dense(smodel, singular_to_dense), x, dot_precision=dot_precision)


def reduced_forward_fused(model: ReducedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Batch-1 evaluation of a reduced model: exact dense reconstruction
    (cached) through the fused kernel, in the kernel's ``dot_precision``.
    x: (T, d) -> (T, head_dim)."""
    return fused_dense_stack(cached_dense(model, reconstruct_dense_model), x,
                             dot_precision=dot_precision)


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
