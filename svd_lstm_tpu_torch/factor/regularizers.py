"""Regularizers for singular-value sparsification and factor orthogonality.

Counterpart of ``svd_lstm_tpu/factor/regularizers.py``, differentiable
through torch autograd:

* ``hoyer_penalty``: the Hoyer L1/L2 ratio with an epsilon in the
  denominator;
* ``trace_norm_penalty``: L1 on a σ vector, the trace norm of the
  factorized matrix;
* ``orthogonal_penalty``: Keras ``OrthogonalRegularizer`` semantics, half
  the mean absolute off-diagonal entry of the row-normalised Gram matrix.
  Split factors (leading gate axis) are penalised as the column-concatenated
  matrix, so rows normalise across all four gates jointly.
"""

from __future__ import annotations

import torch


def hoyer_penalty(x: torch.Tensor, coef: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """coef * Σ|x| / (Σx² + eps)."""
    x = x.reshape(-1)
    return coef * torch.sum(torch.abs(x)) / (torch.sum(torch.square(x)) + eps)


def trace_norm_penalty(x: torch.Tensor, coef: float = 1.0) -> torch.Tensor:
    """coef * Σ|x|."""
    return coef * torch.sum(torch.abs(x))


def orthogonal_penalty(
    m: torch.Tensor, factor: float = 1.0, mode: str = "rows", eps: float = 1e-12
) -> torch.Tensor:
    """factor * 0.5 * mean |offdiag| of the normalised Gram matrix.
    mode='rows': gram = normalize_rows(m) @ normalize_rows(m)ᵀ;
    mode='columns': the transpose convention."""
    if m.ndim == 3:
        g, a, b = m.shape
        m = m.permute(1, 0, 2).reshape(a, g * b)
    if mode == "columns":
        m = m.t()
    size = m.shape[0]
    if size < 2:
        # a single row has no off-diagonal pairs; 0/0 would turn the loss NaN.
        # Zero, with a zero gradient, as in the JAX package.
        return torch.sum(m * 0.0) * factor
    norm = torch.sqrt(torch.sum(torch.square(m), dim=1, keepdim=True) + eps)
    mn = m / norm
    gram = torch.matmul(mn, mn.t())
    off = torch.abs(gram - torch.diag(torch.diagonal(gram)))
    num_pairs = size * (size - 1.0) / 2.0
    return factor * 0.5 * torch.sum(off) / num_pairs
