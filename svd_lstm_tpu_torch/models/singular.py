"""SVD-factorized ("singular") LSTM layer as ``nn.Module``s.

Counterpart of ``svd_lstm_tpu/models/singular.py``. Each kernel is the
three-step product with the singular-value vector as the bottleneck:

* merged kernel: z = ((x @ w_left) * w_sigma) @ w_right from one SVD of the
  whole (d × 4n) matrix;
* split kernel: the same per gate, the four gates' factors stacked on a
  leading gate axis so the 4-gate product is two batched einsums.

The layout is read from ``wl.ndim`` (3 ⇒ split). The input product is hoisted
out of the time loop; only the hidden-state product runs inside it. The
products follow the training regime (``utils.precision.dot``, ``einsum``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from svd_lstm_tpu_torch.models.lstm import DenseHead, scan_recurrence
from svd_lstm_tpu_torch.utils.precision import dot, einsum


class SingularLayer(nn.Module):
    # merged: wl (d, d);    ws (d,);    wr (d, 4n)
    # split:  wl (4, d, k); ws (4, k);  wr (4, k, n)   with k = min(d, n)
    # merged: ul (n, n);    us (n,);    ur (n, 4n)
    # split:  ul (4, n, n); us (4, n);  ur (4, n, n)
    def __init__(self, wl, ws, wr, ul, us, ur, b):
        super().__init__()
        self.wl = nn.Parameter(wl)
        self.ws = nn.Parameter(ws)
        self.wr = nn.Parameter(wr)
        self.ul = nn.Parameter(ul)
        self.us = nn.Parameter(us)
        self.ur = nn.Parameter(ur)
        self.b = nn.Parameter(b)  # (4n,)

    @property
    def split(self) -> bool:
        return self.wl.ndim == 3

    @property
    def units(self) -> int:
        return self.ul.shape[-2]

    @property
    def input_dim(self) -> int:
        return self.wl.shape[1] if self.split else self.wl.shape[0]


class SingularLSTM(nn.Module):
    def __init__(self, layers: Sequence[SingularLayer], head: DenseHead):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.head = head

    def forward(self, x_seq: torch.Tensor, return_sequences: bool = True) -> torch.Tensor:
        return singular_lstm_apply(self, x_seq, return_sequences)


def _three_step_merged(x, left, sigma, right):
    """((x @ left) * sigma) @ right."""
    return dot(dot(x, left) * sigma, right)


def _three_step_split(x, left, sigma, right):
    """Per-gate three-step product, batched over the gate axis.

    x: (..., d); left: (4, d, k); sigma: (4, k); right: (4, k, n).
    Returns (..., 4n) with gate blocks ordered [i|f|c|o].
    """
    xg = einsum("...d,gdk->...gk", x, left) * sigma
    zg = einsum("...gk,gkn->...gn", xg, right)
    return zg.reshape(*zg.shape[:-2], -1)


def singular_input_projection(p: SingularLayer, x_seq: torch.Tensor) -> torch.Tensor:
    """Input product + bias over any leading dims: (..., d) -> (..., 4n)."""
    if p.split:
        return _three_step_split(x_seq, p.wl, p.ws, p.wr) + p.b
    return _three_step_merged(x_seq, p.wl, p.ws, p.wr) + p.b


def singular_recurrent_product(p: SingularLayer, h: torch.Tensor) -> torch.Tensor:
    if p.split:
        return _three_step_split(h, p.ul, p.us, p.ur)
    return _three_step_merged(h, p.ul, p.us, p.ur)


def singular_layer_apply(p: SingularLayer, x_seq, h0=None, c0=None, return_state=False):
    """x_seq: (batch, T, d) -> (batch, T, units)."""
    xp = singular_input_projection(p, x_seq)
    h_seq, state = scan_recurrence(xp, lambda h: singular_recurrent_product(p, h), h0, c0)
    return (h_seq, state) if return_state else h_seq


def singular_lstm_apply(
    model: SingularLSTM, x_seq: torch.Tensor, return_sequences: bool = True
) -> torch.Tensor:
    h = x_seq
    for layer in model.layers:
        h = singular_layer_apply(layer, h)
    if not return_sequences:
        h = h[:, -1]
    return model.head(h)
