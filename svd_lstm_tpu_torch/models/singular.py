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

from svd_lstm_tpu_torch.models.lstm import (
    DenseHead,
    layer_masks,
    run_recurrence,
)
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


def _masked_input_projection(p: SingularLayer, x_seq: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """The input three-step product with dropout masks on the inputs, over
    (B, ..., d) batch-major input. The merged layer multiplies the inputs by
    one mask, ``dp[0]`` (as the reference's merged cell does); the split
    layer masks each gate's input."""
    if p.split:
        m = dp.permute(1, 0, 2).reshape(dp.shape[1], *([1] * (x_seq.ndim - 2)), *dp.shape[::2])
        xg = einsum("...gd,gdk->...gk", x_seq.unsqueeze(-2) * m, p.wl) * p.ws
        xp = einsum("...gk,gkn->...gn", xg, p.wr)
        return xp.reshape(*xp.shape[:-2], -1) + p.b
    m = dp[0].reshape(dp.shape[1], *([1] * (x_seq.ndim - 2)), dp.shape[2])
    return _three_step_merged(x_seq * m, p.wl, p.ws, p.wr) + p.b


def _masked_recurrent_product(p: SingularLayer, h: torch.Tensor, rdp: torch.Tensor) -> torch.Tensor:
    """The recurrent three-step product with recurrent-dropout masks on
    h(t−1): one mask merged, one a gate split."""
    if p.split:
        hm = h.unsqueeze(1) * rdp.permute(1, 0, 2)  # (B, 4, n)
        hg = einsum("bgn,gnk->bgk", hm, p.ul) * p.us
        z = einsum("bgk,gkn->bgn", hg, p.ur)
        return z.reshape(*z.shape[:-2], -1)
    return _three_step_merged(h * rdp[0], p.ul, p.us, p.ur)


def singular_layer_apply(
    p: SingularLayer,
    x_seq: torch.Tensor,
    h0=None,
    c0=None,
    return_state: bool = False,
    dropout: float = 0.0,
    recurrent_dropout: float = 0.0,
    rng=None,
    remat_chunk: int = 0,
):
    """x_seq: (batch, T, d) -> (batch, T, units). Dropout masks (one a gate
    split, one merged) come from ``rng`` as in
    :func:`svd_lstm_tpu_torch.models.lstm.layer_masks`; ``0 < remat_chunk
    < T`` recomputes each chunk's three-step input product and steps in the
    backward pass, as the dense layer does."""
    B, _, d = x_seq.shape
    count = 4 if p.split else 1
    dp, rdp = layer_masks(rng, dropout, recurrent_dropout, count, B, d, p.units, x_seq.dtype,
                          x_seq.device)

    def make_xp(x):
        if dp is None:
            return singular_input_projection(p, x)
        return _masked_input_projection(p, x, dp)

    if rdp is None:
        rec = lambda h: singular_recurrent_product(p, h)  # noqa: E731
    else:
        rec = lambda h: _masked_recurrent_product(p, h, rdp)  # noqa: E731
    h_seq, state = run_recurrence(make_xp, rec, x_seq, h0, c0, remat_chunk)
    return (h_seq, state) if return_state else h_seq


def singular_lstm_apply(
    model: SingularLSTM,
    x_seq: torch.Tensor,
    return_sequences: bool = True,
    dropout: float = 0.0,
    recurrent_dropout: float = 0.0,
    rng=None,
    remat_chunk: int = 0,
) -> torch.Tensor:
    """The factorized stack and its head. ``rng``: one generator from which
    every layer draws its masks in layer order (the JAX package splits its
    key once a layer), or one explicit ``(dp, rdp)`` pair a layer."""
    if (dropout > 0.0 or recurrent_dropout > 0.0) and rng is None:
        raise ValueError("dropout requires an rng (a torch.Generator or explicit masks)")
    sources = [rng] * len(model.layers) if rng is None or isinstance(rng, torch.Generator) else list(rng)
    if len(sources) != len(model.layers):
        raise ValueError(f"{len(sources)} mask pairs for {len(model.layers)} layers")
    h = x_seq
    for layer, src in zip(model.layers, sources):
        h = singular_layer_apply(layer, h, dropout=dropout, recurrent_dropout=recurrent_dropout,
                                 rng=src, remat_chunk=remat_chunk)
    if not return_sequences:
        h = h[:, -1]
    return model.head(h)
