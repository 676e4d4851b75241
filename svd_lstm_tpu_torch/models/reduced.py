"""Rank-truncated ("reduced") LSTM layer — the exact two-step cell.

Counterpart of ``svd_lstm_tpu/models/reduced.py``. After dropping singular
values, each rank-r factor triple is the exact two-step product

    B = (U·Σ) @ V₁          (m × r)
    C = V₁⁻¹ @ V₂           (r × (n − r))
    x @ W  ==  concat(x @ B, (x @ B) @ C)

* merged kernel: one (B, C) pair for the whole (d × 4n) kernel and one for
  the (n × 4n) recurrent kernel;
* split kernel: per-gate (B, C) pairs with per-gate ranks, held in
  ``nn.ParameterList``s of 4 because the ranks differ.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from svd_lstm_tpu_torch.models.lstm import DenseHead, scan_recurrence
from svd_lstm_tpu_torch.utils.linalg import fold_IC


def _factor(v):
    """A merged factor stays one Parameter; a split side's 4 factors
    become a ParameterList in gate order [i, f, c, o]."""
    if isinstance(v, torch.Tensor):
        return nn.Parameter(v)
    return nn.ParameterList(list(v))


class ReducedLayer(nn.Module):
    # merged: wB (d, rw), wC (rw, 4n-rw) — single tensors
    # split:  4 tensors each, gate order [i, f, c, o]:
    #         wB[g] (d, r_g), wC[g] (r_g, n - r_g)
    def __init__(self, wB, wC, uB, uC, b: torch.Tensor):
        super().__init__()
        self.wB = _factor(wB)
        self.wC = _factor(wC)
        self.uB = _factor(uB)
        self.uC = _factor(uC)
        self.b = nn.Parameter(b)  # (4n,)

    @property
    def split(self) -> bool:
        return isinstance(self.wB, nn.ParameterList)

    @property
    def units(self) -> int:
        return (self.uB[0] if self.split else self.uB).shape[0]

    @property
    def input_dim(self) -> int:
        return (self.wB[0] if self.split else self.wB).shape[0]

    @property
    def ranks(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(input-side ranks, recurrent-side ranks): one per gate when
        split, a single rank when merged."""
        w = tuple(B.shape[1] for B in self.wB) if self.split else (self.wB.shape[1],)
        u = tuple(B.shape[1] for B in self.uB) if self.split else (self.uB.shape[1],)
        return w, u

    def weight_count(self) -> int:
        """Stored-weight count — the metric the reference reports."""
        return int(sum(p.numel() for p in self.parameters()))


class ReducedLSTM(nn.Module):
    def __init__(self, layers: Sequence[ReducedLayer], head: DenseHead):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.head = head

    def forward(self, x_seq: torch.Tensor, return_sequences: bool = True) -> torch.Tensor:
        return reduced_lstm_apply(self, x_seq, return_sequences)


def two_step(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """concat(x @ B, (x @ B) @ C) along the last axis — exact low-rank apply."""
    xb = torch.matmul(x, B)
    return torch.cat([xb, torch.matmul(xb, C)], dim=-1)


def pack_split_projection(Bs, Cs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-pad and stack a split side's per-gate factors for the batched
    two-einsum form: (Bp (4, d, rmax), ICp (4, rmax, n)). Zero pad
    columns/rows keep the product exact."""
    rmax = max(B.shape[1] for B in Bs)
    Bp = torch.stack([F.pad(B, (0, rmax - B.shape[1])) for B in Bs])
    ICp = torch.stack(
        [F.pad(fold_IC(B, C), (0, 0, 0, rmax - B.shape[1])) for B, C in zip(Bs, Cs)]
    )
    return Bp, ICp


def apply_split_projection(x, Bp, ICp) -> torch.Tensor:
    """The batched split two-step: per gate (x @ B) @ [I|C], all four gates
    in two einsums, gate blocks concatenated -> (..., 4n)."""
    xb = torch.einsum("...d,gdr->...gr", x, Bp)
    z = torch.einsum("...gr,grn->...gn", xb, ICp)
    return z.reshape(*z.shape[:-2], -1)


def reduced_projection(p: ReducedLayer, x, which: str) -> torch.Tensor:
    """Two-step product for input ('w') or recurrent ('u') side -> (..., 4n),
    in the folded form ``(x @ B) @ [I|C]`` (identical values, no concat)."""
    Bs = p.wB if which == "w" else p.uB
    Cs = p.wC if which == "w" else p.uC
    if p.split:
        return apply_split_projection(x, *pack_split_projection(Bs, Cs))
    return torch.matmul(torch.matmul(x, Bs), fold_IC(Bs, Cs))


def reduced_layer_apply(p: ReducedLayer, x_seq, h0=None, c0=None, return_state=False):
    """x_seq: (batch, T, d) -> (batch, T, units)."""
    xp = reduced_projection(p, x_seq, "w") + p.b
    if p.split:
        Bp, ICp = pack_split_projection(p.uB, p.uC)
        rec = lambda h: apply_split_projection(h, Bp, ICp)
    else:
        IC = fold_IC(p.uB, p.uC)
        rec = lambda h: torch.matmul(torch.matmul(h, p.uB), IC)
    h_seq, state = scan_recurrence(xp, rec, h0, c0)
    return (h_seq, state) if return_state else h_seq


def reduced_lstm_apply(
    model: ReducedLSTM, x_seq: torch.Tensor, return_sequences: bool = True
) -> torch.Tensor:
    h = x_seq
    for layer in model.layers:
        h = reduced_layer_apply(layer, h)
    if not return_sequences:
        h = h[:, -1]
    return model.head(h)
