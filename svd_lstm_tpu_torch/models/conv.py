"""Causal-Conv1D + LSTM hybrid regressor as ``nn.Module``s.

Counterpart of ``svd_lstm_tpu/models/conv.py``: the reference's
convolutional experiment, Conv1D(filters=15, kernel_size=10,
padding='causal', relu) feeding two stacked 15-unit LSTMs and a
time-distributed Dense(1) head, and its compressed families (the conv front
end over a factorized or a truncated stack).

The conv kernel keeps the JAX layout, ``w`` (kernel_size, in_channels,
filters) and ``b`` (filters,), so the parameter trees of the two packages
are the same; it is transposed to ``F.conv1d``'s (filters, in_channels,
kernel_size) only inside :func:`causal_conv1d`. The conv is one
``F.conv1d`` over the whole sequence with kernel_size − 1 zeros of left
padding (Keras ``padding='causal'``: step t sees only inputs ≤ t), then
the bias and relu. It is a library call, as the x-side ``torch.matmul`` of
the LSTM layers is: the JAX package computes it with
``lax.conv_general_dilated`` outside any Pallas kernel. Its product follows
the training regime (``utils.precision.product``) and, on the card, cuDNN's
TF32 switch, which ``utils.precision.matmul_scope`` sets.

A conv hybrid holds its stack as the pure families do, so every entry point
peels the front end first and then runs the stack's own route:

* ``ConvLSTM``: ``conv``, ``layers``, ``head`` (the JAX ``ConvLSTMParams``);
  :attr:`ConvLSTM.stack` is the same layers and head as a ``StackedLSTM``;
* ``ConvSingularLSTM`` / ``ConvReducedLSTM``: ``conv`` and ``inner`` (a
  ``SingularLSTM`` / ``ReducedLSTM``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from svd_lstm_tpu_torch.models.lstm import (
    DenseHead,
    LSTMLayer,
    StackedLSTM,
    _glorot_uniform,
    init_lstm_layer,
    stacked_lstm_apply,
)
from svd_lstm_tpu_torch.models.reduced import ReducedLSTM, reduced_lstm_apply
from svd_lstm_tpu_torch.models.singular import SingularLSTM, singular_lstm_apply
from svd_lstm_tpu_torch.utils.precision import product


class ConvFront(nn.Module):
    """The causal conv front end: ``w`` (kernel_size, in_channels, filters),
    ``b`` (filters,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    @property
    def kernel_size(self) -> int:
        return self.w.shape[0]

    @property
    def in_channels(self) -> int:
        return self.w.shape[1]

    def forward(self, x_seq: torch.Tensor) -> torch.Tensor:
        return conv_front(self, x_seq)


class ConvLSTM(nn.Module):
    """Conv front end + dense LSTM stack + dense head."""

    def __init__(self, conv: ConvFront, layers: Sequence[LSTMLayer], head: DenseHead):
        super().__init__()
        self.conv = conv
        self.layers = nn.ModuleList(layers)
        self.head = head

    @property
    def stack(self) -> StackedLSTM:
        """The layers and head as a ``StackedLSTM`` (the same parameters),
        made once and kept outside the module's registry, so the parameter
        names stay the JAX tree's (``conv``, ``layers``, ``head``)."""
        s = self.__dict__.get("_stack")
        if s is None or s.layers is not self.layers or s.head is not self.head:
            s = StackedLSTM.__new__(StackedLSTM)
            nn.Module.__init__(s)
            s.layers, s.head = self.layers, self.head
            self.__dict__["_stack"] = s
        return s

    def forward(self, x_seq: torch.Tensor, return_sequences: bool = True) -> torch.Tensor:
        return conv_lstm_apply(self, x_seq, return_sequences)


class ConvSingularLSTM(nn.Module):
    """Conv front end + SVD-factorized LSTM stack (+ dense head)."""

    def __init__(self, conv: ConvFront, inner: SingularLSTM):
        super().__init__()
        self.conv = conv
        self.inner = inner

    def weight_count(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def forward(self, x_seq: torch.Tensor, return_sequences: bool = True) -> torch.Tensor:
        return conv_singular_apply(self, x_seq, return_sequences)


class ConvReducedLSTM(nn.Module):
    """Conv front end + truncated two-step LSTM stack (+ dense head)."""

    def __init__(self, conv: ConvFront, inner: ReducedLSTM):
        super().__init__()
        self.conv = conv
        self.inner = inner

    def weight_count(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))

    def forward(self, x_seq: torch.Tensor, return_sequences: bool = True) -> torch.Tensor:
        return conv_reduced_apply(self, x_seq, return_sequences)


CONV_TYPES = (ConvLSTM, ConvSingularLSTM, ConvReducedLSTM)


def inner_stack(model):
    """The LSTM stack of a conv hybrid (``StackedLSTM``, ``SingularLSTM`` or
    ``ReducedLSTM``), or the model itself when it has no conv front end."""
    if isinstance(model, ConvLSTM):
        return model.stack
    if isinstance(model, (ConvSingularLSTM, ConvReducedLSTM)):
        return model.inner
    return model


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The causal cross-correlation without bias: x (B, T, C), w (k, C, F)
    -> (B, T, F); linear in each argument."""
    k = w.shape[0]
    xt = F.pad(x.transpose(1, 2), (k - 1, 0))
    return F.conv1d(xt, w.permute(2, 1, 0)).transpose(1, 2).contiguous()


def causal_conv1d(conv: ConvFront, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, C) -> (B, T, filters), left-padded with kernel_size − 1
    zeros so step t sees only inputs ≤ t (Keras padding='causal'). The
    product follows the training regime (``utils.precision.product``)."""
    return product(_conv, x, conv.w) + conv.b


def conv_front(conv: ConvFront, x: torch.Tensor) -> torch.Tensor:
    """relu(causal conv): the hybrids' front end."""
    return torch.relu(causal_conv1d(conv, x))


def init_conv_lstm(
    gen: torch.Generator,
    in_channels: int = 1,
    filters: int = 15,
    kernel_size: int = 10,
    units: Sequence[int] = (15, 15),
    head_dim: int = 1,
    dtype=torch.float32,
    device: str | torch.device = "cuda",
) -> ConvLSTM:
    """A freshly initialised hybrid: the conv kernel Keras-glorot-uniform
    over its receptive field, limit sqrt(6 / (k·c_in + k·filters)), zero
    conv bias; the layers and head as ``init_stacked_lstm`` draws them.
    Drawn on the CPU from ``gen`` and moved to ``device`` (the card unless
    ``device="cpu"``). The numbers differ from the JAX package's for the
    same seed (another generator); the distributions are the same."""
    limit = math.sqrt(6.0 / (kernel_size * in_channels + kernel_size * filters))
    w = torch.empty((kernel_size, in_channels, filters), dtype=dtype).uniform_(
        -limit, limit, generator=gen)
    conv = ConvFront(w, torch.zeros(filters, dtype=dtype))
    layers, d = [], filters
    for n in units:
        layers.append(init_lstm_layer(gen, d, n, dtype))
        d = n
    head = DenseHead(_glorot_uniform(gen, (d, head_dim), dtype), torch.zeros(head_dim, dtype=dtype))
    return ConvLSTM(conv, layers, head).to(device)


def conv_lstm_apply(model: ConvLSTM, x_seq: torch.Tensor, return_sequences: bool = True,
                    remat_chunk: int = 0) -> torch.Tensor:
    """(batch, T, in_channels) -> (batch, T, out), or (batch, out) for the
    last step. ``remat_chunk`` goes to every layer of the stack."""
    return stacked_lstm_apply(model.stack, conv_front(model.conv, x_seq), return_sequences,
                              remat_chunk=remat_chunk)


def conv_singular_apply(
    model: ConvSingularLSTM,
    x_seq: torch.Tensor,
    return_sequences: bool = True,
    dropout: float = 0.0,
    recurrent_dropout: float = 0.0,
    rng=None,
    remat_chunk: int = 0,
) -> torch.Tensor:
    """Causal conv + relu, then the factorized stack. The dropout and remat
    arguments pass straight to ``singular_lstm_apply``: the conv front end
    takes no dropout (Keras drops the LSTM cells' inputs)."""
    return singular_lstm_apply(model.inner, conv_front(model.conv, x_seq), return_sequences,
                               dropout=dropout, recurrent_dropout=recurrent_dropout, rng=rng,
                               remat_chunk=remat_chunk)


def conv_reduced_apply(model: ConvReducedLSTM, x_seq: torch.Tensor,
                       return_sequences: bool = True) -> torch.Tensor:
    return reduced_lstm_apply(model.inner, conv_front(model.conv, x_seq), return_sequences)
