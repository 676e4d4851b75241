"""Dense stacked-LSTM regressor as ``nn.Module``s.

Counterpart of ``svd_lstm_tpu/models/lstm.py``. The weight layout stays
Keras-compatible, so checkpoints of the JAX package load unchanged:

* ``W``: (input_dim, 4*units), gate columns ordered [i | f | c | o]
* ``U``: (units, 4*units), same gate order
* ``b``: (4*units,)

and the cell math is the standard Keras LSTM:

    z = x @ W + h @ U + b
    i, f, g, o = split(z, 4)
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')

The input projection ``x @ W + b`` of a whole sequence is hoisted out of the
recurrence into one ``torch.matmul``; only ``h @ U`` runs inside the time
loop. These plain loops are the port's own semantics (the ``scan`` impl of
:func:`svd_lstm_tpu_torch.api.predict`); the batch-1 hot path runs the CUDA
kernels in ``ops/cuda_lstm.py``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
from torch import nn


class DenseHead(nn.Module):
    """Linear read-out: ``h @ w + b`` with w (in, out), b (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.matmul(h, self.w) + self.b


class LSTMLayer(nn.Module):
    def __init__(self, W: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.W = nn.Parameter(W)  # (input_dim, 4*units)  [i|f|c|o]
        self.U = nn.Parameter(U)  # (units, 4*units)
        self.b = nn.Parameter(b)  # (4*units,)

    @property
    def units(self) -> int:
        return self.U.shape[0]

    @property
    def input_dim(self) -> int:
        return self.W.shape[0]


class StackedLSTM(nn.Module):
    def __init__(self, layers: Sequence[LSTMLayer], head: DenseHead):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.head = head

    def forward(self, x_seq: torch.Tensor, return_sequences: bool = True) -> torch.Tensor:
        return stacked_lstm_apply(self, x_seq, return_sequences)


def gate_update(z: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused carry/output update. z: (..., 4n); c: (..., n)."""
    zi, zf, zg, zo = torch.split(z, c.shape[-1], dim=-1)
    i = torch.sigmoid(zi)
    f = torch.sigmoid(zf)
    g = torch.tanh(zg)
    o = torch.sigmoid(zo)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def gate_update_bwd(
    z: torch.Tensor, c_prev: torch.Tensor, c_t: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse of :func:`gate_update` at one step, from the recomputed
    pre-activations ``z`` and the saved cell states. ``dh`` must already
    hold every contribution into h_t (output cotangent, recurrent carry,
    the layer above). Returns ``(dz, dc_prev)``. The CUDA backward kernels
    compute the same formula in ``ops/csrc/lstm_train.cu:gate_bwd``."""
    n = c_prev.shape[-1]
    zi, zf, zg, zo = torch.split(z, n, dim=-1)
    i = torch.sigmoid(zi)
    f = torch.sigmoid(zf)
    g = torch.tanh(zg)
    o = torch.sigmoid(zo)
    tc = torch.tanh(c_t)
    dc_tot = dc + dh * o * (1.0 - tc * tc)
    dz = torch.cat(
        [
            dc_tot * g * i * (1.0 - i),
            dc_tot * c_prev * f * (1.0 - f),
            dc_tot * i * (1.0 - g * g),
            dh * tc * o * (1.0 - o),
        ],
        dim=-1,
    )
    return dz, dc_tot * f


def scan_recurrence(
    xp: torch.Tensor,
    recurrent_product: Callable[[torch.Tensor], torch.Tensor],
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
):
    """The time loop every layer type shares: ``z_t = xp_t + rec(h)`` then
    the gate update. xp: (B, T, 4n) with the bias folded in. Returns
    ``(h_seq (B, T, n), (hT, cT))``."""
    B, T, g4 = xp.shape
    n = g4 // 4
    h = h0 if h0 is not None else torch.zeros((B, n), dtype=xp.dtype, device=xp.device)
    c = c0 if c0 is not None else torch.zeros((B, n), dtype=xp.dtype, device=xp.device)
    h_seq = torch.empty((B, T, n), dtype=xp.dtype, device=xp.device)
    for t in range(T):
        h, c = gate_update(xp[:, t] + recurrent_product(h), c)
        h_seq[:, t] = h
    return h_seq, (h, c)


def lstm_layer_apply(
    layer: LSTMLayer,
    x_seq: torch.Tensor,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
    return_state: bool = False,
):
    """Run one LSTM layer over a sequence. x_seq: (batch, T, d). Returns the
    (batch, T, units) hidden sequence (optionally plus final (h, c))."""
    xp = torch.matmul(x_seq, layer.W) + layer.b  # (B, T, 4n): one hoisted matmul
    U = layer.U
    h_seq, state = scan_recurrence(xp, lambda h: torch.matmul(h, U), h0, c0)
    return (h_seq, state) if return_state else h_seq


def stacked_lstm_apply(
    model: StackedLSTM, x_seq: torch.Tensor, return_sequences: bool = True
) -> torch.Tensor:
    """Stacked LSTM + Dense head. (batch, T, d) -> (batch, T, out), or
    (batch, out) for the last step when ``return_sequences`` is False."""
    h = x_seq
    for layer in model.layers:
        h = lstm_layer_apply(layer, h)
    if not return_sequences:
        h = h[:, -1]
    return model.head(h)


# ---------------------------------------------------------------------------
# initialisation (Keras defaults, as the JAX package draws them)
# ---------------------------------------------------------------------------

def _glorot_uniform(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return torch.empty(shape, dtype=dtype).uniform_(-limit, limit, generator=gen)


def _orthogonal(gen: torch.Generator, rows: int, cols: int, dtype) -> torch.Tensor:
    """The orthogonal initializer of ``jax.nn.initializers.orthogonal``:
    QR of a standard normal matrix, Q's columns signed by diag(R)."""
    tall = (max(rows, cols), min(rows, cols))
    A = torch.randn(tall, dtype=torch.float64, generator=gen)
    Q, R = torch.linalg.qr(A)
    Q = Q * torch.sign(torch.diagonal(R))
    if rows < cols:
        Q = Q.t()
    return Q.to(dtype).contiguous()


def init_lstm_layer(
    gen: torch.Generator, input_dim: int, units: int, dtype=torch.float32
) -> LSTMLayer:
    """Glorot-uniform W, one orthogonal (n, n) block per gate for U (Keras
    ``recurrent_initializer='orthogonal'``), forget-gate bias 1 (Keras
    ``unit_forget_bias``), other biases 0."""
    W = _glorot_uniform(gen, (input_dim, 4 * units), dtype)
    U = torch.cat([_orthogonal(gen, units, units, dtype) for _ in range(4)], dim=1)
    b = torch.zeros(4 * units, dtype=dtype)
    b[units : 2 * units] = 1.0
    return LSTMLayer(W, U, b)


def init_stacked_lstm(
    gen: torch.Generator,
    input_dim: int = 16,
    units: Sequence[int] = (40, 40, 40, 40),
    head_dim: int = 1,
    dtype=torch.float32,
    device: str | torch.device = "cuda",
) -> StackedLSTM:
    """A freshly initialised stack with a Glorot-uniform head and zero head
    bias. The weights are drawn on the CPU from ``gen`` and then moved to
    ``device`` (the card unless ``device="cpu"`` is asked for), so a seed
    gives the same model on every device. The numbers
    differ from the JAX package's for the same seed (another generator);
    the distributions are the same."""
    layers, d = [], input_dim
    for n in units:
        layers.append(init_lstm_layer(gen, d, n, dtype))
        d = n
    head = DenseHead(_glorot_uniform(gen, (d, head_dim), dtype), torch.zeros(head_dim, dtype=dtype))
    return StackedLSTM(layers, head).to(device)
