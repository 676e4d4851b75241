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
kernels in ``ops/cuda_lstm.py``. Every product goes through
``utils.precision.dot``, so it follows the training regime of
``train_matmul_scope`` (the plain ``torch.matmul`` outside one).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
from torch import nn

from svd_lstm_tpu_torch.utils.precision import dot, einsum


class DenseHead(nn.Module):
    """Linear read-out: ``h @ w + b`` with w (in, out), b (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return dot(h, self.w) + self.b


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


def chunked_remat_scan(
    make_xp: Callable[[torch.Tensor], torch.Tensor],
    recurrent_product: Callable[[torch.Tensor], torch.Tensor],
    x_seq: torch.Tensor,
    K: int,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
):
    """Chunked-time rematerialized recurrence, shared by the dense and the
    singular layers: ``scan_recurrence(make_xp(x_seq), recurrent_product)``
    with ``torch.utils.checkpoint`` around each chunk of ``K`` steps (its
    input projection and its steps), so autograd keeps only the raw input
    chunk and the chunk-boundary (h, c) and recomputes the rest during the
    backward pass. The tail of T mod K steps runs unwrapped.

    x_seq: (B, T, d); make_xp: (B, T', d) -> (B, T', 4n) with the bias
    folded in. Returns ``(h_seq (B, T, n), (hT, cT))``. The caller
    guarantees 0 < K < T. The masks of a dropout apply are drawn before
    and captured by ``make_xp`` and ``recurrent_product``, so the
    recomputation draws nothing and no RNG state is stashed. The first
    call in a process also pays ``torch.utils.checkpoint``'s lazy imports."""
    from torch.utils.checkpoint import checkpoint

    T = x_seq.shape[1]
    n_chunks, tail = divmod(T, K)

    def chunk(x_chunk, h, c):
        h_seq, (h, c) = scan_recurrence(make_xp(x_chunk), recurrent_product, h, c)
        return h_seq, h, c

    h, c, parts = h0, c0, []
    for i in range(n_chunks):
        h_seq, h, c = checkpoint(chunk, x_seq[:, i * K : (i + 1) * K], h, c, use_reentrant=False,
                                 preserve_rng_state=False)
        parts.append(h_seq)
    if tail:
        h_seq, (h, c) = scan_recurrence(make_xp(x_seq[:, n_chunks * K :]), recurrent_product, h, c)
        parts.append(h_seq)
    return torch.cat(parts, dim=1), (h, c)


def run_recurrence(make_xp, recurrent_product, x_seq, h0=None, c0=None, remat_chunk: int = 0):
    """The layers' time loop: the plain scan, or :func:`chunked_remat_scan`
    when ``0 < remat_chunk < T`` (any other value is the plain scan)."""
    if remat_chunk and 0 < remat_chunk < x_seq.shape[1]:
        return chunked_remat_scan(make_xp, recurrent_product, x_seq, int(remat_chunk), h0, c0)
    return scan_recurrence(make_xp(x_seq), recurrent_product, h0, c0)


def dropout_masks(gen: torch.Generator, rate: float, shape, count: int, dtype, device) -> torch.Tensor:
    """``count`` inverted-scaled Bernoulli keep-masks of ``shape`` (1 / (1 −
    rate) with probability 1 − rate, else 0), drawn once from ``gen``, a
    generator on ``device``, so they are constant over every step of the
    scan (Keras ``get_dropout_mask_for_cell`` semantics)."""
    keep = 1.0 - rate
    u = torch.rand((count, *shape), generator=gen, dtype=torch.float32, device=device)
    return (u < keep).to(dtype) / keep


def layer_masks(rng, dropout: float, recurrent_dropout: float, count: int, B: int, d: int, n: int,
                dtype, device) -> tuple:
    """One layer's ``(dp, rdp)``: the input masks (count, B, d) and the
    recurrent masks (count, B, n), each None where its rate is 0. ``rng`` is
    the masks' source: a ``torch.Generator`` on the layer's device (dp drawn
    first, then rdp, as the JAX layer splits its key into ``k_dp, k_rdp``),
    or the pair ``(dp, rdp)`` itself, given explicitly (a test feeds the JAX
    package's masks through it). A nonzero rate without a source raises."""
    use_dp, use_rdp = dropout > 0.0, recurrent_dropout > 0.0
    if not (use_dp or use_rdp):
        return None, None
    if rng is None:
        raise ValueError("dropout requires an rng (a torch.Generator or explicit masks)")
    if isinstance(rng, torch.Generator):
        dp = dropout_masks(rng, dropout, (B, d), count, dtype, device) if use_dp else None
        rdp = dropout_masks(rng, recurrent_dropout, (B, n), count, dtype, device) if use_rdp else None
        return dp, rdp
    dp, rdp = rng
    return (dp if use_dp else None), (rdp if use_rdp else None)


def gate_masked_product(x: torch.Tensor, masks: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Per-gate masked product: ``[(x * masks[g]) @ M[:, g-th block]]_g``.
    x: (B, ..., k) batch-major; masks: (4, B, k), constant over the middle
    axes; M: (k, 4n). Returns (B, ..., 4n)."""
    k, g4 = M.shape
    n = g4 // 4
    m = masks.permute(1, 0, 2).reshape(masks.shape[1], *([1] * (x.ndim - 2)), 4, k)
    z = einsum("...gk,kgn->...gn", x.unsqueeze(-2) * m, M.reshape(k, 4, n))
    return z.reshape(*z.shape[:-2], g4)


def lstm_layer_apply(
    layer: LSTMLayer,
    x_seq: torch.Tensor,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
    return_state: bool = False,
    dropout: float = 0.0,
    recurrent_dropout: float = 0.0,
    rng=None,
    remat_chunk: int = 0,
):
    """Run one LSTM layer over a sequence. x_seq: (batch, T, d). Returns the
    (batch, T, units) hidden sequence (optionally plus final (h, c)).

    Dropout follows Keras LSTM semantics: one inverted-scaled mask per
    gate, drawn once and reused at every step, on the inputs (``dropout``,
    (4, B, d)) and on h(t−1) (``recurrent_dropout``, (4, B, n)). ``rng`` is
    the masks' source (:func:`layer_masks`).

    ``0 < remat_chunk < T`` rematerializes the backward pass's activations
    in time chunks of that length (:func:`chunked_remat_scan`): the same
    values, O(T/K + K) live activation memory instead of O(T)."""
    B, _, d = x_seq.shape
    n = layer.units
    dp, rdp = layer_masks(rng, dropout, recurrent_dropout, 4, B, d, n, x_seq.dtype, x_seq.device)
    W, U, b = layer.W, layer.U, layer.b

    def make_xp(x):  # one hoisted matmul over the (chunk of the) sequence
        if dp is None:
            return dot(x, W) + b
        return gate_masked_product(x, dp, W) + b

    if rdp is None:
        rec = lambda h: dot(h, U)  # noqa: E731
    else:
        rec = lambda h: gate_masked_product(h, rdp, U)  # noqa: E731
    h_seq, state = run_recurrence(make_xp, rec, x_seq, h0, c0, remat_chunk)
    return (h_seq, state) if return_state else h_seq


def stacked_lstm_apply(
    model: StackedLSTM, x_seq: torch.Tensor, return_sequences: bool = True, remat_chunk: int = 0
) -> torch.Tensor:
    """Stacked LSTM + Dense head. (batch, T, d) -> (batch, T, out), or
    (batch, out) for the last step when ``return_sequences`` is False.
    ``remat_chunk`` goes to every layer (:func:`lstm_layer_apply`)."""
    h = x_seq
    for layer in model.layers:
        h = lstm_layer_apply(layer, h, remat_chunk=remat_chunk)
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
