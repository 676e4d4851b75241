"""SVD model surgery: dense → singular → reduced.

Counterpart of ``svd_lstm_tpu/factor/svd.py``. The SVDs and the two-step
truncation run in float64 numpy, exactly as in the JAX package, so both
packages produce the same factors from the same weights; the results come
back as tensors on the source model's device.

``V₁`` invertibility is handled with an explicit conditioning check and an
``lstsq`` fallback.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from svd_lstm_tpu_torch.models.conv import ConvFront, ConvLSTM, ConvReducedLSTM, ConvSingularLSTM
from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM
from svd_lstm_tpu_torch.models.reduced import ReducedLayer, ReducedLSTM
from svd_lstm_tpu_torch.models.singular import SingularLayer, SingularLSTM

_COND_LIMIT = 1e8  # V1 conditioning guard (slide 7: "U₁ may not be invertible")


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _copy_head(head: DenseHead) -> DenseHead:
    return DenseHead(head.w.detach().clone(), head.b.detach().clone())


def _copy_conv(conv: ConvFront) -> ConvFront:
    return ConvFront(conv.w.detach().clone(), conv.b.detach().clone())


# ---------------------------------------------------------------------------
# dense -> singular
# ---------------------------------------------------------------------------

def _svd(mat: np.ndarray):
    return np.linalg.svd(np.asarray(mat, dtype=np.float64), full_matrices=False)


def factorize_lstm_params(
    layer: LSTMLayer, merged_kernel: bool = False, dtype=torch.float32
) -> SingularLayer:
    """Factorize one dense layer's kernels as U·Σ·Vᵀ.

    merged: one SVD of the whole (d×4n) / (n×4n) matrix;
    split:  one SVD per gate block, factors stacked on a leading gate axis.
    """
    W, U, b = _f64(layer.W), _f64(layer.U), _f64(layer.b)
    n = layer.units
    dev = layer.W.device

    if merged_kernel:
        wl, ws, wr = _svd(W)
        ul, us, ur = _svd(U)
    else:
        w_parts = [_svd(W[:, g * n : (g + 1) * n]) for g in range(4)]
        u_parts = [_svd(U[:, g * n : (g + 1) * n]) for g in range(4)]
        wl, ws, wr = (np.stack([p[i] for p in w_parts]) for i in range(3))
        ul, us, ur = (np.stack([p[i] for p in u_parts]) for i in range(3))

    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    return SingularLayer(t(wl), t(ws), t(wr), t(ul), t(us), t(ur), t(b))


def make_singular_model(
    model: StackedLSTM, merged_kernel: bool = False, dtype=torch.float32
) -> SingularLSTM:
    """dense model -> singular model. The dense head is copied unchanged."""
    layers = [factorize_lstm_params(l, merged_kernel, dtype) for l in model.layers]
    return SingularLSTM(layers, _copy_head(model.head))


# ---------------------------------------------------------------------------
# singular -> reduced (two-step truncation)
# ---------------------------------------------------------------------------

def _truncate_factors(
    left: np.ndarray,
    sigma: np.ndarray,
    right: np.ndarray,
    cutoff: float | None,
    rank: int | None,
) -> Tuple[np.ndarray, np.ndarray]:
    """(U, σ, Vᵀ) -> exact two-step (B, C) after dropping small σ.

    B = (U·Σ)·V₁ and C = V₁⁻¹·V₂. Selection keeps components BY MAGNITUDE —
    threshold |σ| > cutoff, or the top ``rank`` by |σ| with a stable sort —
    because a fine-tuned σ vector is neither descending nor non-negative.
    """
    left = np.asarray(left, np.float64)
    sigma = np.asarray(sigma, np.float64)
    right = np.asarray(right, np.float64)
    if rank is not None:
        mask = np.zeros(sigma.shape, bool)
        # stable descending sort: ties keep their original (descending-σ)
        # order, so a freshly factorized model truncates as the first-r rule
        mask[np.argsort(-np.abs(sigma), kind="stable")[:rank]] = True
    elif cutoff is not None:
        mask = np.abs(sigma) > cutoff
    else:
        raise ValueError(
            "truncation needs a selection rule: pass cutoff= (σ threshold) "
            "or rank= (top-r by magnitude)"
        )
    if not mask.any():
        # Keep at least the largest-|σ| component; an all-zero gate would
        # make V1 empty and the two-step undefined.
        mask[np.argmax(np.abs(sigma))] = True
    U = left[:, mask]
    S = sigma[mask]
    V = right[mask, :]
    r = V.shape[0]
    V1, V2 = V[:, :r], V[:, r:]
    B = (U * S) @ V1
    cond = np.linalg.cond(V1)
    if not np.isfinite(cond) or cond > _COND_LIMIT:
        warnings.warn(
            f"V1 ill-conditioned (cond={cond:.3e}); using least-squares for C",
            RuntimeWarning,
        )
        C = np.linalg.lstsq(V1, V2, rcond=None)[0]
    else:
        C = np.linalg.solve(V1, V2)
    return B, C


def truncate_singular_layer(
    p: SingularLayer,
    cutoff: float | None = 0.05,
    rank: int | None = None,
    dtype=torch.float32,
) -> ReducedLayer:
    """Truncate one singular layer to the exact two-step reduced form."""
    dev = p.b.device
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    wl, ws, wr = _f64(p.wl), _f64(p.ws), _f64(p.wr)
    ul, us, ur = _f64(p.ul), _f64(p.us), _f64(p.ur)
    if p.split:
        w = [_truncate_factors(wl[g], ws[g], wr[g], cutoff, rank) for g in range(4)]
        u = [_truncate_factors(ul[g], us[g], ur[g], cutoff, rank) for g in range(4)]
        return ReducedLayer(
            wB=[t(B) for B, _ in w],
            wC=[t(C) for _, C in w],
            uB=[t(B) for B, _ in u],
            uC=[t(C) for _, C in u],
            b=t(_f64(p.b)),
        )
    Bw, Cw = _truncate_factors(wl, ws, wr, cutoff, rank)
    Bu, Cu = _truncate_factors(ul, us, ur, cutoff, rank)
    return ReducedLayer(wB=t(Bw), wC=t(Cw), uB=t(Bu), uC=t(Cu), b=t(_f64(p.b)))


def make_reduced_model(
    smodel: SingularLSTM,
    cutoff: float | None = 0.05,
    rank: int | None = None,
    dtype=torch.float32,
) -> ReducedLSTM:
    """singular model -> reduced model."""
    layers = [
        truncate_singular_layer(l, cutoff=cutoff, rank=rank, dtype=dtype)
        for l in smodel.layers
    ]
    return ReducedLSTM(layers, _copy_head(smodel.head))


def _dense_matrix(left, sigma, right) -> torch.Tensor:
    """(left · diag(sigma)) · right, merged (2-D) or per-gate (3-D stacked).

    merged: left (d, k), sigma (k,), right (k, 4n) -> (d, 4n)
    split:  left (4, d, k), sigma (4, k), right (4, k, n) -> (d, 4n)
            with gate blocks [i|f|c|o] concatenated along columns, the
            Keras layout models/lstm.py stores.
    """
    if left.ndim == 3:
        scaled = left * sigma[:, None, :]                              # (4, d, k)
        per_gate = torch.einsum("gdk,gkn->gdn", scaled, right)        # (4, d, n)
        return per_gate.permute(1, 0, 2).reshape(per_gate.shape[1], -1)
    return torch.matmul(left * sigma, right)


@torch.no_grad()
def singular_to_dense(smodel: SingularLSTM, dtype=torch.float32) -> StackedLSTM:
    """Collapse a singular model back to dense parameters — exact
    (W = (U·Σ)·Vᵀ per matrix / per gate). Used to run a singular model on
    the dense fast path."""
    layers = [
        LSTMLayer(
            W=_dense_matrix(p.wl, p.ws, p.wr).to(dtype),
            U=_dense_matrix(p.ul, p.us, p.ur).to(dtype),
            b=p.b.detach().clone().to(dtype),
        )
        for p in smodel.layers
    ]
    return StackedLSTM(layers, _copy_head(smodel.head))


# ---------------------------------------------------------------------------
# conv-hybrid surgery: the same pipeline over the Conv1D + LSTM family
# ---------------------------------------------------------------------------
#
# The conv front end is carried through unchanged (copied, as the head is)
# while the LSTM stack goes through the dense -> singular -> reduced surgery
# above.

def make_conv_singular_model(model: ConvLSTM, merged_kernel: bool = False,
                             dtype=torch.float32) -> ConvSingularLSTM:
    """Conv hybrid -> conv + factorized stack."""
    if not isinstance(model, ConvLSTM):
        raise TypeError(f"expected ConvLSTM, got {type(model).__name__}")
    inner = make_singular_model(model.stack, merged_kernel, dtype)
    return ConvSingularLSTM(_copy_conv(model.conv), inner)


def make_conv_reduced_model(model: ConvSingularLSTM, cutoff: float | None = 0.05,
                            rank: int | None = None, dtype=torch.float32) -> ConvReducedLSTM:
    """Conv + singular stack -> conv + truncated two-step stack."""
    if not isinstance(model, ConvSingularLSTM):
        raise TypeError(f"expected ConvSingularLSTM, got {type(model).__name__}")
    inner = make_reduced_model(model.inner, cutoff=cutoff, rank=rank, dtype=dtype)
    return ConvReducedLSTM(_copy_conv(model.conv), inner)


def conv_singular_to_dense(model: ConvSingularLSTM, dtype=torch.float32) -> ConvLSTM:
    """Collapse a conv + singular hybrid back to the dense family, exactly;
    the conv front end untouched (inverse of :func:`make_conv_singular_model`)."""
    if not isinstance(model, ConvSingularLSTM):
        raise TypeError(f"expected ConvSingularLSTM, got {type(model).__name__}")
    dense = singular_to_dense(model.inner, dtype)
    return ConvLSTM(_copy_conv(model.conv), list(dense.layers), dense.head)


# ---------------------------------------------------------------------------
# v1 rank utilities (reference code/old_versions/svd_classes.py)
# ---------------------------------------------------------------------------

def reduce_matrix_rank(a: np.ndarray, rank: int) -> np.ndarray:
    """Zero the trailing singular values of ``a`` and reconstruct, in
    float64 (reference old_versions/svd_classes.py:9-12)."""
    u, s, v = _svd(a)
    s = s.copy()
    s[rank:] = 0.0
    return (u * s) @ v


def two_step_factors(a: np.ndarray, rank: int) -> Tuple[np.ndarray, np.ndarray]:
    """Column-convention two-step factors of the rank-``rank``
    approximation: x @ a ≈ concat(x @ B, (x @ B) @ C). Exact when
    rank(a) ≤ rank."""
    u, s, v = _svd(a)
    return _truncate_factors(u, s, v, cutoff=None, rank=rank)


def reduce_two_step(a: np.ndarray, rank: int) -> list:
    """Row-convention (W @ x) two-step pair (reference
    old_versions/svd_classes.py:14-21): [D, E] with (W @ x)[:r] = D @ x and
    (W @ x)[r:] = E @ (D @ x)."""
    B, C = two_step_factors(np.asarray(a).T, rank)
    return [B.T, C.T]


def get_model_singular_values(model: StackedLSTM) -> np.ndarray:
    """Per-gate singular values of every W and U block: (layers, 2, 4,
    units), the σ axis sized to the widest layer (a narrower layer's
    trailing slots stay 0). Each block's σ come from the same numpy call on
    the same float32 values as in the JAX package, so both order them
    alike, ties included."""
    units = max(layer.units for layer in model.layers)
    out = np.zeros((len(model.layers), 2, 4, units))
    for i, layer in enumerate(model.layers):
        n = layer.units
        for j, M in enumerate((layer.W, layer.U)):
            M = M.detach().cpu().numpy()
            for g in range(4):
                s = np.linalg.svd(M[:, g * n : (g + 1) * n], compute_uv=False)
                out[i, j, g, : s.size] = s
    return out


def set_model_matrix_rank(model: StackedLSTM, index: Tuple[int, int, int], rank: int) -> StackedLSTM:
    """A new model with one gate block reduced to ``rank``, index = (layer,
    0 for W / 1 for U, gate). The reconstruction runs in float64 and is cast
    to the block's dtype. Only the reduced parameter is new: every other
    parameter (and the head, and a ``ConvLSTM``'s conv front end) is the
    source model's own."""
    li, wj, g = index
    layer = model.layers[li]
    n = layer.units
    old = layer.W if wj == 0 else layer.U
    M = old.detach().cpu().numpy().copy()
    M[:, g * n : (g + 1) * n] = reduce_matrix_rank(M[:, g * n : (g + 1) * n], rank)
    new_layer = LSTMLayer(layer.W, layer.U, layer.b)
    for name in ("W", "U", "b"):  # the source's parameter objects themselves
        setattr(new_layer, name, getattr(layer, name))
    setattr(new_layer, "W" if wj == 0 else "U",
            torch.nn.Parameter(torch.tensor(M, dtype=old.dtype, device=old.device)))
    layers = list(model.layers)
    layers[li] = new_layer
    if isinstance(model, ConvLSTM):
        return ConvLSTM(model.conv, layers, model.head)
    return StackedLSTM(layers, model.head)
