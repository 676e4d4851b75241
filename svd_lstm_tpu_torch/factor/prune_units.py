"""Structural unit pruning of a dense stack.

Counterpart of ``svd_lstm_tpu/factor/prune_units.py``. Truncating rank
leaves the recurrent state as wide as it was; removing whole hidden units
shrinks every weight matrix and the state together, so it can shorten the
batch-1 step. It composes with the SVD surgery: prune first, then factorize
and truncate the smaller model.

Removing unit k of layer l drops, consistently:

* in layer l: column k of every gate block of W and U, row k of U, and
  entry k of every gate segment of b;
* in layer l + 1 (or the dense head): input row k.

``unit_importance`` scores each unit by the L2 norm of what it receives
(its gate columns of W and U) times that of what it produces (its rows of
the next layer's W or the head, and of U). The scores and the choice of
units run in numpy on the host with the JAX package's own operations, so
both packages keep the same units, ties included.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gate_cols(M: np.ndarray, n: int, keep: np.ndarray) -> np.ndarray:
    """Keep columns ``keep`` of each gate block of (rows, 4n)."""
    return np.concatenate([M[:, g * n : (g + 1) * n][:, keep] for g in range(4)], axis=1)


def unit_importance(model: StackedLSTM) -> list:
    """Each layer's importance scores, shape (units,) each."""
    scores = []
    for li, layer in enumerate(model.layers):
        n = layer.units
        W, U = _host(layer.W), _host(layer.U)
        inbound = np.zeros(n)  # how strongly the unit's gates are driven
        for g in range(4):
            inbound += np.linalg.norm(W[:, g * n : (g + 1) * n], axis=0) ** 2
            inbound += np.linalg.norm(U[:, g * n : (g + 1) * n], axis=0) ** 2
        # how strongly the unit's h feeds the rest of the network
        out_mat = _host(model.layers[li + 1].W) if li + 1 < len(model.layers) else _host(model.head.w)
        outbound = np.linalg.norm(out_mat, axis=1) ** 2
        outbound = outbound + np.linalg.norm(U, axis=1) ** 2  # recurrent reuse
        scores.append(np.sqrt(inbound) * np.sqrt(outbound))
    return scores


def prune_units(model: StackedLSTM, keep: Sequence[np.ndarray]) -> StackedLSTM:
    """A new stack keeping only the listed units of each layer (``keep[l]``
    indexes layer l's units; sorted ascending). Exact: the pruned model
    computes what the original computes with the other units' states held
    at zero. The head shrinks with the last layer. On the model's device."""
    keep = [np.sort(np.asarray(k)) for k in keep]
    dev = model.head.w.device
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    layers = []
    for li, layer in enumerate(model.layers):
        n, k = layer.units, keep[li]
        W, U, b = _host(layer.W), _host(layer.U), _host(layer.b)
        if li > 0:
            W = W[keep[li - 1]]  # the previous layer's surviving outputs
        U = U[k]                 # the surviving state rows
        W = _gate_cols(W, n, k)
        U = _gate_cols(U, n, k)
        b = np.concatenate([b[g * n : (g + 1) * n][k] for g in range(4)])
        layers.append(LSTMLayer(to(W), to(U), to(b)))
    head = DenseHead(to(_host(model.head.w)[keep[-1]]), model.head.b.detach().clone())
    return StackedLSTM(layers, head)


def prune_to_width(model: StackedLSTM, widths: Sequence[int]) -> StackedLSTM:
    """Keep the ``widths[l]`` most important units of each layer."""
    scores = unit_importance(model)
    keep = [np.argsort(s)[::-1][:w].copy() for s, w in zip(scores, widths)]
    return prune_units(model, keep)
