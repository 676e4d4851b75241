"""Parallel → sequential LSTM weight merging.

Counterpart of ``svd_lstm_tpu/models/merge.py``, the reference's
model-merging surgery (splicing two pretrained cells, e.g. a 'frequency'
and an 'amplitude' model, into one wider layer). Given two cells (W₁, U₁,
b₁) and (W₂, U₂, b₂), build one cell of width n₁ + n₂ whose hidden state is
the concatenation of the two:

* each gate's kernel columns are [gate₁ | gate₂];
* with ``same_x`` both cells read the same input and the kernel rows stack
  as they are; otherwise the inputs concatenate and each gate's kernel is
  block-diagonal;
* the recurrent kernel is always block-diagonal per gate, so the merged
  cell computes exactly what the two cells computed side by side.

The surgery runs in numpy on the host; the merged layer lands on the first
cell's device.
"""

from __future__ import annotations

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import LSTMLayer


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def merge_parallel_cell_weights(cell1: LSTMLayer, cell2: LSTMLayer, same_x: bool = False) -> LSTMLayer:
    """One ``LSTMLayer`` of n₁ + n₂ units equal to the two cells side by side
    (inputs ``x`` for both with ``same_x``, else ``[x₁ | x₂]``). Raises
    ``ValueError`` for ``same_x`` with unequal input widths."""
    W1, U1, b1 = _host(cell1.W), _host(cell1.U), _host(cell1.b)
    W2, U2, b2 = _host(cell2.W), _host(cell2.U), _host(cell2.b)
    n1, n2 = U1.shape[0], U2.shape[0]
    d1, d2 = W1.shape[0], W2.shape[0]
    if same_x and d1 != d2:
        raise ValueError("same_x requires identical input dims")

    def gate(M, n, g):
        return M[:, g * n : (g + 1) * n]

    W_blocks, U_blocks = [], []
    for g in range(4):
        if same_x:
            W_blocks.append(np.concatenate([gate(W1, n1, g), gate(W2, n2, g)], axis=1))
        else:
            blk = np.zeros((d1 + d2, n1 + n2), W1.dtype)
            blk[:d1, :n1] = gate(W1, n1, g)
            blk[d1:, n1:] = gate(W2, n2, g)
            W_blocks.append(blk)
        blk = np.zeros((n1 + n2, n1 + n2), U1.dtype)
        blk[:n1, :n1] = gate(U1, n1, g)
        blk[n1:, n1:] = gate(U2, n2, g)
        U_blocks.append(blk)
    b = np.concatenate(
        [np.concatenate([b1[g * n1 : (g + 1) * n1], b2[g * n2 : (g + 1) * n2]]) for g in range(4)]
    )
    dev = cell1.W.device
    return LSTMLayer(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (np.concatenate(W_blocks, axis=1), np.concatenate(U_blocks, axis=1), b)))
