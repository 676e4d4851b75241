"""Rank-reduction sweep: RMSE-vs-rank curves.

Counterpart of ``svd_lstm_tpu/bench/sweep.py``, the v1 sweep that produced
the published RMSE_plot.png (reference
code/old_versions/svd_acceleration.py:61-103 and
LSTM_wrapper.iterate_reduce_model, old_versions/svd_classes.py:139-182):

1. compute every gate block's singular values (layers × {W, U} × 4 gates);
2. order all of them ascending (the "absolute" heuristic) or by their share
   of their block's largest σ ("relative");
3. zero the next-smallest σ one at a time (rank-reduce that gate block),
   evaluating the whole-run RMSE at the unreduced baseline, every
   ``evaluate_every`` applied reductions, and at the final state;
4. count eliminated weights by the two-step accounting (one rank less of
   an m×n block saves m + n − 2·r_new − 1 stored weights);
5. stop early when the RMSE ratio crosses ``threshold``;
6. keep each evaluation's predictions if asked (for the reduce_rank.gif).

A ``ConvLSTM`` sweeps its stack's gate blocks (the conv kernel is not a
gate block, so it never enters the order) and keeps its front end.

Each evaluation is one ``predict(model, X[0], impl="auto")`` on the model's
device: on the card K1 for stacks of at most 128 units and K3's hybrid for
wider ones, on the CPU the plain scan. A reduction builds a new model that
shares every parameter but the reduced one, and ``predict`` reads the
weights of the model it is given, so each evaluation sees the reduction
just made.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from svd_lstm_tpu_torch.api import predict
from svd_lstm_tpu_torch.config import SweepConfig
from svd_lstm_tpu_torch.factor.svd import get_model_singular_values, set_model_matrix_rank
from svd_lstm_tpu_torch.models.conv import ConvLSTM
from svd_lstm_tpu_torch.models.lstm import StackedLSTM
from svd_lstm_tpu_torch.train.metrics import rmse as rmse_fn


@dataclasses.dataclass
class SweepResult:
    rmse: np.ndarray                 # RMSE at each evaluation
    rmse_ratio: np.ndarray           # rmse / rmse[0]
    weights_eliminated: np.ndarray   # cumulative, aligned with evaluations
    reductions_done: int
    order: np.ndarray                # (iters, 4) sorted (layer, W/U, gate, σ-index)
    predictions: List[np.ndarray]    # per-evaluation whole-run predictions (optional)


def _check_dense(model) -> None:
    if not isinstance(model, (StackedLSTM, ConvLSTM)):
        raise TypeError(f"the rank sweep reduces dense models; got {type(model).__name__}")


def sorted_sigma_indices(
    model: StackedLSTM,
    protect_first_layer_w: bool = True,
    heuristic: str = "absolute",
) -> np.ndarray:
    """All (layer, W/U, gate, σ-index) quadruples in drop order (reference
    old_versions/svd_acceleration.py:64-68):

    * ``"absolute"``: ascending raw σ (the reference's only heuristic);
    * ``"relative"``: σ over its block's largest σ, so large- and
      small-scale gate blocks compete fairly.

    ``protect_first_layer_w`` leaves layer 0's input kernel out; σ-slots
    that are structurally zero (a W block with d < n has d nonzero σ) are
    skipped."""
    _check_dense(model)
    sv = get_model_singular_values(model)  # (L, 2, 4, units)
    if heuristic == "relative":
        scale = sv.max(axis=-1, keepdims=True)
        key = sv / np.where(scale == 0, 1.0, scale)
    elif heuristic == "absolute":
        key = sv
    else:
        raise ValueError(f"unknown heuristic {heuristic!r}")
    order = np.stack(np.unravel_index(np.argsort(key.ravel()), sv.shape), axis=1)
    if protect_first_layer_w:
        order = order[~((order[:, 0] == 0) & (order[:, 1] == 0))]
    nz = sv[order[:, 0], order[:, 1], order[:, 2], order[:, 3]] > 1e-12
    return order[nz]


def rank_sweep(
    model: StackedLSTM,
    X: np.ndarray,                  # (1, T, d)
    y_true_scaled: np.ndarray,      # (T,) physical units
    inverse_transform,              # scaler.inverse_transform
    cfg: SweepConfig = SweepConfig(),
    max_reductions: int | None = None,
    keep_predictions: bool = False,
) -> SweepResult:
    """Reduce ``model`` one σ at a time in the order of
    :func:`sorted_sigma_indices` and trace the whole-run RMSE (see the
    module docstring). Runs on the device of ``model``."""
    order = sorted_sigma_indices(model, cfg.protect_first_layer_w)
    if max_reductions is not None:
        order = order[:max_reductions]
    dev = model.layers[0].W.device
    x = torch.as_tensor(np.asarray(X, np.float32)[0], device=dev)

    # current rank of each (layer, W/U, gate) block
    ranks = {}
    for li, layer in enumerate(model.layers):
        for g in range(4):
            ranks[(li, 0, g)] = min(layer.input_dim, layer.units)
            ranks[(li, 1, g)] = layer.units

    rmses, weights_elim, preds = [], [], []
    running_weights = 0

    def evaluate():
        pred = predict(model, x)[:, 0].cpu().numpy()
        pred_scaled = inverse_transform(pred.reshape(-1, 1)).ravel()
        rmses.append(rmse_fn(y_true_scaled, pred_scaled))
        weights_elim.append(running_weights)
        if keep_predictions:
            preds.append(pred_scaled)

    evaluate()  # baseline: 0 reductions (also covers an empty order)
    reductions = since_eval = 0
    stopped = False
    for li, wu, gate, _sigma_idx in order:
        key = (int(li), int(wu), int(gate))
        new_rank = ranks[key] - 1
        if new_rank < 1:
            continue  # the rank-1 floor: not a reduction, not counted
        ranks[key] = new_rank
        model = set_model_matrix_rank(model, key, new_rank)
        layer = model.layers[key[0]]
        m = layer.input_dim if wu == 0 else layer.units
        running_weights += m + layer.units - 2 * new_rank - 1
        reductions += 1
        since_eval += 1
        if since_eval >= cfg.evaluate_every:
            evaluate()
            since_eval = 0
            if cfg.threshold is not None and rmses[-1] / max(rmses[0], 1e-300) > cfg.threshold:
                stopped = True
                break
    if since_eval > 0 and not stopped:
        evaluate()  # the final state is always measured

    rmses_arr = np.asarray(rmses)
    return SweepResult(
        rmse=rmses_arr,
        rmse_ratio=rmses_arr / max(rmses_arr[0], 1e-300),
        weights_eliminated=np.asarray(weights_elim),
        reductions_done=reductions,
        order=order,
        predictions=preds,
    )
