"""Magnitude pruning of the singular model's σ vectors.

Counterpart of ``svd_lstm_tpu/factor/prune_magnitude.py``: the reference's
abandoned experiment wraps its singular layers in tfmot's
``prune_low_magnitude`` under a ``PolynomialDecay(0 -> 0.5, 5000 steps)``
schedule, and the prunable weights of its singular layer are the σ
vectors. So here pruning is a per-tensor magnitude mask on every σ,
tightened along the schedule while fine-tuning. A zeroed σ is below every
cutoff, so a pruned model goes through ``make_reduced_model`` unchanged.
The masks are computed in numpy on the host (a stable sort of |σ|), as the
JAX package computes them.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from svd_lstm_tpu_torch.models.conv import inner_stack


@dataclasses.dataclass(frozen=True)
class PolynomialDecaySchedule:
    """tfmot ``PolynomialDecay``: sparsity ramps from ``initial_sparsity`` at
    ``begin_step`` to ``final_sparsity`` at ``end_step`` as
    ``1 - (1 - t)^power``."""

    initial_sparsity: float = 0.0
    final_sparsity: float = 0.5
    begin_step: int = 0
    end_step: int = 5000
    power: int = 3

    def __call__(self, step: int) -> float:
        if step < self.begin_step:
            return 0.0
        t = min(1.0, (step - self.begin_step) / max(1, self.end_step - self.begin_step))
        return self.final_sparsity + (self.initial_sparsity - self.final_sparsity) * (
            (1.0 - t) ** self.power
        )


def magnitude_mask(values: np.ndarray, sparsity: float) -> np.ndarray:
    """Per-tensor magnitude mask: zero the smallest-|v| ``floor(sparsity ·
    size)`` entries (tfmot prunes each weight tensor on its own)."""
    v = np.asarray(values)
    k = int(np.floor(sparsity * v.size))
    mask = np.ones(v.shape, v.dtype)
    if k <= 0:
        return mask
    order = np.argsort(np.abs(v), axis=None, kind="stable")
    mask.flat[order[:k]] = 0.0
    return mask


def prune_sigmas(smodel, sparsity: float):
    """A copy of a ``SingularLSTM`` (or ``ConvSingularLSTM``: its stack) with
    the smallest-magnitude ``sparsity`` share of every σ vector zeroed, each
    layer's σ_w and σ_u on their own."""
    out = copy.deepcopy(smodel)
    with torch.no_grad():
        for layer in inner_stack(out).layers:
            for p in (layer.ws, layer.us):
                mask = magnitude_mask(p.detach().cpu().numpy(), sparsity)
                p.mul_(torch.from_numpy(mask).to(p.device))
    return out


def sigma_sparsity(smodel) -> float:
    """The share of exactly-zero entries over every σ vector."""
    total = zeros = 0
    for layer in inner_stack(smodel).layers:
        for v in (layer.ws, layer.us):
            total += v.numel()
            zeros += int((v == 0.0).sum())
    return zeros / total


def finetune_with_pruning(
    smodel,
    X_train,
    y_train,
    schedule: PolynomialDecaySchedule = PolynomialDecaySchedule(),
    steps_per_epoch: int | None = None,
    **finetune_kwargs,
):
    """Fine-tune with the pruning mask applied after every epoch at the
    schedule's sparsity of ``(epoch + 1) · steps_per_epoch``. tfmot zeroes
    masked weights every train step; here a σ pruned at an epoch's end may
    regrow within the next epoch before the next, tighter mask zeroes it
    again; under the monotone schedule the end state has the same sparsity.
    One window set serves the whole loop, each epoch is one ``finetune``
    at ``seed + epoch``, Adam's moments carry across epochs, and the result's
    history, validation history and rollbacks sum over the epochs."""
    from svd_lstm_tpu_torch.config import FactorConfig, TrainConfig
    from svd_lstm_tpu_torch.data.batcher import split_train_random
    from svd_lstm_tpu_torch.train.finetune import finetune

    factor_cfg = finetune_kwargs.pop("factor_cfg", FactorConfig())
    train_cfg = finetune_kwargs.pop("train_cfg", None)
    if train_cfg is None:
        train_cfg = TrainConfig(epochs=factor_cfg.finetune_epochs,
                                batch_size=factor_cfg.finetune_batch_size)
    if steps_per_epoch is None:
        steps_per_epoch = max(1, train_cfg.num_windows // train_cfg.batch_size)
    windows = finetune_kwargs.pop("windows", None)
    if windows is None:
        windows = split_train_random(X_train, y_train, train_cfg.num_windows, train_cfg.window_len,
                                     seed=train_cfg.seed)
    # the window set moves to the model's device once; every epoch gathers from it
    device = next(smodel.parameters()).device
    finetune_kwargs["windows"] = tuple(torch.as_tensor(w, dtype=torch.float32, device=device)
                                       for w in windows)

    model, result, opt_state = smodel, None, None
    history, val_history, rollbacks = [], [], 0
    for epoch in range(train_cfg.epochs):
        one = dataclasses.replace(train_cfg, epochs=1, seed=train_cfg.seed + epoch)
        result = finetune(model, X_train, y_train, factor_cfg=factor_cfg, train_cfg=one,
                          init_opt_state=opt_state, **finetune_kwargs)
        opt_state = result.opt_state
        history.extend(result.history)
        val_history.extend(result.val_history or [])
        rollbacks += result.rollbacks
        model = prune_sigmas(result.params, schedule((epoch + 1) * steps_per_epoch))
    if result is not None:
        result.params = model
        result.history = history
        result.val_history = val_history or result.val_history
        result.rollbacks = rollbacks
    return result
