"""Singular-model fine-tuning with Hoyer + orthogonality regularization.

Counterpart of ``svd_lstm_tpu/train/finetune.py`` (``finetune`` and its
helpers): after factorization, retrain with the window-end MSE plus a
Hoyer penalty on every σ vector (optionally a trace-norm penalty, and an
orthogonality penalty on the U/V factors, in which case the factors train
too).

The JAX package masks the updates of frozen leaves inside optax. Here Adam
runs over the trainable parameters only: the same updates for those, and
the frozen factors stay bit-identical. σ vectors and the head always train;
factors and biases train only with ``train_uv`` (or ``orthogonal > 0``).

Not ported yet (ROADMAP queue 1, item 4): dropout fine-tunes,
``finetune_reduced``, ``recover_reduced_gated``,
``truncate_recover_progressive`` and the QAT hooks.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.config import FactorConfig, TrainConfig
from svd_lstm_tpu_torch.factor.regularizers import (
    hoyer_penalty,
    orthogonal_penalty,
    trace_norm_penalty,
)
from svd_lstm_tpu_torch.models.singular import SingularLSTM, singular_lstm_apply
from svd_lstm_tpu_torch.train.loop import TrainResult, fit

_FACTORS = ("wl", "wr", "ul", "ur")


def regularization_loss(model: SingularLSTM, cfg: FactorConfig) -> torch.Tensor:
    """Σ layers: hoyer(σ_w) + hoyer(σ_u) [+ trace_norm(σ)] [+ orthogonal
    (U/V factors)]."""
    total = torch.zeros((), dtype=model.head.w.dtype, device=model.head.w.device)
    for layer in model.layers:
        if cfg.hoyer:
            total = total + hoyer_penalty(layer.ws, cfg.hoyer)
            total = total + hoyer_penalty(layer.us, cfg.hoyer)
        if cfg.trace_norm:
            total = total + trace_norm_penalty(layer.ws, cfg.trace_norm)
            total = total + trace_norm_penalty(layer.us, cfg.trace_norm)
        if cfg.orthogonal:
            for name in _FACTORS:
                total = total + orthogonal_penalty(getattr(layer, name), cfg.orthogonal, mode="rows")
    return total


def trainable_mask(model: SingularLSTM, train_uv: bool) -> dict:
    """{parameter name: receives updates}, over ``model.named_parameters()``."""
    mask = {}
    for name, _ in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        mask[name] = name.startswith("head.") or leaf in ("ws", "us") or train_uv
    return mask


def make_finetune_optimizer(
    model: SingularLSTM, cfg: FactorConfig, learning_rate: float = 1e-3
) -> torch.optim.Optimizer:
    """Adam over the trainable parameters of ``model`` only."""
    mask = trainable_mask(model, cfg.train_uv or bool(cfg.orthogonal))
    return torch.optim.Adam(
        [p for name, p in model.named_parameters() if mask[name]], lr=learning_rate
    )


def finetune(
    smodel: SingularLSTM,
    X_train,
    y_train,
    factor_cfg: FactorConfig = FactorConfig(),
    train_cfg: TrainConfig | None = None,
    verbose: bool = False,
    init_opt_state=None,
    windows: tuple | None = None,
) -> TrainResult:
    """Fine-tune a copy of a factorized model on the model's device (the
    windows move there); returns the ``TrainResult`` of :func:`fit`.
    Without ``train_cfg`` it trains for ``finetune_epochs`` at
    ``finetune_batch_size``."""
    if not isinstance(smodel, SingularLSTM):
        raise NotImplementedError(
            f"finetune of {type(smodel).__name__} is not ported yet (conv hybrids: "
            "ROADMAP queue 1, item 7)"
        )
    if factor_cfg.dropout > 0.0 or factor_cfg.recurrent_dropout > 0.0:
        raise NotImplementedError(
            "dropout fine-tunes are not ported yet (ROADMAP queue 1, item 4: dropout "
            "and remat of the model applies)"
        )
    if train_cfg is None:
        train_cfg = TrainConfig(
            epochs=factor_cfg.finetune_epochs,
            batch_size=factor_cfg.finetune_batch_size,
        )
    return fit(
        smodel,
        X_train,
        y_train,
        cfg=train_cfg,
        apply_fn=singular_lstm_apply,
        optimizer=lambda m: make_finetune_optimizer(m, factor_cfg, train_cfg.learning_rate),
        loss_extra=lambda m: regularization_loss(m, factor_cfg),
        verbose=verbose,
        init_opt_state=init_opt_state,
        windows=windows,
    )
