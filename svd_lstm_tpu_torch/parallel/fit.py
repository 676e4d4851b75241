"""The data-parallel training loops: the sharded counterparts of ``fit``,
``finetune`` and ``finetune_reduced``.

Counterpart of ``svd_lstm_tpu/parallel/fit.py``. Every rank of the mesh
calls the same function with the same model, data and config, and gets the
same ``TrainResult`` back:

* the window set is drawn once, as ``fit`` draws it (same sampler, same
  seed), and moves to the rank's device;
* every rank draws the same (seed + epoch) permutation; rank ``r`` of ``W``
  takes rows ``[r·B/W, (r+1)·B/W)`` of each minibatch (the JAX package's
  ``P(None, "dp")``); ``batch_size % W != 0`` raises;
* each step's gradients and loss are summed over the ranks in one flat
  buffer and divided by ``W`` (``parallel.train.mean_grads``), so every
  rank applies the same Adam update, and the same NaN-rollback decision;
* dropout masks come from ``train.loop.batch_generator`` with the rank
  folded in (the JAX package folds in the dp index): independent across
  ranks, the same on every run;
* the loop is ``fit``'s (validation, history, NaN rollback,
  ``cfg.auto_flags``), given the rank's part of each batch
  (``train.loop.BatchShard``); rank 0 alone writes the checkpoint.

The gradient math is the single-device trainer's: per-rank mean losses and
gradients averaged over equal parts are the full batch's, so ``fit_dp``
reproduces ``fit`` to float32 summation order (at one rank, exactly).
``cfg.recurrence_kernel`` is honoured as ``fit`` honours it: each rank
runs the train kernels (K7, K8, K9 or K6) on its part.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from svd_lstm_tpu_torch.config import TrainConfig
from svd_lstm_tpu_torch.parallel.mesh import Mesh
from svd_lstm_tpu_torch.parallel.train import mean_grads
from svd_lstm_tpu_torch.train.loop import BatchShard, TrainResult, fit


def fit_dp(
    model: torch.nn.Module,
    X_train: np.ndarray,
    y_train: np.ndarray,
    mesh: Mesh,
    cfg: TrainConfig = TrainConfig(),
    apply_fn: Callable | None = None,
    optimizer: Callable[[torch.nn.Module], torch.optim.Optimizer] | None = None,
    loss_extra: Callable | None = None,
    verbose: bool = False,
    windows: tuple | None = None,
    init_opt_state: dict | None = None,
    dropout_seed: int | None = None,
    validation: tuple | None = None,
    checkpoint_path: str | None = None,
) -> TrainResult:
    """Data-parallel ``fit`` over every rank of ``mesh``: ``fit``'s loop on
    a copy of ``model`` on ``mesh.device``, each minibatch split along its
    batch axis, the gradients averaged. The arguments are ``fit``'s
    (``apply_fn``: the exact forward, by default the family's;
    ``optimizer(model)``: Adam by default; ``dropout_seed``: fresh masks
    each batch, the rank folded in). ``cfg.batch_size`` must be divisible
    by the world size."""
    W = mesh.world
    if cfg.batch_size % W:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by {W} devices")
    local = cfg.batch_size // W
    shard = BatchShard(rows=slice(mesh.rank * local, (mesh.rank + 1) * local), rank=mesh.rank,
                       reduce=lambda params, loss: mean_grads(params, loss, None, W))
    if next(model.parameters()).device != mesh.device:
        model = copy.deepcopy(model).to(mesh.device)  # fit trains a copy of this one
    return fit(
        model, X_train, y_train, cfg, apply_fn=apply_fn, optimizer=optimizer, loss_extra=loss_extra,
        validation=validation, checkpoint_path=checkpoint_path if mesh.rank == 0 else None,
        verbose=verbose and mesh.rank == 0, windows=windows, init_opt_state=init_opt_state,
        dropout_seed=dropout_seed, shard=shard,
    )


def finetune_dp(
    smodel,
    X_train: np.ndarray,
    y_train: np.ndarray,
    mesh: Mesh,
    factor_cfg=None,
    train_cfg: TrainConfig | None = None,
    verbose: bool = False,
    init_opt_state: dict | None = None,
) -> TrainResult:
    """dp singular fine-tune (Adam over σ and the head, the factors too
    with ``train_uv``; Hoyer and orthogonality in the loss; Keras-semantics
    dropout when configured): the sharded ``train.finetune.finetune``. Takes
    a ``SingularLSTM`` or a ``ConvSingularLSTM``."""
    from svd_lstm_tpu_torch.config import FactorConfig
    from svd_lstm_tpu_torch.models.conv import ConvSingularLSTM, conv_singular_apply
    from svd_lstm_tpu_torch.models.singular import SingularLSTM, singular_lstm_apply
    from svd_lstm_tpu_torch.train.finetune import (
        dropout_apply_fn,
        make_finetune_optimizer,
        regularization_loss,
    )

    if isinstance(smodel, SingularLSTM):
        base_apply = singular_lstm_apply
    elif isinstance(smodel, ConvSingularLSTM):
        base_apply = conv_singular_apply
    else:
        raise TypeError(f"finetune_dp takes a factorized model, not {type(smodel).__name__}")
    if factor_cfg is None:
        factor_cfg = FactorConfig()
    if train_cfg is None:
        train_cfg = TrainConfig(epochs=factor_cfg.finetune_epochs,
                                batch_size=factor_cfg.finetune_batch_size)
    apply_fn, dropout_seed = dropout_apply_fn(factor_cfg, train_cfg.seed,
                                              remat_chunk=train_cfg.remat_chunk, base_apply=base_apply)
    return fit_dp(
        smodel, X_train, y_train, mesh, cfg=train_cfg, apply_fn=apply_fn,
        optimizer=lambda m: make_finetune_optimizer(m, factor_cfg, train_cfg.learning_rate),
        loss_extra=lambda m: regularization_loss(m, factor_cfg),
        verbose=verbose, init_opt_state=init_opt_state, dropout_seed=dropout_seed,
    )


def finetune_reduced_dp(
    rmodel,
    X_train: np.ndarray,
    y_train: np.ndarray,
    mesh: Mesh,
    train_cfg: TrainConfig | None = None,
    verbose: bool = False,
    init_opt_state: dict | None = None,
    windows: tuple | None = None,
    validation: tuple | None = None,
) -> TrainResult:
    """dp post-truncation recovery fine-tune (Adam over the two-step
    factors, biases and head): the sharded ``train.finetune.
    finetune_reduced``. Takes a ``ReducedLSTM`` (``recurrence_kernel``
    trains it through the train kernels) or a ``ConvReducedLSTM``."""
    from svd_lstm_tpu_torch.train.finetune import reduced_apply_fn

    return fit_dp(
        rmodel, X_train, y_train, mesh, cfg=TrainConfig() if train_cfg is None else train_cfg,
        apply_fn=reduced_apply_fn(rmodel), verbose=verbose, init_opt_state=init_opt_state,
        windows=windows, validation=validation,
    )

