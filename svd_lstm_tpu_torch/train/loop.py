"""Full-model windowed-BPTT trainer.

Counterpart of ``svd_lstm_tpu/train/loop.py``: sample ``num_windows``
random windows of ``window_len`` steps, Adam on the window-end MSE,
``epochs`` passes, with NaN-loss rollback to the last good parameters and
optimizer state, per-epoch validation and save-best checkpointing.

The epoch order is the JAX package's, in both of its modes:
``np.random.default_rng(seed + epoch).permutation(n)``, then the first
``n // batch_size * batch_size`` windows in batches. PyTorch runs eagerly,
so the ``jit_epoch`` switch of the JAX ``fit`` has no counterpart.

Adam is ``torch.optim.Adam(lr)``, whose update is optax's ``adam`` (b1 0.9,
b2 0.999, eps 1e-8 outside the square root, bias-corrected moments), on
float32 parameters in every regime. The train steps (loss, forward and
backward) run under ``train_matmul_scope(cfg.matmul_precision)``: the
step's products in the regime (the dense-view reconstructions exact), as
the JAX ``fit`` wraps its loss in ``jax.default_matmul_precision``.
Validation always runs exact.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from svd_lstm_tpu_torch.api import exact_matmul
from svd_lstm_tpu_torch.config import TrainConfig, check_train_config
from svd_lstm_tpu_torch.data.batcher import split_train_random
from svd_lstm_tpu_torch.models.conv import conv_lstm_apply, conv_reduced_apply, conv_singular_apply
from svd_lstm_tpu_torch.models.lstm import stacked_lstm_apply
from svd_lstm_tpu_torch.models.reduced import reduced_lstm_apply
from svd_lstm_tpu_torch.models.singular import singular_lstm_apply
from svd_lstm_tpu_torch.utils.precision import train_matmul_scope


@dataclasses.dataclass
class TrainResult:
    params: Any                        # the trained model (a copy of the input)
    history: list                      # per-epoch mean loss
    rollbacks: int = 0                 # NaN-rollback count
    val_history: list = dataclasses.field(default_factory=list)
    opt_state: Any = None              # the optimizer's final state_dict


def mse_last_step(model, x, y, apply_fn) -> torch.Tensor:
    """Mean squared error of the window-end prediction."""
    pred = apply_fn(model, x, return_sequences=False)[..., 0]
    return torch.mean(torch.square(pred - y))


def make_val_fn(exact_apply_fn: Callable, validation: tuple | None, device) -> Callable | None:
    """Whole-run validation MSE on the exact forward, or None. Accepts Xv
    (B, T, d) with yv shaped (T,), (B, T) or (B*T,): both sides are
    flattened."""
    if validation is None:
        return None
    Xv = torch.as_tensor(np.asarray(validation[0]), device=device)
    yv = torch.as_tensor(np.asarray(validation[1]).reshape(-1), device=device)

    @torch.no_grad()
    def val_fn(model) -> float:
        with exact_matmul():
            pred = exact_apply_fn(model, Xv, return_sequences=True)[..., 0].reshape(-1)
            return float(torch.mean(torch.square(pred - yv)))

    return val_fn


def drive_epochs(
    cfg: TrainConfig,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    epoch_step: Callable[[int], float],
    *,
    val_fn: Callable | None = None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
) -> TrainResult:
    """The epoch loop: NaN rollback, loss and validation history,
    save-best checkpointing. ``epoch_step(epoch) -> mean loss`` trains one
    epoch in place.

    NaN rollback restores the model's and the optimizer's state_dict, as
    the reference's in-process checkpoint reload kept Keras' optimizer
    moments. Save-best by training loss is the reference's
    ModelCheckpoint(save_best_only)."""
    last_good = copy.deepcopy(model.state_dict())
    last_good_opt = copy.deepcopy(optimizer.state_dict())
    history: list = []
    val_history: list = []
    rollbacks = 0
    best_loss = float("inf")
    for epoch in range(cfg.epochs):
        epoch_loss = epoch_step(epoch)
        if cfg.nan_rollback and not np.isfinite(epoch_loss):
            model.load_state_dict(last_good)
            # a copy: the optimizer may keep the loaded tensors and update them in place
            optimizer.load_state_dict(copy.deepcopy(last_good_opt))
            rollbacks += 1
            if verbose:
                print(f"epoch {epoch}: NaN loss — rolled back")
            continue
        last_good = copy.deepcopy(model.state_dict())
        last_good_opt = copy.deepcopy(optimizer.state_dict())
        history.append(epoch_loss)
        msg = f"epoch {epoch}: loss {epoch_loss:.6f}"
        if val_fn is not None:
            val_loss = val_fn(model)
            val_history.append(val_loss)
            msg += f"  val {val_loss:.6f}"
        if checkpoint_path is not None and epoch_loss < best_loss:
            best_loss = epoch_loss
            from svd_lstm_tpu_torch.io.checkpoint import save_params

            save_params(checkpoint_path, model)
        if verbose:
            print(msg)
    return TrainResult(
        params=model, history=history, rollbacks=rollbacks,
        val_history=val_history, opt_state=optimizer.state_dict(),
    )


def resolve_train_apply_fn(cfg: TrainConfig, apply_fn: Callable) -> tuple:
    """The kernel swap of the training step. Returns ``(apply_fn,
    using_kernel)``. With ``cfg.recurrence_kernel`` the dense scan, the σ
    fine-tune and the reduced recovery run through the CUDA train kernels
    (``ops/cuda_train.py``, ``ops/singular_train.py``,
    ``ops/reduced_train.py``; on CPU tensors through their plain versions):
    the float32 kernels, or their bf16-operand variants under
    ``matmul_precision="bfloat16"``. As in the JAX package, the dense scan
    passes ``cfg.compact_gates`` to the dispatch and the singular and
    reduced views keep its "auto". The conv hybrids' applies run their
    front end and then the same kernels (``ops/conv_train.py``, "auto").
    Other applies keep their scan."""
    if not cfg.recurrence_kernel:
        return apply_fn, False
    bf16 = cfg.matmul_precision == "bfloat16"
    if apply_fn is stacked_lstm_apply:
        from svd_lstm_tpu_torch.ops.cuda_train import stacked_lstm_apply_fast_train

        return functools.partial(stacked_lstm_apply_fast_train, compact=cfg.compact_gates,
                                 bf16=bf16), True
    if apply_fn is singular_lstm_apply:
        from svd_lstm_tpu_torch.ops.singular_train import singular_lstm_apply_fast_train

        return functools.partial(singular_lstm_apply_fast_train, bf16=bf16), True
    if apply_fn is reduced_lstm_apply:
        from svd_lstm_tpu_torch.ops.reduced_train import reduced_lstm_apply_fast_train

        return functools.partial(reduced_lstm_apply_fast_train, bf16=bf16), True
    if apply_fn in (conv_lstm_apply, conv_singular_apply, conv_reduced_apply):
        from svd_lstm_tpu_torch.ops import conv_train

        fast = {conv_lstm_apply: conv_train.conv_lstm_apply_fast_train,
                conv_singular_apply: conv_train.conv_singular_apply_fast_train,
                conv_reduced_apply: conv_train.conv_reduced_apply_fast_train}[apply_fn]
        return functools.partial(fast, bf16=bf16), True
    return apply_fn, False


def apply_cached_train_flags(cfg: TrainConfig, model, X_train, windows,
                             verbose: bool = False) -> TrainConfig:
    """``TrainConfig.auto_flags``: the read-only lookup of the autotune
    cache (``tune --train`` writes it) for the measured-best
    ``(matmul_precision, recurrence_kernel, compact_gates)`` of this model,
    window batch (batch_size, window_len or the windows' length, d) and
    device. A hit replaces the config's three flags; a miss returns the
    config unchanged and never measures."""
    from svd_lstm_tpu_torch.bench.autotune import cached_train_flags

    if windows is not None:
        shape = (cfg.batch_size, *tuple(windows[0].shape)[1:])
    else:
        shape = (cfg.batch_size, cfg.window_len, int(np.shape(X_train)[-1]))
    hit = cached_train_flags(model, shape)
    if hit is None:
        return cfg
    prec, kernel, compact = hit
    if verbose:
        print(f"auto_flags: tuned regime hit — matmul_precision={prec} "
              f"recurrence_kernel={kernel} compact_gates={compact}")
    return dataclasses.replace(cfg, matmul_precision=prec, recurrence_kernel=kernel,
                               compact_gates=compact)


def default_apply_fn(model) -> Callable:
    """The family's exact forward: dense, singular, reduced or one of their
    conv hybrids."""
    from svd_lstm_tpu_torch.models.conv import ConvLSTM, ConvReducedLSTM, ConvSingularLSTM
    from svd_lstm_tpu_torch.models.lstm import StackedLSTM
    from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
    from svd_lstm_tpu_torch.models.singular import SingularLSTM

    for family, apply_fn in ((StackedLSTM, stacked_lstm_apply), (SingularLSTM, singular_lstm_apply),
                             (ReducedLSTM, reduced_lstm_apply), (ConvLSTM, conv_lstm_apply),
                             (ConvSingularLSTM, conv_singular_apply),
                             (ConvReducedLSTM, conv_reduced_apply)):
        if isinstance(model, family):
            return apply_fn
    raise TypeError(f"no training forward for {type(model).__name__}")


def fit(
    model: torch.nn.Module,
    X_train: np.ndarray,
    y_train: np.ndarray,
    cfg: TrainConfig = TrainConfig(),
    apply_fn: Callable | None = None,
    optimizer: Callable[[torch.nn.Module], torch.optim.Optimizer] | None = None,
    loss_extra: Callable | None = None,
    validation: tuple | None = None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
    windows: tuple | None = None,
    init_opt_state: dict | None = None,
    loss_fn: Callable | None = None,
) -> TrainResult:
    """Train a copy of ``model`` on random windows of the (1, T, d) run, on
    the model's device (the windows move there once).

    ``apply_fn(model, x, return_sequences)``: the exact forward (default:
    the model family's). ``optimizer(model) -> torch.optim.Optimizer``
    builds the optimizer over the copy (default Adam over every
    parameter). ``loss_extra(model) -> scalar`` adds regularisation terms;
    ``loss_fn(model, x, y, apply_fn) -> scalar`` replaces the window-end
    MSE. ``validation=(X, y)`` evaluates the whole-run MSE each epoch on
    the exact forward. ``checkpoint_path`` saves the best-by-loss model.
    ``windows=(X_mini, y_mini)`` (arrays or tensors) replaces the random
    sampler.
    ``init_opt_state`` is an optimizer state_dict to start from (a
    ``TrainResult.opt_state``). ``cfg.auto_flags`` replaces the regime's
    flags by the autotune cache's on a hit (:func:`apply_cached_train_flags`)."""
    check_train_config(cfg)
    model = copy.deepcopy(model)
    if cfg.auto_flags:
        cfg = apply_cached_train_flags(cfg, model, X_train, windows, verbose)
        check_train_config(cfg)
    if apply_fn is None:
        apply_fn = default_apply_fn(model)
    exact_apply_fn = apply_fn  # validation always runs the exact forward
    apply_fn, _ = resolve_train_apply_fn(cfg, apply_fn)
    opt = (
        torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
        if optimizer is None
        else optimizer(model)
    )
    if init_opt_state is not None:
        opt.load_state_dict(copy.deepcopy(init_opt_state))
    data_loss = mse_last_step if loss_fn is None else loss_fn

    if windows is not None:
        X_mini, y_mini = windows
    else:
        X_mini, y_mini = split_train_random(
            X_train, y_train, cfg.num_windows, cfg.window_len, seed=cfg.seed
        )
    n = X_mini.shape[0]
    n_full = (n // cfg.batch_size) * cfg.batch_size
    if n_full == 0:
        # a zero-step epoch would average no losses, and the NaN rollback
        # would silently turn the whole run into a no-op
        raise ValueError(
            f"num_windows ({n}) < batch_size ({cfg.batch_size}): "
            "every epoch would run zero steps"
        )
    device = next(model.parameters()).device
    # the window set moves to the device once (a no-op for windows already
    # there); each epoch gathers from it
    X_dev = torch.as_tensor(X_mini, dtype=torch.float32, device=device)
    y_dev = torch.as_tensor(y_mini, dtype=torch.float32, device=device)
    val_fn = make_val_fn(exact_apply_fn, validation, device)

    def epoch_step(epoch: int) -> float:
        perm = np.random.default_rng(cfg.seed + epoch).permutation(n)[:n_full]
        idx = torch.as_tensor(perm, device=device)
        losses = []
        with train_matmul_scope(cfg.matmul_precision):
            for i in range(0, n_full, cfg.batch_size):
                sel = idx[i : i + cfg.batch_size]
                loss = data_loss(model, X_dev[sel], y_dev[sel], apply_fn)
                if loss_extra is not None:
                    loss = loss + loss_extra(model)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
        return float(torch.stack(losses).mean())

    return drive_epochs(
        cfg, model, opt, epoch_step,
        val_fn=val_fn, checkpoint_path=checkpoint_path, verbose=verbose,
    )


@torch.no_grad()
def predict_full_run(model, X: np.ndarray, apply_fn: Callable | None = None) -> np.ndarray:
    """Whole-run sequence prediction in exact mode, (1, T, d) -> (T,) on the
    host: the reference's return_sequences=True evaluation clone.
    ``apply_fn`` defaults to the model family's exact forward."""
    if apply_fn is None:
        apply_fn = default_apply_fn(model)
    x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=next(model.parameters()).device)
    with exact_matmul():
        out = apply_fn(model, x, return_sequences=True)
    return out[0, :, 0].cpu().numpy()
