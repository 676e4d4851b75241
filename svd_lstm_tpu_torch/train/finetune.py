"""Fine-tuning: the singular model under Hoyer + orthogonality
regularization, and the reduced model's post-truncation recovery.

Counterpart of ``svd_lstm_tpu/train/finetune.py``:

* ``finetune``: after factorization, retrain with the window-end MSE plus a
  Hoyer penalty on every σ vector (optionally a trace-norm penalty, and an
  orthogonality penalty on the U/V factors, in which case the factors train
  too). The JAX package masks the updates of frozen leaves inside optax.
  Here Adam runs over the trainable parameters only: the same updates for
  those, and the frozen factors stay bit-identical. σ vectors and the head
  always train; factors and biases train only with ``train_uv`` (or
  ``orthogonal > 0``).
* ``finetune_reduced``, ``recover_reduced_gated`` and
  ``truncate_recover_progressive``: retrain a truncated model's two-step
  factors (B, C), biases and head directly, so the recovered model keeps the
  compressed form. With ``recurrence_kernel=True`` they train through the
  dense train kernels (``ops/reduced_train.py``). The gate's optimizer is
  optax's ``chain(clip(clip), adam(lr))``: :class:`ClippedAdam`.

Not ported yet (ROADMAP queue 1, item 4): dropout fine-tunes and the QAT
hooks (``apply_fn`` / ``gate_apply_fn`` of the gate take any forward, but
the fake-quantized one is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from svd_lstm_tpu_torch.api import exact_matmul
from svd_lstm_tpu_torch.config import FactorConfig, TrainConfig
from svd_lstm_tpu_torch.data.batcher import split_train_random
from svd_lstm_tpu_torch.factor.regularizers import (
    hoyer_penalty,
    orthogonal_penalty,
    trace_norm_penalty,
)
from svd_lstm_tpu_torch.models.reduced import ReducedLSTM, reduced_lstm_apply
from svd_lstm_tpu_torch.models.singular import SingularLSTM, singular_lstm_apply
from svd_lstm_tpu_torch.train.loop import TrainResult, fit, make_val_fn

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


# ---------------------------------------------------------------------------
# post-truncation recovery of the reduced model
# ---------------------------------------------------------------------------

def reduced_apply_fn(model) -> Callable:
    """The reduced family's exact forward, shared by ``finetune_reduced`` and
    the gate: ``reduced_lstm_apply``. Conv hybrids are not ported."""
    if not isinstance(model, ReducedLSTM):
        raise NotImplementedError(
            f"recovery of {type(model).__name__} is not ported yet (conv hybrids: ROADMAP "
            "queue 1, item 7)"
        )
    return reduced_lstm_apply


def finetune_reduced(
    model: ReducedLSTM,
    X_train,
    y_train,
    train_cfg: TrainConfig | None = None,
    verbose: bool = False,
    init_opt_state=None,
    windows: tuple | None = None,
    validation: tuple | None = None,
) -> TrainResult:
    """Post-truncation recovery fine-tune of a copy of a reduced model: Adam
    on the window-end MSE over its two-step factors (B, C), biases and head,
    which keep their shapes, so the recovered model stays reduced. Returns
    the ``TrainResult`` of :func:`fit`."""
    return fit(
        model,
        X_train,
        y_train,
        cfg=TrainConfig() if train_cfg is None else train_cfg,
        apply_fn=reduced_apply_fn(model),
        verbose=verbose,
        init_opt_state=init_opt_state,
        windows=windows,
        validation=validation,
    )


class ClippedAdam(torch.optim.Adam):
    """Adam on gradients first clamped element by element to [−clip, clip]:
    optax's ``chain(clip(clip), adam(lr))`` (a per-element clamp, not a norm
    clip). The clamp keeps no state, so the state_dict is Adam's and a
    ``TrainResult.opt_state`` carries the moments into the next ``fit``."""

    def __init__(self, params, lr: float, clip: float):
        super().__init__(params, lr=lr)
        self.clip = clip

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedAdam.step takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.clamp_(-self.clip, self.clip)
        return super().step()


def recover_reduced_gated(
    model: ReducedLSTM,
    X_train,
    y_train,
    train_cfg: TrainConfig | None = None,
    lr_ladder: tuple = (3e-5, 1e-5, 3e-6),
    clip: float = 0.5,
    max_epochs: int = 6,
    validation: tuple | None = None,
    windows: tuple | None = None,
    verbose: bool = False,
    apply_fn=None,
    gate_apply_fn=None,
):
    """Validation-gated post-truncation recovery with a falling learning rate.

    One window set is drawn once (``split_train_random`` at
    ``train_cfg.seed``). Then, for at most ``max_epochs`` epochs:

    * train one epoch at the ladder's current rate (:class:`ClippedAdam`,
      ``fit`` at ``seed = train_cfg.seed + epoch``);
    * evaluate the whole-run MSE of ``validation`` (default: the training
      half) on the exact forward (``gate_apply_fn``, default ``apply_fn``);
    * accept when it is finite and below the best so far, keeping the
      parameters and Adam's moments;
    * otherwise roll back to the best parameters, step down the ladder and
      start Adam afresh; stop when the ladder is spent.

    The result is never worse than the raw truncation on the gate's metric.
    ``apply_fn`` is the training forward (default the family's,
    ``reduced_lstm_apply``, which ``recurrence_kernel`` swaps for the
    kernels). Returns ``(model, info)``: ``info`` holds the JAX package's
    keys, the recipe, ``raw_val_mse``, ``best_val_mse`` and the per-epoch
    ``trace`` of ``{"lr", "val_mse", "accepted"}``. As there, ``val_mse``
    is the MSE of ``validation``, by default the training half."""
    if train_cfg is None:
        train_cfg = TrainConfig()
    if validation is None:
        validation = (X_train, y_train)
    if apply_fn is None:
        apply_fn = reduced_apply_fn(model)
    device = next(model.parameters()).device
    val_fn = make_val_fn(gate_apply_fn or apply_fn, validation, device)
    if windows is None:
        windows = split_train_random(
            X_train, y_train, train_cfg.num_windows, train_cfg.window_len, seed=train_cfg.seed
        )
    # the window set moves to the device once; every one-epoch fit gathers from it
    windows = tuple(torch.as_tensor(w, dtype=torch.float32, device=device) for w in windows)

    best_model = model
    best_val = raw_val = val_fn(model)
    cur_model, opt_state = model, None
    ladder_idx, trace = 0, []
    if verbose:
        print(f"gated recovery: raw val MSE {best_val:.6f}", flush=True)
    for epoch in range(max_epochs):
        lr = lr_ladder[ladder_idx]
        res = fit(
            cur_model, X_train, y_train,
            cfg=dataclasses.replace(train_cfg, epochs=1, seed=train_cfg.seed + epoch),
            apply_fn=apply_fn,
            optimizer=lambda m, lr=lr: ClippedAdam(m.parameters(), lr=lr, clip=clip),
            windows=windows, init_opt_state=opt_state,
        )
        v = val_fn(res.params)
        accepted = bool(np.isfinite(v) and v < best_val)
        trace.append({"lr": lr, "val_mse": v, "accepted": accepted})
        if verbose:
            print(f"  epoch {epoch}: lr {lr:g}  val {v:.6f}  "
                  f"{'accepted' if accepted else 'rejected'}", flush=True)
        if accepted:
            best_model, best_val = res.params, v
            cur_model, opt_state = res.params, res.opt_state
        else:
            ladder_idx += 1
            if ladder_idx >= len(lr_ladder):
                break
            cur_model, opt_state = best_model, None
    gate_forward = (
        "exact forward"
        if gate_apply_fn is None and apply_fn is reduced_apply_fn(model)
        else getattr(gate_apply_fn or apply_fn, "__name__", "custom forward")
    )
    info = {
        "recipe": "val-gated lr-backoff recovery",
        "lr_ladder": list(lr_ladder),
        "clip": clip,
        "max_epochs": max_epochs,
        "gate": f"whole-run MSE on the train half ({gate_forward})",
        "raw_val_mse": raw_val,
        "best_val_mse": best_val,
        "trace": trace,
        "accepted_epochs": sum(t["accepted"] for t in trace),
    }
    return best_model, info


def truncate_recover_progressive(
    dense_model,
    X_train,
    y_train,
    ranks,
    train_cfg: TrainConfig | None = None,
    merged_kernel: bool = True,
    verbose: bool = False,
    **gate_kwargs,
):
    """Progressive truncate → recover → re-factorize down a strictly
    descending rank schedule (e.g. ``(32, 24)``): each stage factorizes the
    current dense model, truncates it to the stage's rank, runs
    :func:`recover_reduced_gated` (``gate_kwargs`` forwarded), and hands the
    recovered model's exact dense reconstruction to the next stage. Returns
    ``(reduced model, infos)``, one gate ``info`` per stage with its
    ``rank``."""
    from svd_lstm_tpu_torch.factor.svd import make_reduced_model, make_singular_model
    from svd_lstm_tpu_torch.ops.layouts import reconstruct_dense_model

    if not all(a > b for a, b in zip(ranks, ranks[1:])):
        raise ValueError(f"ranks must be strictly descending: {ranks}")
    dense = dense_model
    rmod, infos = None, []
    for r in ranks:
        smodel = make_singular_model(dense, merged_kernel=merged_kernel)
        rmod = make_reduced_model(smodel, cutoff=None, rank=r)
        if verbose:
            print(f"progressive: rank {r}", flush=True)
        rmod, info = recover_reduced_gated(
            rmod, X_train, y_train, train_cfg=train_cfg, verbose=verbose, **gate_kwargs
        )
        infos.append({"rank": r, **info})
        with exact_matmul():
            dense = reconstruct_dense_model(rmod)
    return rmod, infos


def harvest_sigmas(smodel: SingularLSTM) -> list:
    """Every layer's (σ_w, σ_u) as numpy arrays, as the reference collects
    them after fine-tuning."""
    return [(l.ws.detach().cpu().numpy(), l.us.detach().cpu().numpy()) for l in smodel.layers]
