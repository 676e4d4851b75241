"""``train.loop.fit``, one call an epoch, the model and Adam's state carried
from call to call.

Set-up makes the window set once on the device (``num_windows`` windows of
``window_len`` frames at distinct offsets drawn from the seed in the training part of
the seeded DROPBEAR-shaped run, labelled with the pin location at the
window's end) and drives the model from its weights through the first
``checked_steps`` steps with the window's own call, ``fit(...,
windows=...)``: the first step alone, on the first batch of rows, so that
Adam's state after it holds the first gradient; then the others in one call
over the next ``checked_steps - 1`` batches of rows, which the call shuffles
by its epoch's seed and gathers batch by batch as the window's epochs do.
No two checked steps see a row in common. The window then runs whole
epochs over the full set until ``seconds`` have passed, each epoch with its
own shuffle.

Parameters (``benchmark/traffic/<mix>.json``): ``batch_size``,
``window_len``, ``num_windows``, ``learning_rate``, ``matmul_precision``,
``recurrence_kernel``, ``checked_steps``, ``split_time`` (s; windows lie
before it), ``signal``.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import Any

import numpy as np
import torch

from benchmark.core import checks, models, signal
from benchmark.core.record import Call
from benchmark.counts import lstm as counts
from benchmark.reference import lstm as reference

# the sides of numbers() that calibrate.py reads beside the control: half of each batch,
# or a state returned unchanged, in every checked step or from the second on
FAULTS = ("half_batch", "half_batch_later", "unchanged", "unchanged_later")


@dataclasses.dataclass
class State:
    cell: Any
    seed: int
    device: torch.device
    model: Any
    opt: Any                 # the optimizer's state_dict, carried from call to call
    X: torch.Tensor          # (num_windows, window_len, d) on the device
    Y: torch.Tensor          # (num_windows,)
    cfg: Any                 # TrainConfig
    first: dict              # the checked steps: losses, first_grads, start, after1, params
    cost: dict               # counts.train_step
    layers: int
    steps: int
    calls_done: int = 0


def launch_counters() -> dict:
    from svd_lstm_tpu_torch.ops import cuda_train

    return dict(cuda_train.LAUNCHES)


def _fit(st: State, X, Y, cfg):
    from svd_lstm_tpu_torch.train import loop

    with torch.profiler.record_function("benchmark.fit"):
        res = loop.fit(st.model, None, None, cfg, windows=(X, Y), init_opt_state=st.opt)
        if st.device.type == "cuda":
            torch.cuda.synchronize()
    st.model, st.opt = res.params, res.opt_state
    return res


def setup(cell, seed: int, device) -> State:
    from svd_lstm_tpu_torch.config import TrainConfig

    tr = cell.traffic
    Xf, yf = signal.frames(seed, **tr["signal"])
    B, W, N = int(tr["batch_size"]), int(tr["window_len"]), int(tr["num_windows"])
    n_train = int(tr["split_time"] / (signal.SAMPLING_PERIOD * Xf.shape[1]))
    starts = np.random.default_rng([seed, 1]).choice(n_train - W, size=N, replace=False)
    s = torch.from_numpy(starts).to(device)
    X = torch.from_numpy(Xf).to(device)[s[:, None] + torch.arange(W, device=device)]
    Y = torch.from_numpy(yf).to(device)[s + W]
    cfg = TrainConfig(num_windows=N, window_len=W, batch_size=B, epochs=1,
                      learning_rate=float(tr["learning_rate"]),
                      matmul_precision=tr["matmul_precision"],
                      recurrence_kernel=bool(tr["recurrence_kernel"]), seed=0)
    model = models.program_model(cell.config, "dense", seed, device)
    st = State(cell=cell, seed=seed, device=device, model=model, opt=None, X=X, Y=Y, cfg=cfg,
               first={}, cost=counts.train_step(cell.config, B, W),
               layers=len(cell.config["units"]), steps=W)
    names = [k for k, _ in model.named_parameters()]
    params = lambda: {k: p.detach().clone() for k, p in st.model.named_parameters()}
    start = params()
    res = _fit(st, X[:B], Y[:B], cfg)
    b1 = st.opt["param_groups"][0]["betas"][0]
    grads = {k: st.opt["state"][i]["exp_avg"].detach() / (1 - b1) for i, k in enumerate(names)}
    after1 = params()
    losses = [res.history[0] if res.history else float("nan")]
    later = int(tr["checked_steps"]) - 1
    if later:
        res = _fit(st, X[B:(1 + later) * B], Y[B:(1 + later) * B],
                   dataclasses.replace(cfg, seed=seed))
        losses.append(res.history[0] if res.history else float("nan"))
    st.first = {"losses": losses, "first_grads": grads, "start": start, "after1": after1,
                "params": params()}
    return st


def epoch_order(seed: int, rows: int, batch: int) -> np.ndarray:
    """The rows of a ``fit`` call's epoch 0 in the order its steps take
    them: ``default_rng(seed).permutation(rows)``, the whole batches only
    (the rule ``train.loop.fit`` documents, worked out again here)."""
    return np.random.default_rng(seed).permutation(rows)[:(rows // batch) * batch]


def route(st: State) -> str:
    """The train kernels one step launches."""
    before = launch_counters()
    rows = slice(0, st.cfg.batch_size)
    model, opt = st.model, st.opt
    _fit(st, st.X[rows], st.Y[rows], st.cfg)
    st.model, st.opt = model, opt  # a look only: the carried state stays as it was
    launched = {k: v - before[k] for k, v in launch_counters().items() if v != before[k]}
    return f"TrainConfig {st.cfg}, launches a step: {launched}"


def window(st: State, seconds: float) -> tuple:
    """``(t_start, calls)``: whole epochs until ``seconds`` have passed."""
    steps = (st.X.shape[0] // st.cfg.batch_size)
    frames = steps * st.cfg.batch_size * st.steps
    calls = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        cfg = dataclasses.replace(st.cfg, seed=st.seed + st.calls_done)  # each epoch its own shuffle
        st.calls_done += 1
        t0 = time.perf_counter()
        try:
            res = _fit(st, st.X, st.Y, cfg)
        except Exception:  # a failed epoch is counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            t = time.perf_counter()
            calls.append(Call(t0, t, t, 0, 0.0, 0.0, ok=False))
            continue
        t = time.perf_counter()
        calls.append(Call(t0, t, t, frames, steps * st.cost["flops"], steps * st.cost["bound_s"],
                          ok=not res.rollbacks))
    return t_start, calls


def numbers(st: State, sides=("program",)) -> dict:
    """``{side: train_numbers}`` of the checked steps against the float64
    reference, which follows them from the same weights on the same rows,
    in the order the checked call shuffled them. The program's state is
    freed first. Sides: ``"program"``, the steps set-up drove;
    ``"control"``, the reference computed in TF32 in the program's place;
    the faults ``"half_batch"`` (the reference in float64 on the first half
    of each batch, the mean taken over it), ``"half_batch_later"`` (the same
    from the second step on), ``"unchanged"`` (steps that return the state
    they were given) and ``"unchanged_later"`` (the steps after the first
    do so: the program's state after its first step)."""
    B, n = st.cfg.batch_size, int(st.cell.traffic["checked_steps"])
    order = epoch_order(st.seed, (n - 1) * B, B)  # the checked call's shuffle seed
    rows = torch.cat([torch.arange(B), B + torch.from_numpy(order)]).to(st.X.device)
    xs, ys = st.X[rows].clone(), st.Y[rows].clone()
    program = st.first
    st.model = st.opt = st.X = st.Y = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    layers, head = models.reference_weights(st.cell.config, "dense", st.seed, st.device)
    batches = [(xs[i * B:(i + 1) * B], ys[i * B:(i + 1) * B]) for i in range(n)]
    halves = [(x[:B // 2], y[:B // 2]) for x, y in batches]
    lr = st.cfg.learning_rate
    ref = later_mean(reference.train_steps(layers, head, batches, lr, "float64"))
    out = {}
    for side in sides:
        if side == "program":
            got = program
        elif side == "control":
            got = later_mean(reference.train_steps(layers, head, batches, lr, "tf32"))
        elif side == "half_batch":
            got = later_mean(reference.train_steps(layers, head, halves, lr, "float64"))
        elif side == "half_batch_later":
            got = later_mean(reference.train_steps(layers, head, batches[:1] + halves[1:], lr,
                                                   "float64"))
        elif side == "unchanged":
            got = dict(program, losses=[program["losses"][0]] * len(program["losses"]),
                       params=program["start"])
        elif side == "unchanged_later":
            got = dict(program, params=program["after1"])
        else:
            raise ValueError(f"unknown side {side!r}")
        out[side] = checks.train_numbers(got, ref)
    return out


def later_mean(steps: dict) -> dict:
    """The reference's step losses as the program reports them: the first
    step's, then the mean of the later steps' (one ``fit`` call's epoch
    loss)."""
    losses = steps["losses"]
    return dict(steps, losses=losses[:1] + ([sum(losses[1:]) / len(losses[1:])] if losses[1:] else []))
