"""Whole-run batch-1 ``predict``, one client in a closed loop.

Each call is ``api.predict(model, x, impl, precision)`` on a sequence of
``T`` frames it has not seen before (a window of the seeded DROPBEAR-shaped
run at an offset drawn from the seed), and reads the prediction back to the
host; the next call is issued when it is there. Every seed sends the same
sizes, so the work does not depend on the seed.

Parameters (``benchmark/traffic/<mix>.json``): ``form`` ("dense" or
"reduced", of the configuration), ``T``, ``impl``, ``precision``,
``warmup_calls`` (set-up), ``sample_calls`` (the calls the reference
checks), ``signal`` (``core.signal.frames``' duration and noise).
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

OFFSETS = 1 << 16  # offsets drawn ahead, reused in turn past that many calls
FAULTS = ()  # the sides of numbers() that calibrate.py reads beside the control


@dataclasses.dataclass
class State:
    cell: Any
    seed: int
    device: torch.device
    model: Any
    X: np.ndarray            # the run's frames, on the host
    frames: torch.Tensor     # the same, on the device
    offsets: np.ndarray
    cost: dict               # counts.predict_call
    layers: int
    steps: int
    outputs: list = dataclasses.field(default_factory=list)
    used: list = dataclasses.field(default_factory=list)


def launch_counters() -> dict:
    """The program's launch counters, copied."""
    from svd_lstm_tpu_torch.ops import cuda_lstm

    return dict(cuda_lstm.LAUNCHES)


def _call(st: State, o: int, keep: bool) -> Call:
    from svd_lstm_tpu_torch import api

    tr = st.cell.traffic
    x = st.frames[o:o + st.steps]
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function("benchmark.predict"):
            out = api.predict(st.model, x, impl=tr["impl"], precision=tr["precision"])
        t_ret = time.perf_counter()
        with torch.profiler.record_function("benchmark.readback"):
            y = out.cpu().numpy()
    except Exception:  # a failed call is counted, and the loop goes on
        traceback.print_exc(file=sys.stderr)
        t = time.perf_counter()
        return Call(t0, t, t, 0, 0.0, 0.0, ok=False)
    t_done = time.perf_counter()
    if keep:
        st.outputs.append(y)
        st.used.append(o)
    return Call(t0, t_ret, t_done, st.steps, st.cost["flops"], st.cost["bound_s"])


def setup(cell, seed: int, device) -> State:
    tr = cell.traffic
    X, _ = signal.frames(seed, **tr["signal"])
    T = int(tr["T"])
    rng = np.random.default_rng([seed, 1])
    st = State(cell=cell, seed=seed, device=device,
               model=models.program_model(cell.config, tr["form"], seed, device),
               X=X, frames=torch.from_numpy(X).to(device),
               offsets=rng.integers(0, X.shape[0] - T + 1, size=OFFSETS),
               cost=counts.predict_call(cell.config, tr["form"], T),
               layers=len(cell.config["units"]), steps=T)
    for o in rng.integers(0, X.shape[0] - T + 1, size=int(tr["warmup_calls"])):
        if not _call(st, int(o), keep=False).ok:
            raise RuntimeError("a warm-up call failed")
    return st


def route(st: State) -> str:
    """What ``impl="auto"`` runs here: the autotune cache's winner, if
    any, and the kernels one call launches."""
    from svd_lstm_tpu_torch.bench.autotune import cached_impl

    x = st.frames[:st.steps]
    hit = cached_impl(st.model, x, st.cell.traffic["precision"])
    before = launch_counters()
    _call(st, 0, keep=False)
    launched = {k: v - before[k] for k, v in launch_counters().items() if v != before[k]}
    return f"{type(st.model).__name__}, autotune cache: {hit or 'no entry'}, launches a call: {launched}"


def window(st: State, seconds: float) -> tuple:
    """``(t_start, calls)``: calls issued until ``seconds`` have passed."""
    st.outputs, st.used = [], []
    calls = []
    t_start = time.perf_counter()
    i = 0
    while time.perf_counter() - t_start < seconds:
        calls.append(_call(st, int(st.offsets[i % OFFSETS]), keep=True))
        i += 1
    return t_start, calls


def numbers(st: State, sides=("program",)) -> dict:
    """``{side: {"out_err": ...}}`` over a sample of the window's completed
    calls, drawn from the seed with the last call in it, against the
    float64 reference. The program's model is freed first. Sides:
    ``"program"``, the window's outputs; ``"control"``, the reference
    computed in TF32 in the program's place."""
    tr = st.cell.traffic
    n = len(st.outputs)
    if n == 0:
        return {side: {"out_err": None} for side in sides}
    k = min(int(tr["sample_calls"]), n)
    rng = np.random.default_rng([st.seed, 2])
    picks = sorted(set(rng.choice(n - 1, size=k - 1, replace=False).tolist()) | {n - 1})
    st.model = None
    if st.device.type == "cuda":
        torch.cuda.empty_cache()
    x = torch.from_numpy(np.stack([st.X[st.used[i]:st.used[i] + st.steps] for i in picks]))
    x = x.to(st.device, torch.float64)
    layers, head = models.reference_weights(st.cell.config, tr["form"], st.seed, st.device)
    ref = reference.predict(layers, head, x, "float64")
    out = {}
    for side in sides:
        if side == "program":
            outs = [st.outputs[i] for i in picks]
        elif side == "control":
            outs = [y.cpu().numpy() for y in reference.predict(layers, head, x, "tf32")]
        else:
            raise ValueError(f"unknown side {side!r}")
        out[side] = {"out_err": checks.out_err(outs, ref)}
    return out
