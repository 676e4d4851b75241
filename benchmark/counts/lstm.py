"""Model FLOPs and bytes of the benchmark's calls, from the configuration alone.

A frozen copy of the counting rules of the port's ``bench/roofline.py``,
so that no later change to the program moves the yardstick:

* A dense layer step of input width d and n units is d·4n + n·4n
  multiply-adds; the head adds n·out.
* A reduced side v·B then (v·B)·[I|C] of ``rows`` inputs is rows·r +
  r·(4n − r) merged, and Σ_g rows·r_g + r_g·(n − r_g) split: the identity
  block is a copy, not work. Each rank is min(rank, rows, columns), the
  most that side can hold, as a truncation to ``rank`` keeps it.
* A model's work is that of its own form, whatever route runs it: a
  reduced model counts its two-step form even where the program runs its
  dense reconstruction. An operation is two FLOPs.
* Training is three times the forward (the forward, the products into dh
  and dx, the weight gradients); nothing the kernels recompute is counted.
* Bytes: each input of the call read once and each output written once.
  A ``predict`` call reads its frames and its weights and writes its
  predictions; a training step reads its windows, labels, parameters and
  Adam's two moments and writes the parameters and the moments.
* A call's bound is the larger of its FLOPs over the H100's published
  float32 peak (67 TFLOP/s, SXM, dense, at 700 W) and its bytes over 3.35
  TB/s.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
WORD = 4  # bytes of a float32


def _widths(input_dim: int, units: Sequence[int]) -> list:
    """(input width, units) of each layer."""
    out, d = [], input_dim
    for n in units:
        out.append((d, n))
        d = n
    return out


def side_entries(rows: int, n: int, rank: int, merged: bool) -> int:
    """Multiply-adds of one reduced side at batch 1 (also the entries of its
    B and C)."""
    if merged:
        r = min(rank, rows, 4 * n)
        return rows * r + r * (4 * n - r)
    r = min(rank, rows, n)
    return 4 * (rows * r + r * (n - r))


def step_macs(config: dict, form: str) -> int:
    """Multiply-adds of one batch-1 step through the stack and the head, in
    the form ``form`` ("dense" or "reduced") of the configuration."""
    spec = config["forms"][form]
    macs = 0
    for d, n in _widths(config["input_dim"], config["units"]):
        if spec.get("rank") is None:
            macs += (d + n) * 4 * n
        else:
            merged = bool(spec["merged"])
            macs += side_entries(d, n, spec["rank"], merged) + side_entries(n, n, spec["rank"], merged)
    return macs + config["units"][-1] * config["head_dim"]


def weight_entries(config: dict, form: str) -> int:
    """Stored weights of the form: its products' entries, the biases and the
    head."""
    units = config["units"]
    head = (units[-1] + 1) * config["head_dim"]
    biases = sum(4 * n for n in units)
    return step_macs(config, form) - units[-1] * config["head_dim"] + biases + head


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the call could take on one H100."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def predict_call(config: dict, form: str, T: int) -> dict:
    """``{"flops", "bytes", "bound_s"}`` of one batch-1 ``predict`` of T steps."""
    flops = 2 * T * step_macs(config, form)
    nbytes = WORD * (T * config["input_dim"] + T * config["head_dim"] + weight_entries(config, form))
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops, nbytes)}


def parameter_count(config: dict) -> int:
    """Parameters of the dense form (what a training step updates)."""
    return weight_entries(config, "dense")


def train_step(config: dict, batch: int, window: int) -> dict:
    """``{"flops", "bytes", "bound_s"}`` of one training step of ``batch``
    windows of ``window`` steps on the window-end loss: 3 × (the stack over
    every step + the head on the last)."""
    stack = step_macs(config, "dense") - config["units"][-1] * config["head_dim"]
    forward = batch * window * stack + batch * config["units"][-1] * config["head_dim"]
    flops = 2 * 3 * forward
    params = parameter_count(config)
    nbytes = WORD * (batch * window * config["input_dim"] + batch + 3 * params + 3 * params)
    return {"flops": flops, "bytes": nbytes, "bound_s": bound_s(flops, nbytes)}
