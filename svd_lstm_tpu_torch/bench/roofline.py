"""Hardware bounds of the recurrences on the NVIDIA H100.

Counterpart of ``svd_lstm_tpu/bench/roofline.py``, with the H100's published
peaks only (SXM part, dense rates, at its 700 W limit): 67 TFLOP/s float32
on the CUDA cores, 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.
The JAX module's fitted TPU constants (a chain latency a stage, a streaming
rate, a per-dot issue time, all fitted on the kernels they rate) and its
128-lane padded layouts are not carried over: a bound here is the least time
the card could take for the work the function defines, whatever code
implements it.

Counting rules:

* multiply-adds: a dense layer step is d·4n + n·4n; a reduced side is
  rows·r + r·(4n − r) merged and Σ_g rows·r_g + r_g·(n − r_g) split (the
  identity block of [I|C] is a copy, not work: the JAX module counts the
  whole r·4n); a head adds n·out. An operation is two FLOPs.
* bytes: each input read once and each output written once. A batch-1
  step reads its frame and writes its prediction; the weights are inputs of
  the call, read once whatever its length.
* the floor is the larger of the operations over the peak of the type they
  are computed in and the bytes over the memory rate. ``stages``, the
  dependent products on a step's chain, stays a count: no latency is
  fitted to it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12


def dtype_name(dtype) -> str:
    """"float32" or "bfloat16" from a name or a torch dtype."""
    name = str(dtype).removeprefix("torch.")
    if name not in PEAK_FLOPS:
        raise ValueError(f"no H100 peak for dtype {dtype!r}; expected one of {sorted(PEAK_FLOPS)}")
    return name


def bound(macs: float, nbytes: float, dtype="float32") -> dict:
    """The least time of a call: ``{"bound_ms", "bound_by"}``, the larger of
    its operations (2 × ``macs``) over the peak rate of ``dtype`` and its
    bytes over the memory rate ("operations" or "bytes"). The gate
    nonlinearities are left out of the operations: a few per output
    element against the hundreds to thousands of multiply-adds of a step's
    products."""
    ops_ms = 2 * macs / PEAK_FLOPS[dtype_name(dtype)] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def lstm_macs(T: int, B: int, layers) -> int:
    """Multiply-adds of a dense forward over T steps of B rows through
    ``layers`` given as (input width, units): z = x·W + h·U (an input width
    of 0: the recurrence alone, from xp). A backward does three times as
    much (z recomputed or kept, the products into dh and dx, the weight
    gradients' sums)."""
    return sum(T * B * (din + n) * 4 * n for din, n in layers)


def reduced_side_macs(rows: int, n: int, ranks: Sequence[int]) -> int:
    """One two-step side v·B then (v·B)·C of a layer of n units: ``ranks``
    is one rank (merged: B (rows, r), C (r, 4n − r)) or four (split: per
    gate B_g (rows, r_g), C_g (r_g, n − r_g))."""
    if len(ranks) == 1:
        (r,) = ranks
        return rows * r + r * (4 * n - r)
    if len(ranks) != 4:
        raise ValueError(f"expected 1 (merged) or 4 (split) ranks, got {tuple(ranks)}")
    return sum(rows * r + r * (n - r) for r in ranks)


def layer_ranks(model) -> list:
    """(input-side ranks, recurrent-side ranks) of each layer of a reduced
    model, as :func:`reduced_step_cost` takes them."""
    return [layer.ranks for layer in model.layers]


@dataclasses.dataclass
class StepCost:
    """The work of one step: ``bytes`` it must move (a batch-1 step its
    frame in and its prediction out), ``macs``, ``stages`` (dependent
    products on its chain, a count only); ``weight_bytes`` are read once a
    call; ``dtype`` is what the products compute in."""

    bytes: int
    macs: int
    stages: int = 0
    dtype: str = "float32"
    weight_bytes: int = 0

    def compute_floor_us(self) -> float:
        return 2 * self.macs / PEAK_FLOPS[dtype_name(self.dtype)] * 1e6

    def bandwidth_floor_us(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e6

    def floor_us(self) -> float:
        """The larger of the compute and the bandwidth floor of a step."""
        return max(self.compute_floor_us(), self.bandwidth_floor_us())

    def call_bound(self, T: int) -> dict:
        """:func:`bound` of a call of T steps, its weights read once."""
        return bound(T * self.macs, T * self.bytes + self.weight_bytes, self.dtype)


def _weight_bytes(wide_entries: int, f32_entries: int, dtype: str) -> int:
    """Products' weights stored in ``dtype`` (bf16: 2 bytes), biases and the
    head in float32."""
    return wide_entries * (2 if dtype == "bfloat16" else 4) + 4 * f32_entries


def dense_step_cost(input_dim: int, units: Sequence[int], head_dim: int = 1,
                    dtype="float32") -> StepCost:
    """A batch-1 step of a dense stack and its head (``fused_dense_stack``,
    or the hybrid of x-side products and K3 chains)."""
    dtype = dtype_name(dtype)
    layers, d = [], input_dim
    for n in units:
        layers.append((d, n))
        d = n
    wide = sum((din + n) * 4 * n for din, n in layers)
    return StepCost(
        bytes=4 * (input_dim + head_dim),
        macs=lstm_macs(1, 1, layers) + units[-1] * head_dim,
        stages=len(units),
        dtype=dtype,
        weight_bytes=_weight_bytes(wide, sum(4 * n for n in units) + (units[-1] + 1) * head_dim, dtype),
    )


def _side_ranks(r) -> tuple:
    """(input-side ranks, recurrent-side ranks) from one rank for both
    sides or a pair of a rank or ranks each."""
    if isinstance(r, int):
        return ((r,), (r,))
    return tuple((x,) if isinstance(x, int) else tuple(x) for x in r)


def reduced_step_cost(input_dim: int, units: Sequence[int], ranks, merged: bool = True,
                      head_dim: int = 1, dtype="float32") -> StepCost:
    """A batch-1 step of a reduced stack and its head, both sides factored
    (``fused_reduced_stack``). ``ranks`` has one entry a layer: a rank for
    both sides, or (input-side ranks, recurrent-side ranks), each one rank
    (merged) or four (split), as :func:`layer_ranks` gives them. A split
    layer given one rank uses it for every gate."""
    dtype = dtype_name(dtype)
    macs = wide = 0
    d = input_dim
    for n, r in zip(units, ranks):
        sides = _side_ranks(r)
        if not merged:
            sides = tuple(s * 4 if len(s) == 1 else s for s in sides)
        for rows, rs in zip((d, n), sides):
            side = reduced_side_macs(rows, n, rs)
            macs += side
            wide += side  # B and C hold as many entries as their products' multiply-adds
        d = n
    return StepCost(
        bytes=4 * (input_dim + head_dim),
        macs=macs + units[-1] * head_dim,
        stages=2 * len(units),
        dtype=dtype,
        weight_bytes=_weight_bytes(wide, sum(4 * n for n in units) + (units[-1] + 1) * head_dim, dtype),
    )


def recurrence_step_cost(n: int, B: int = 1, dtype="float32") -> StepCost:
    """A step of one dense layer's recurrence from its projection xp
    (``lstm_recurrence``, K3; ``batched_lstm_recurrence``, K5, at B rows):
    xp and h in float32 at batch 1, in ``dtype`` batched; U stored in
    float32 or, batch 1 in bf16, as bf16."""
    dtype = dtype_name(dtype)
    act = 4 if B == 1 else (2 if dtype == "bfloat16" else 4)
    u = 4 if B > 1 else (2 if dtype == "bfloat16" else 4)
    return StepCost(bytes=act * B * 5 * n, macs=B * n * 4 * n, stages=1, dtype=dtype,
                    weight_bytes=u * n * 4 * n)


def reduced_recurrence_step_cost(n: int, ranks: Sequence[int], dtype="float32") -> StepCost:
    """A step of one reduced layer's folded recurrence (h·B)·[I|C] from
    its projection xp (``reduced_recurrence``, K2): xp and h in float32,
    uB and uC in ``dtype``."""
    dtype = dtype_name(dtype)
    macs = reduced_side_macs(n, n, ranks)
    return StepCost(bytes=4 * 5 * n, macs=macs, stages=2, dtype=dtype,
                    weight_bytes=_weight_bytes(macs, 0, dtype))


def report(cost: StepCost, measured_us_per_step: float | None = None) -> str:
    lines = [
        f"bytes/step: {cost.bytes}  -> bandwidth floor {cost.bandwidth_floor_us() * 1e3:.3f} ns/step",
        f"MACs/step: {cost.macs} ({cost.dtype})  -> compute floor {cost.compute_floor_us() * 1e3:.3f} ns/step",
        f"floor (the larger): {cost.floor_us() * 1e3:.3f} ns/step; weights {cost.weight_bytes} bytes "
        f"a call; {cost.stages} dependent stages a step (a count, no fitted latency)",
    ]
    if measured_us_per_step is not None:
        lines.append(f"measured: {measured_us_per_step * 1e3:.1f} ns/step "
                     f"({measured_us_per_step / cost.floor_us():.1f}x the floor)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainStepCost:
    """One forward and backward of a stack over (B, T) windows.
    ``macs_executed``: what the port's train kernels issue (every backward
    recomputes z from the saved h, so 4× the forward); ``macs_model``: 3×
    the forward (the MFU convention); ``hbm_bytes``: each input of the pair
    read once and each output written once; ``dtype``: what the products
    compute in (float32: the port's train kernels)."""

    macs_executed: int
    macs_model: int
    hbm_bytes: int
    dtype: str = "float32"

    def compute_floor_ms(self) -> float:
        return 2 * self.macs_executed / PEAK_FLOPS[dtype_name(self.dtype)] * 1e3

    def bandwidth_floor_ms(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S * 1e3

    def floor_ms(self) -> float:
        return max(self.compute_floor_ms(), self.bandwidth_floor_ms())

    def floor_fraction(self, measured_ms: float) -> float:
        """Measured time over the floor (≥ 1 for a real measurement)."""
        return measured_ms / self.floor_ms()

    def mfu(self, measured_ms: float) -> float:
        """Model FLOPs a second over the peak of ``dtype``."""
        return 2 * self.macs_model / (measured_ms * 1e-3) / PEAK_FLOPS[dtype_name(self.dtype)]


def _model_train_macs(input_dim: int, units: Sequence[int], B: int, T: int) -> int:
    """3× the forward's multiply-adds (the standard training-FLOPs count)."""
    layers, d = [], input_dim
    for n in units:
        layers.append((d, n))
        d = n
    return 3 * lstm_macs(T, B, layers)


def _train_step_cost(input_dim: int, units: Sequence[int], B: int, T: int) -> TrainStepCost:
    model = _model_train_macs(input_dim, units, B, T)
    weights, d = 0, input_dim
    for n in units:
        weights += (d + n + 1) * 4 * n
        d = n
    rows = T * B
    # forward: x in, every layer's h and c out; backward: x, h, c and the top
    # dh in, dx out; the weights read by both and their gradients written
    acts = rows * (input_dim + 2 * sum(units)) + rows * (2 * input_dim + 2 * sum(units) + units[-1])
    return TrainStepCost(macs_executed=model // 3 * 4, macs_model=model,
                         hbm_bytes=4 * (acts + 3 * weights))


def wide_train_step_cost(input_dim: int, units: Sequence[int], B: int, T: int) -> TrainStepCost:
    """The per-layer wide pair (K9, ``wide_layer_fwd`` / ``_bwd``) over a
    uniform stack of layers of 128·k units."""
    if any(n % 128 or n != units[0] for n in units):
        raise ValueError(f"the wide pair takes uniform stacks of 128·k units, got {tuple(units)}")
    return _train_step_cost(input_dim, units, B, T)


def narrow_train_step_cost(input_dim: int, units: Sequence[int], B: int, T: int) -> TrainStepCost:
    """The narrow whole-stack pair (K7, K8) over layers of at most 128 units."""
    if any(n > 128 for n in units):
        raise ValueError(f"the narrow pair takes layers of at most 128 units, got {tuple(units)}")
    return _train_step_cost(input_dim, units, B, T)
