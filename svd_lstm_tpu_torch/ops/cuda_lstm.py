"""Batch-1 LSTM recurrence kernels: CUDA wrappers and their plain versions.

Counterpart of ``svd_lstm_tpu/ops/pallas_lstm.py``. Each TPU kernel on the
batch-1 inference path has a hand-written CUDA kernel in
``csrc/lstm_recurrence.cu`` (design notes there) and a plain PyTorch version
beside its wrapper here:

==================== ============================== ==========================
wrapper              plain version                  replaces (pallas_lstm.py)
==================== ============================== ==========================
fused_dense_stack    fused_dense_stack_plain        fused_dense_stack_pallas
reduced_recurrence   reduced_recurrence_plain       reduced_recurrence_pallas
lstm_recurrence      lstm_recurrence_plain          lstm_recurrence_pallas
fused_reduced_stack  fused_reduced_stack_plain      fused_reduced_stack_pallas
==================== ============================== ==========================

Every wrapper takes the JAX package's ``dot_precision``: ``None`` or
``"highest"`` run the exact float32 kernel, ``"default"`` (the TPU's
single-pass bf16 dot, the batch-1 fast mode) runs the kernel's bf16-operand
variant: each operand of an in-kernel product rounded to bf16, the products
exact, the sums, the state, the bias and xp float32 (the numerics of the
JAX package's ``lstm_recurrence_pallas(weights_bf16=True)`` as well). Any
other value raises ``ValueError``.

A wrapper checks dtype (float32), shapes and contiguity, then routes on the
device of its tensors: CPU tensors take the plain version, CUDA tensors
launch the kernel (and raise if it fails), any other device raises. There
is no fallback from the card to the plain version. ``LAUNCHES`` counts
the launches of each kernel variant (``REPLACES``' keys: the wrapper's name,
with ``_fast`` for its bf16-operand variant); a wrapper adds one where it
launches its kernel.

The kernels are inference-only (no autograd), so the wrappers run under
``torch.no_grad()``. The x-side projections and the head stay
``torch.matmul``, as XLA computed them outside the Pallas kernels; in fast
mode the x-side products take bf16-rounded operands in float32 (TF32 off,
so the products are exact) and their results are not rounded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import StackedLSTM, gate_update, scan_recurrence
from svd_lstm_tpu_torch.models.reduced import (
    ReducedLSTM,
    folded_projection,
    operand_map,
    reduced_projection,
)
from svd_lstm_tpu_torch.ops import _build
from svd_lstm_tpu_torch.utils.linalg import fold_IC

SOURCE = "svd_lstm_tpu_torch/ops/csrc/lstm_recurrence.cu"
# the TPU kernel each kernel variant replaces, as file:line of its definition
REPLACES = {
    "fused_dense_stack": "svd_lstm_tpu/ops/pallas_lstm.py:369",
    "reduced_recurrence": "svd_lstm_tpu/ops/pallas_lstm.py:255",
    "lstm_recurrence": "svd_lstm_tpu/ops/pallas_lstm.py:195",
    "fused_dense_stack_fast": "svd_lstm_tpu/ops/pallas_lstm.py:369",
    "reduced_recurrence_fast": "svd_lstm_tpu/ops/pallas_lstm.py:255",
    "lstm_recurrence_fast": "svd_lstm_tpu/ops/pallas_lstm.py:195",
    "fused_reduced_stack": "svd_lstm_tpu/ops/pallas_lstm.py:483",
    "fused_reduced_stack_fast": "svd_lstm_tpu/ops/pallas_lstm.py:483",
}
LAUNCHES = dict.fromkeys(REPLACES, 0)  # launches of each kernel variant so far
MAX_LAYERS = 8  # csrc MAX_LAYERS
MAX_THREADS = 1024  # csrc MAX_THREADS: one block
_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block can use
_DOT_PRECISIONS = (None, "default", "highest")
WAVE_HOMES = ("registers", "staged", "global")  # csrc WaveHome (K1's and K3's), in its order


# ---------------------------------------------------------------------------
# checks and launch plumbing
# ---------------------------------------------------------------------------

def _on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises for mixed or other devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} and {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}: the kernels take CUDA or CPU tensors")


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _state(name: str, s: torch.Tensor | None, n: int) -> torch.Tensor | None:
    """Initial h or c as (n,), from (n,) or (1, n)."""
    if s is None:
        return None
    if s.numel() != n:
        raise ValueError(f"{name}: expected {n} values, got shape {tuple(s.shape)}")
    s = s.reshape(n)
    _check(name, s, (n,))
    return s


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(_build.library(), f"{name}_launch")  # built at first launch
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def _check_smem(name: str, floats: int) -> None:
    if 4 * floats > _SMEM_LIMIT:
        raise ValueError(f"{name}: needs {4 * floats} B of shared memory, over {_SMEM_LIMIT}")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _check_T(name: str, T: int) -> None:
    if T < 1:
        raise ValueError(f"{name}: empty sequence")


def _is_fast(dot_precision=None) -> bool:
    """Whether a call runs the bf16-operand variant (``dot_precision=
    "default"``). ``None`` and ``"highest"`` are exact; any other value
    raises, as the JAX package's ``_bad_dot_precision``."""
    if dot_precision not in _DOT_PRECISIONS:
        raise ValueError(
            f"unknown dot_precision {dot_precision!r}; expected None, 'default' or 'highest'"
        )
    return dot_precision == "default"


def _stored(t: torch.Tensor, fast: bool) -> torch.Tensor:
    """A weight as the kernel reads it: bf16 in fast mode (rounded once
    here, as the TPU's dot rounds it every step), else as it is."""
    return t.to(torch.bfloat16).contiguous() if fast else t


def _count(name: str, fast: bool) -> None:
    LAUNCHES[f"{name}_fast" if fast else name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# K3: dense h-side recurrence
# ---------------------------------------------------------------------------

@torch.no_grad()
def lstm_recurrence_plain(xp, U, h0=None, c0=None, dot_precision=None) -> torch.Tensor:
    """z_t = xp_t + h·U, gate update. xp (T, 4n) -> h_seq (T, n). Fast:
    bf16(h)·bf16(U) in xp's dtype (float32, or float64 state for a float64
    xp)."""
    operand = operand_map(_is_fast(dot_precision))
    n = U.shape[0]
    U = operand(U)
    h0 = None if h0 is None else h0.reshape(1, n)
    c0 = None if c0 is None else c0.reshape(1, n)
    return scan_recurrence(xp[None], lambda h: torch.matmul(operand(h), U), h0, c0)[0][0]


REC_UNITS = (4, 8, 16, 32)  # units a CTA (a warp each) that recurrence_plan tries, fewest first
REC_REG_KB = 16             # csrc REC_REG_KB: a lane's entries in registers (n <= 512)
REC_REG_THREADS = 256       # csrc REC_REG_THREADS: the block of the registers home
REC_MAX_UNITS = 32          # csrc REC_MAX_UNITS: 1024 threads


class RecurrencePlan(NamedTuple):
    """K3's launch (csrc ``lstm_recurrence_launch`` checks it): one
    cooperative launch of ``ctas`` = ⌈n / units⌉ CTAs, each ``units`` units
    (a warp each, all four gate columns of them), the packed U where
    ``home`` says, all CTAs co-resident."""

    units: int
    home: str
    ctas: int
    threads: int
    smem_bytes: int


def recurrence_smem_bytes(n: int, units: int, home: str, fast: bool) -> int:
    """Shared memory of a CTA (csrc ``rec_smem_bytes``): h_{t-1} as Kp =
    ⌈n / 32⌉·32 floats and, staged, its units' Kp entries of the packed U
    each (16 bytes, 8 in fast mode)."""
    kp = _round_up(n, 32)
    return 4 * kp + (units * kp * (8 if fast else 16) if home == "staged" else 0)


def recurrence_plan(n: int, fast: bool, sm_count: int, per_sm) -> RecurrencePlan:
    """K3's units a CTA and the weights' home for n units on a card of
    ``sm_count`` SMs, ``per_sm(units, home)`` being the kernel's CTAs an SM
    there (the occupancy API's, on the card): the registers where a lane's
    ⌈n / 32⌉ entries fit REC_REG_KB (n <= 512), else shared memory, else the
    global copy; in each home the fewest units of REC_UNITS whose block the
    home admits, whose shared memory fits and whose ⌈n / units⌉ CTAs the
    card holds at once. Raises ``ValueError`` where none does: the kernel is
    never run another way."""
    homes = (("registers",) if -(-n // 32) <= REC_REG_KB else ()) + ("staged", "global")
    for home in homes:
        for units in REC_UNITS:
            threads = 32 * units
            if threads > (REC_REG_THREADS if home == "registers" else MAX_THREADS):
                continue
            smem = recurrence_smem_bytes(n, units, home, fast)
            ctas = -(-n // units)
            if smem <= _SMEM_LIMIT and ctas <= per_sm(units, home) * sm_count:
                return RecurrencePlan(units, home, ctas, threads, smem)
    raise ValueError(f"lstm_recurrence: n = {n} fits no launch (shared memory, or the CTAs "
                     f"co-resident on {sm_count} SMs)")


def card_recurrence_plan(dev: torch.device, n: int, fast: bool) -> RecurrencePlan:
    """:func:`recurrence_plan` on the card of ``dev``: its SM count and the
    kernel's occupancy there."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return recurrence_plan(n, fast, torch.cuda.get_device_properties(idx).multi_processor_count,
                           lambda units, home: _recurrence_per_sm(idx, n, fast, units, home))


@functools.cache
def _recurrence_per_sm(device_index: int, n: int, fast: bool, units: int, home: str) -> int:
    """The kernel's CTAs an SM at this width, units and home (the occupancy
    API)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().lstm_recurrence_per_sm(n, units, WAVE_HOMES.index(home), int(fast),
                                                      ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"lstm_recurrence: occupancy query failed with cudaError {err}")
    return out.value


def pack_recurrence(U: torch.Tensor, fast: bool) -> torch.Tensor:
    """The chain's U, unit-major (n·n, 4): P[j·n + k, g] = U[k, g·n + j];
    bf16 in fast mode (rounded once here)."""
    n = U.shape[0]
    P = U.reshape(n, 4, n).permute(2, 0, 1).reshape(n * n, 4)
    return (P.to(torch.bfloat16) if fast else P).contiguous()


@torch.no_grad()
def lstm_recurrence(xp, U, h0=None, c0=None, dot_precision=None) -> torch.Tensor:
    """Dense h-side recurrence from the hoisted input projection (bias
    included). xp (T, 4n), U (n, 4n), optional h0/c0 (n,) -> (T, n). On the
    card one launch of the chain :func:`recurrence_plan` picks."""
    fast = _is_fast(dot_precision)
    T, n = xp.shape[0], U.shape[0]
    _check_T("lstm_recurrence", T)
    _check("xp", xp, (T, 4 * n))
    _check("U", U, (n, 4 * n))
    h0, c0 = _state("h0", h0, n), _state("c0", c0, n)
    if not _on_card(xp, U, *(s for s in (h0, c0) if s is not None)):
        return lstm_recurrence_plain(xp, U, h0, c0, dot_precision)
    plan = card_recurrence_plan(xp.device, n, fast)
    P = pack_recurrence(U, fast)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)
    _launch(
        "lstm_recurrence", xp.device,
        xp.data_ptr(), P.data_ptr(), _ptr(h0), _ptr(c0), out.data_ptr(), T, n, plan.units,
        WAVE_HOMES.index(plan.home), int(fast),
    )
    _count("lstm_recurrence", fast)
    return out


# ---------------------------------------------------------------------------
# K2: low-rank h-side recurrence
# ---------------------------------------------------------------------------

def _is_split(uB) -> bool:
    return not isinstance(uB, torch.Tensor)


def _check_factors(side: str, Bs, Cs, rows: int, n: int) -> list:
    """Shapes of one side's factors; returns them as a list. Merged: B
    (rows, r), C (r, 4n − r); split: 4 each of B[g] (rows, r_g), C[g]
    (r_g, n − r_g)."""
    if _is_split(Bs):
        if len(Bs) != 4 or len(Cs) != 4:
            raise ValueError(f"split factors: expected 4 per-gate {side}B and {side}C")
        for g, (B, C) in enumerate(zip(Bs, Cs)):
            r = B.shape[1]
            _check(f"{side}B[{g}]", B, (rows, r))
            _check(f"{side}C[{g}]", C, (r, n - r))
        return [*Bs, *Cs]
    r = Bs.shape[1]
    _check(f"{side}B", Bs, (rows, r))
    _check(f"{side}C", Cs, (r, 4 * n - r))
    return [Bs, Cs]


@torch.no_grad()
def reduced_recurrence_plain(xp, uB, uC, h0=None, c0=None, dot_precision=None) -> torch.Tensor:
    """z_t = xp_t + (h·B)·[I|C], merged (uB (n, r), uC (r, 4n−r)) or split
    (4 per-gate pairs uB[g] (n, r_g), uC[g] (r_g, n−r_g)). -> (T, n). Fast:
    h, B, h·B and [I|C] rounded to bf16 as the products' operands."""
    n = xp.shape[1] // 4
    rec = folded_projection(uB, uC, _is_fast(dot_precision))
    h0 = None if h0 is None else h0.reshape(1, n)
    c0 = None if c0 is None else c0.reshape(1, n)
    return scan_recurrence(xp[None], rec, h0, c0)[0][0]


def _pack_reduced(uB, uC, n: int):
    """(Bt (R, rows), IC (R, 4n)) for K4, of either side. Split: all gates'
    B side by side, transposed, and a block-diagonal IC with fold_IC(B_g,
    C_g) in gate g's rows and columns (the zero blocks add exact zeros)."""
    if not _is_split(uB):
        return uB.t().contiguous(), fold_IC(uB, uC).contiguous()
    ranks = [B.shape[1] for B in uB]
    Bt = torch.cat([B.t() for B in uB], dim=0).contiguous()
    IC = torch.zeros((sum(ranks), 4 * n), dtype=torch.float32, device=Bt.device)
    off = 0
    for g, (B, C) in enumerate(zip(uB, uC)):
        IC[off : off + ranks[g], g * n : (g + 1) * n] = fold_IC(B, C)
        off += ranks[g]
    return Bt, IC


RED_UNITS = 8               # csrc RED_UNITS: units a warp (its 32 gate columns, a lane each)
RED_MAX_WARPS = 32          # csrc RED_MAX_WARPS: warps a CTA
RED_REG_THREADS = 512       # csrc RED_REG_THREADS: the block of the registers home
RED_REG_RANK = 32           # the largest block rank the registers home holds (a lane an entry)
RED_CLUSTERS = (1, 2, 4, 8, 16)  # CTAs a cluster that reduced_plan tries, fewest first
RED_WARPS = 8               # warps a CTA the rule aims at: at 3x512 r = 24 the fastest cluster
                            # (CL = 8, 8 warps) ran 13-41 % ahead of CL = 4 and 16 (PERF.md §6)
RED_HOMES = WAVE_HOMES[:2]  # the homes K2 takes (csrc WaveHome's first two)


class ReducedPlan(NamedTuple):
    """K2's launch (csrc ``reduced_recurrence_launch`` checks it): one
    cluster of ``cluster`` CTAs, each ``warps`` warps of RED_UNITS units,
    the packed weights where ``home`` says."""

    cluster: int
    warps: int
    home: str
    threads: int
    smem_bytes: int
    weight_bytes: int  # of one CTA's blocks of the packed weights


def reduced_ranks(uB) -> tuple:
    """The block ranks of a recurrent side: (r,) merged, (r_i, r_f, r_g, r_o)
    split."""
    return tuple(B.shape[1] for B in uB) if _is_split(uB) else (uB.shape[1],)


def reduced_entries(ranks) -> int:
    """Entries of one warp's block of the packed weights: its 32 columns of
    [I|C] at the largest rank, and its 8 rows of B at each block's rank
    (40·r merged, 16·R split at equal ranks)."""
    return 32 * max(ranks) + RED_UNITS * sum(ranks)


def reduced_smem_bytes(ranks, cluster: int, warps: int, home: str, fast: bool) -> int:
    """Shared memory of a CTA (csrc ``red_smem_bytes``): the partial sums of
    hb (two parities of one slot a CTA, and one a warp) and, staged, the
    CTA's blocks of the packed weights (4 bytes an entry, 2 in fast mode)."""
    R = sum(ranks)
    staged = warps * reduced_entries(ranks) * (2 if fast else 4) if home == "staged" else 0
    return 4 * (2 * cluster + warps) * R + staged


def reduced_plan(n: int, ranks, fast: bool, sm_count: int,
                 smem_limit: int = _SMEM_LIMIT) -> ReducedPlan:
    """K2's cluster for n units and the block ``ranks`` (one merged, four
    split): the fewest CTAs of RED_CLUSTERS (at most ``sm_count``) whose
    ⌈n / CL⌉ units take at most RED_WARPS warps of RED_UNITS and whose
    weights fit on chip, else (past 16 · RED_WARPS · RED_UNITS units) the
    fewest whose warps fit a block: the weights in registers where every
    rank is at most RED_REG_RANK and the block at most RED_REG_THREADS,
    else staged in shared memory within ``smem_limit``. Raises
    ``ValueError`` naming the shape where no cluster of 16 holds them: the
    kernel is never run another way."""
    per_warp = reduced_entries(ranks) * (2 if fast else 4)
    for most in (RED_WARPS, RED_MAX_WARPS):
        for cluster in RED_CLUSTERS:
            if cluster > sm_count:
                break
            warps = -(-(-(-n // cluster)) // RED_UNITS)
            if warps > most:
                continue
            threads = 32 * warps
            for home in RED_HOMES:
                if home == "registers" and (max(ranks) > RED_REG_RANK or threads > RED_REG_THREADS):
                    continue
                smem = reduced_smem_bytes(ranks, cluster, warps, home, fast)
                if smem <= smem_limit:
                    return ReducedPlan(cluster, warps, home, threads, smem, warps * per_warp)
    raise ValueError(f"reduced_recurrence: n = {n} at ranks {tuple(ranks)} fits no cluster of up "
                     f"to {RED_CLUSTERS[-1]} CTAs on {sm_count} SMs")


def card_reduced_plan(dev: torch.device, n: int, ranks, fast: bool) -> ReducedPlan:
    """:func:`reduced_plan` on the card of ``dev`` (its SM count)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return reduced_plan(n, ranks, fast, torch.cuda.get_device_properties(idx).multi_processor_count)


def pack_reduced_chain(uB, uC, n: int, warps_total: int, fast: bool) -> torch.Tensor:
    """K2's weights, a block of :func:`reduced_entries` a warp for
    ``warps_total`` warps of RED_UNITS units (units past n zero): first the
    warp's 32 columns of [I|C] by rows, [q][8g + u] (gate g of unit u) for q
    below the largest rank, zero past the column's own block rank; then its
    8 rows of B, block by block, unit by unit, each at its block's rank.
    Merged: [I|C] = fold_IC(B, C), one block; split: gate g's columns read
    [I|C_g], its own block. bf16 in fast mode (rounded once here)."""
    W, units = warps_total, warps_total * RED_UNITS

    def grouped(M):  # (rows, units) -> (W, 8, rows): a warp's units, each unit's rows
        M = torch.nn.functional.pad(M, (0, units - M.shape[1]))
        return M.reshape(M.shape[0], W, RED_UNITS).permute(1, 2, 0)

    if _is_split(uB):
        ICs = [fold_IC(B, C) for B, C in zip(uB, uC)]
        Bs = list(uB)
    else:
        IC = fold_IC(uB, uC).reshape(-1, 4, n)
        ICs = [IC[:, g] for g in range(4)]
        Bs = [uB]
    rmax = max(M.shape[0] for M in ICs)
    cols = torch.cat([torch.nn.functional.pad(grouped(M), (0, rmax - M.shape[0])) for M in ICs],
                     dim=1)  # (W, 32 columns, rmax)
    b = [grouped(B.t()).reshape(W, -1) for B in Bs]
    P = torch.cat([cols.transpose(1, 2).reshape(W, -1), *b], dim=1).reshape(-1)
    return (P.to(torch.bfloat16) if fast else P).contiguous()


def _launch_reduced(xp, uB, uC, h0, c0, fast: bool, plan: ReducedPlan) -> torch.Tensor:
    """One launch of K2 as ``plan`` says, on checked card tensors."""
    T, n = xp.shape[0], xp.shape[1] // 4
    ranks = reduced_ranks(uB)
    P = pack_reduced_chain(uB, uC, n, plan.cluster * plan.warps, fast)
    rank_arr = np.array(ranks, dtype=np.int32)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)
    _launch(
        "reduced_recurrence", xp.device,
        xp.data_ptr(), P.data_ptr(), rank_arr.ctypes.data, len(ranks), _ptr(h0), _ptr(c0),
        out.data_ptr(), T, n, plan.cluster, plan.warps, RED_HOMES.index(plan.home), int(fast),
    )
    return out


@torch.no_grad()
def reduced_recurrence(xp, uB, uC, h0=None, c0=None, dot_precision=None) -> torch.Tensor:
    """Low-rank h-side recurrence in the folded form (h·B)·[I|C].
    xp (T, 4n); merged uB (n, r), uC (r, 4n−r); split: 4 each of
    uB[g] (n, r_g), uC[g] (r_g, n−r_g). Optional h0/c0 (n,). -> (T, n). On
    the card one launch of the cluster :func:`reduced_plan` picks."""
    fast = _is_fast(dot_precision)
    T, g4 = xp.shape
    n = g4 // 4
    _check_T("reduced_recurrence", T)
    _check("xp", xp, (T, 4 * n))
    factors = _check_factors("u", uB, uC, n, n)
    h0, c0 = _state("h0", h0, n), _state("c0", c0, n)
    if not _on_card(xp, *factors, *(s for s in (h0, c0) if s is not None)):
        return reduced_recurrence_plain(xp, uB, uC, h0, c0, dot_precision)
    plan = card_reduced_plan(xp.device, n, reduced_ranks(uB), fast)
    out = _launch_reduced(xp, uB, uC, h0, c0, fast, plan)
    _count("reduced_recurrence", fast)
    return out


# ---------------------------------------------------------------------------
# K1: whole dense stack, one kernel
# ---------------------------------------------------------------------------

@torch.no_grad()
def fused_dense_stack_plain(model: StackedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Time-outer, layer-inner loop, as the kernel runs it: per step, per
    layer z = x_t·W + h·U + b and the gate update. x (T, d) -> (T, out).
    Fast: x_t, h, W and U rounded to bf16 as the products' operands."""
    operand = operand_map(_is_fast(dot_precision))
    Ws = [operand(l.W) for l in model.layers]
    Us = [operand(l.U) for l in model.layers]
    T = x.shape[0]
    hs = [torch.zeros((1, l.units), dtype=x.dtype, device=x.device) for l in model.layers]
    cs = [torch.zeros_like(h) for h in hs]
    h_seq = torch.empty((T, model.layers[-1].units), dtype=x.dtype, device=x.device)
    for t in range(T):
        inp = x[t : t + 1]
        for i, l in enumerate(model.layers):
            z = torch.matmul(operand(inp), Ws[i]) + torch.matmul(operand(hs[i]), Us[i]) + l.b
            hs[i], cs[i] = gate_update(z, cs[i])
            inp = hs[i]
        h_seq[t] = inp[0]
    return model.head(h_seq)


def _check_layers(name: str, model, x: torch.Tensor) -> int:
    T, d = x.shape
    _check_T(name, T)
    _check("x", x, (T, model.layers[0].input_dim))
    L = len(model.layers)
    if L > MAX_LAYERS:
        raise ValueError(f"{name}: at most {MAX_LAYERS} layers, got {L}")
    return T


WAVE_LANES = (8, 4, 2, 1)  # lanes a unit that dense_stack_wave takes, most first
WAVE_REG_KB = 16           # csrc WAVE_REG_KB: a lane's entries in registers
WAVE_REG_THREADS = 512     # csrc WAVE_REG_THREADS: the block of the registers home


class DensePlan(NamedTuple):
    """K1's launch (csrc ``dense_stack_wave_launch`` checks it): ``route``
    "registers", "staged" or "global" runs the wavefront kernel with the
    weights there and ``lanes`` lanes a unit; "layers" runs the layer loop
    (``fused_dense_stack_kernel``)."""

    route: str
    lanes: int
    threads: int
    smem_bytes: int


def wave_threads(units: Sequence[int], d: int, lanes: int) -> int:
    """Threads of the wavefront's block (csrc ``wave_threads``): ``lanes``
    for every unit, and one for each input entry x_{s+1} stages."""
    return max(_round_up(lanes * sum(units), 32), _round_up(d, 32))


def wave_entries(units: Sequence[int], d: int) -> int:
    """Entries (four gates each) of the packed weights P: Σ (din + n)·n."""
    total, din = 0, d
    for n in units:
        total += (din + n) * n
        din = n
    return total


def _wave_kb(units: Sequence[int], d: int, lanes: int) -> int:
    """The most entries one lane of a unit reads a step: ⌈(din + n) / S⌉."""
    dins = [d, *units[:-1]]
    return max(-(-(din + n) // lanes) for din, n in zip(dins, units))


def dense_plan(units: Sequence[int], d: int, fast: bool) -> DensePlan:
    """K1's route for a stack of ``units`` on input width d: the wavefront
    with the weights in registers at the most lanes S whose block of at most
    WAVE_REG_THREADS holds every lane's ⌈(din + n) / S⌉ entries within
    WAVE_REG_KB; else at the most lanes whose block has at most MAX_THREADS,
    the weights staged in shared memory where they fit (16 bytes an entry,
    8 in fast mode), else read from the global copy; a stack that no block
    holds (more than 1024 units, or d > 1024) runs the layer loop."""
    state = 2 * 4 * (d + sum(units))  # two parities of [x | h_0 | ... | h_{L-1}]
    for lanes in WAVE_LANES:
        threads = wave_threads(units, d, lanes)
        if threads <= WAVE_REG_THREADS and _wave_kb(units, d, lanes) <= WAVE_REG_KB:
            return DensePlan("registers", lanes, threads, state)
    for lanes in WAVE_LANES:
        threads = wave_threads(units, d, lanes)
        if threads <= MAX_THREADS:
            staged = state + wave_entries(units, d) * (8 if fast else 16)
            if staged <= _SMEM_LIMIT:
                return DensePlan("staged", lanes, threads, staged)
            return DensePlan("global", lanes, threads, state)
    return DensePlan("layers", 1, min(MAX_THREADS, _round_up(4 * max(units), 32)),
                     4 * (2 * sum(units) + 4 * max(units) + d))


def pack_wave(layers, fast: bool) -> torch.Tensor:
    """The wavefront's weights P (Σ (din + n)·n, 4): each layer's [W; U]
    gate-interleaved, P[w_off + k·n + j, g] = [W; U][k, g·n + j], the layers
    one after another; bf16 in fast mode (rounded once here)."""
    parts = []
    for l in layers:
        din, n = l.W.shape[0], l.U.shape[0]
        parts.append(torch.cat([l.W.reshape(din, 4, n), l.U.reshape(n, 4, n)])
                     .transpose(1, 2).reshape(-1, 4))
    P = torch.cat(parts)
    return (P.to(torch.bfloat16) if fast else P).contiguous()


def _launch_dense(model: StackedLSTM, x: torch.Tensor, fast: bool, plan: DensePlan,
                  out: torch.Tensor) -> None:
    """One launch of K1 as ``plan`` says, into ``out`` (T, n_out)."""
    T, d = x.shape
    if plan.route == "layers":
        _check_smem("fused_dense_stack", plan.smem_bytes // 4)
        weights = [(_stored(l.W, fast), _stored(l.U, fast), l.b) for l in model.layers]
        meta = np.array(
            [[l.input_dim, l.units, W.data_ptr(), U.data_ptr(), b.data_ptr()]
             for l, (W, U, b) in zip(model.layers, weights)],
            dtype=np.int64,
        )
        _launch("fused_dense_stack", x.device,
                meta.ctypes.data, len(weights), x.data_ptr(), out.data_ptr(), T, d, int(fast))
        return
    P = pack_wave(model.layers, fast)
    rows, off = [], 0
    for l in model.layers:
        rows.append([l.input_dim, l.units, off, l.b.data_ptr()])
        off += (l.input_dim + l.units) * l.units
    meta = np.array(rows, dtype=np.int64)
    _launch("dense_stack_wave", x.device, meta.ctypes.data, len(rows), P.data_ptr(), P.shape[0],
            x.data_ptr(), out.data_ptr(), T, d, plan.lanes, WAVE_HOMES.index(plan.route),
            int(fast))


@torch.no_grad()
def fused_dense_stack(model: StackedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Whole dense stack in one kernel (:func:`dense_plan` picks which and
    how); the head is applied to the last layer's hidden sequence outside
    it. x (T, d) -> (T, out)."""
    fast = _is_fast(dot_precision)
    T = _check_layers("fused_dense_stack", model, x)
    d = x.shape[1]
    din = d
    for i, l in enumerate(model.layers):
        n = l.units
        _check(f"layers[{i}].W", l.W, (din, 4 * n))
        _check(f"layers[{i}].U", l.U, (n, 4 * n))
        _check(f"layers[{i}].b", l.b, (4 * n,))
        din = n
    if not _on_card(x, *(p for l in model.layers for p in (l.W, l.U, l.b))):
        return fused_dense_stack_plain(model, x, dot_precision)
    units = [l.units for l in model.layers]
    h = torch.empty((T, units[-1]), dtype=torch.float32, device=x.device)
    _launch_dense(model, x, fast, dense_plan(units, d, fast), h)
    _count("fused_dense_stack", fast)
    return model.head(h)


# ---------------------------------------------------------------------------
# K4: whole reduced stack, both sides factored, one kernel
# ---------------------------------------------------------------------------

@torch.no_grad()
def fused_reduced_stack_plain(model: ReducedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Time-outer, layer-inner loop, as the kernel runs it: per step, per
    layer z = (inp·wB)·[I|wC] + (h·uB)·[I|uC] + b and the gate update
    (merged or split layers). x (T, d) -> (T, out). Fast: every operand of
    the four products rounded to bf16."""
    fast = _is_fast(dot_precision)
    sides = [(folded_projection(l.wB, l.wC, fast), folded_projection(l.uB, l.uC, fast))
             for l in model.layers]
    T = x.shape[0]
    hs = [torch.zeros((1, l.units), dtype=x.dtype, device=x.device) for l in model.layers]
    cs = [torch.zeros_like(h) for h in hs]
    h_seq = torch.empty((T, model.layers[-1].units), dtype=x.dtype, device=x.device)
    for t in range(T):
        inp = x[t : t + 1]
        for i, l in enumerate(model.layers):
            w_side, u_side = sides[i]
            hs[i], cs[i] = gate_update(w_side(inp) + u_side(hs[i]) + l.b, cs[i])
            inp = hs[i]
        h_seq[t] = inp[0]
    return model.head(h_seq)


def _sides(l):
    """A reduced layer's (wB, wC, uB, uC) as the packers take them."""
    if l.split:
        return tuple(l.wB), tuple(l.wC), tuple(l.uB), tuple(l.uC)
    return l.wB, l.wC, l.uB, l.uC


STACK_REG_KB = 2                # csrc RSW_KB: chunks of 32 entries of a side's h·B in registers
STACK_REG_THREADS = {16: 512, 32: 384}  # csrc: the block of the registers home, by column length
STACK_MAX_D = 32                # the widest input the wavefront takes (a lane an entry of x_t)


class StackGeometry(NamedTuple):
    """The exchange and the packing of reduced_stack_wave for one stack
    (csrc ``rsw_args`` computes the same)."""

    warps: int  # warps of all layers: Σ ⌈n_i / 8⌉
    S: int      # entries of the exchange vector V: Σ (Rw_i + Ru_i)
    QW: int     # rows of a warp's [I|wC] columns: the largest input-side block rank
    QU: int     # the same for [I|uC]
    KU: int     # chunks of 32 entries of hb_i, the most of any layer
    KN: int     # chunks of 32 entries of xb_{i+1}, the most of any layer (0 for one layer)
    KX: int     # chunks of 32 entries of xb_0
    E: int      # entries of a warp's block of the packed weights
    RO: int     # the largest Rw_i + Ru_i


def stack_geometry(units: Sequence[int], w_ranks, u_ranks) -> StackGeometry:
    """The geometry for layers of ``units`` with block ranks ``w_ranks[i]``
    (input side) and ``u_ranks[i]`` (recurrent side): one rank merged, four
    split."""
    Rw = [sum(r) for r in w_ranks]
    Ru = [sum(r) for r in u_ranks]
    QW, QU = max(max(r) for r in w_ranks), max(max(r) for r in u_ranks)
    KU = max(-(-r // 32) for r in Ru)
    KN = max((-(-r // 32) for r in Rw[1:]), default=0)
    return StackGeometry(
        warps=sum(-(-n // RED_UNITS) for n in units), S=sum(Rw) + sum(Ru), QW=QW, QU=QU, KU=KU,
        KN=KN, KX=-(-Rw[0] // 32), E=32 * (QW + QU) + 256 * (KU + KN),
        RO=max(w + u for w, u in zip(Rw, Ru)))


class ReducedStackPlan(NamedTuple):
    """K4's launch: ``route`` "wave" runs ``reduced_stack_wave`` (csrc
    ``reduced_stack_wave_launch`` checks it) as one cluster of ``cluster``
    CTAs of ``warps`` warps with the weights where ``home`` says; "layers"
    runs the layer loop (``fused_reduced_stack_kernel``: one CTA, the
    weights read from their global copy)."""

    route: str
    cluster: int
    warps: int
    home: str
    threads: int
    smem_bytes: int


def reduced_stack_smem_bytes(geom: StackGeometry, d: int, cluster: int, warps: int, home: str,
                             fast: bool) -> int:
    """Shared memory of a CTA (csrc ``rsw_smem_bytes``): the slots (two
    parities of CL × S floats), each warp's partial row (S) and operand row
    (RO), and in the weights' type (4 bytes, 2 in fast mode) layer 0's
    x-side weights (d × 32·KX) and, staged, the CTA's blocks (warps × E)."""
    wt = 2 if fast else 4
    staged = warps * geom.E if home == "staged" else 0
    return 4 * (2 * cluster * geom.S + warps * (geom.S + geom.RO)) + wt * (d * 32 * geom.KX + staged)


def _stack_reg_threads(geom: StackGeometry) -> int:
    """The most threads of the registers home, 0 where it cannot hold the
    stack (a rank past 32, or a side's h·B past STACK_REG_KB chunks)."""
    rq = max(geom.QW, geom.QU)
    if rq > 32 or geom.KU > STACK_REG_KB or geom.KN > STACK_REG_KB:
        return 0
    return STACK_REG_THREADS[16 if rq <= 16 else 32]


def reduced_stack_plan(units: Sequence[int], d: int, w_ranks, u_ranks, fast: bool,
                       sm_count: int) -> ReducedStackPlan:
    """K4's launch for a stack of ``units`` on input width d with block
    ranks ``w_ranks``, ``u_ranks`` (per layer: one merged, four split): the
    wavefront in the weights' first home of RED_HOMES that holds the stack
    (registers: every rank at most 32 and each side's h·B at most
    STACK_REG_KB chunks of 32, the block within STACK_REG_THREADS; staged:
    the shared memory within a block's), at the fewest CTAs of
    RED_CLUSTERS (at most ``sm_count``) whose ⌈warps / CL⌉ warps a CTA fit
    a block; a stack that no cluster of 16 holds, or an input wider than
    STACK_MAX_D, runs the layer loop (route "layers")."""
    geom = stack_geometry(units, w_ranks, u_ranks)
    for home in RED_HOMES if d <= STACK_MAX_D else ():
        most = _stack_reg_threads(geom) if home == "registers" else MAX_THREADS
        for cluster in RED_CLUSTERS:
            if cluster > sm_count:
                break
            warps = -(-geom.warps // cluster)
            if 32 * warps > most:
                continue
            smem = reduced_stack_smem_bytes(geom, d, cluster, warps, home, fast)
            if smem <= _SMEM_LIMIT:
                return ReducedStackPlan("wave", cluster, warps, home, 32 * warps, smem)
    return layers_stack_plan(units, d, geom)


def layers_stack_plan(units: Sequence[int], d: int, geom: StackGeometry) -> ReducedStackPlan:
    """The layer loop's launch: one CTA, a thread a column of the widest
    layer or a warp an entry of the widest [xb | hb] (at most MAX_THREADS),
    per layer h and c, one z, one [xb | hb] and x_t in shared memory."""
    threads = min(MAX_THREADS, _round_up(max(4 * max(units), 32 * geom.RO), 32))
    return ReducedStackPlan("layers", 1, threads // 32, "global", threads,
                            4 * (2 * sum(units) + 4 * max(units) + geom.RO + d))


def _stack_ranks(model: ReducedLSTM):
    """(units, w_ranks, u_ranks) of a reduced model, as reduced_stack_plan
    takes them."""
    units = [l.units for l in model.layers]
    return units, [l.ranks[0] for l in model.layers], [l.ranks[1] for l in model.layers]


def card_reduced_stack_plan(dev: torch.device, model: ReducedLSTM, d: int,
                            fast: bool) -> ReducedStackPlan:
    """:func:`reduced_stack_plan` for ``model`` on the card of ``dev`` (its
    SM count)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    units, w_ranks, u_ranks = _stack_ranks(model)
    return reduced_stack_plan(units, d, w_ranks, u_ranks, fast,
                              torch.cuda.get_device_properties(idx).multi_processor_count)


def check_reduced_stack_plan(plan: ReducedStackPlan, units, d: int, w_ranks, u_ranks,
                             fast: bool) -> None:
    """Raises ``ValueError`` naming what the kernel cannot run, for a plan
    given past the rule (csrc ``reduced_stack_wave_launch`` refuses the
    same); "layers" takes any stack whose shared memory fits."""
    geom = stack_geometry(units, w_ranks, u_ranks)
    if plan.route == "layers":
        if plan.smem_bytes > _SMEM_LIMIT:
            raise ValueError(f"fused_reduced_stack: the layer loop needs {plan.smem_bytes} B of "
                             f"shared memory, over {_SMEM_LIMIT}")
        return
    why = None
    if plan.route != "wave" or plan.home not in RED_HOMES:
        why = f"route {plan.route!r}, home {plan.home!r}"
    elif d > STACK_MAX_D:
        why = f"an input of {d} entries"
    elif plan.cluster not in RED_CLUSTERS or not 1 <= plan.warps <= RED_MAX_WARPS:
        why = f"{plan.cluster} CTAs of {plan.warps} warps"
    elif plan.cluster * plan.warps < geom.warps:
        why = f"{plan.cluster} x {plan.warps} warps for the stack's {geom.warps}"
    elif plan.home == "registers" and plan.threads > _stack_reg_threads(geom):
        why = f"the registers home at {plan.threads} threads"
    elif plan.threads != 32 * plan.warps or plan.smem_bytes != reduced_stack_smem_bytes(
            geom, d, plan.cluster, plan.warps, plan.home, fast) or plan.smem_bytes > _SMEM_LIMIT:
        why = f"{plan.threads} threads, {plan.smem_bytes} B of shared memory"
    if why is not None:
        raise ValueError(f"fused_reduced_stack: the wavefront cannot run {why} "
                         f"(units {tuple(units)}, ranks {tuple(map(tuple, u_ranks))})")


def pack_reduced_stack(model: ReducedLSTM, warps_total: int, fast: bool) -> torch.Tensor:
    """K4's weights, flat: a block of E entries for each of ``warps_total``
    warps (the layers' warps in order, ⌈n / 8⌉ each, then zero blocks),
    then layer 0's x-side weights. A warp's block: its 32 columns of [I|wC]
    by rows, [q][8g + u] (gate g of unit u) for q < QW, zero past the
    column's own block rank (merged: fold_IC(wB, wC)'s column g·n + j;
    split: fold_IC(wB_g, wC_g)'s column j, its gate's block alone); the same
    of [I|uC] for q < QU; then its 8 rows of uB as [k][u][lane] (entry 32k +
    lane of the flattened hb_i: the split gates' B side by side) for k <
    KU, and its 8 rows of the next layer's wB the same way for k < KN.
    Layer 0's x-side weights: wB_0 flattened the same way, [k][e] for k < d,
    e < 32·KX. Units past n and entries past a side's rank are zero. bf16
    in fast mode (rounded once here)."""
    F = torch.nn.functional
    units, w_ranks, u_ranks = _stack_ranks(model)
    geom = stack_geometry(units, w_ranks, u_ranks)
    layers = model.layers

    def flat_B(Bs):  # (rows, R): the split gates' B side by side
        return torch.cat(list(Bs), dim=1) if not isinstance(Bs, torch.Tensor) else Bs

    def columns(Bs, Cs, n, Q):  # (nw, Q·32): [q][8g + u]
        if isinstance(Bs, torch.Tensor):
            IC = fold_IC(Bs, Cs).reshape(-1, 4, n)
            ICs = [IC[:, g] for g in range(4)]
        else:
            ICs = [fold_IC(B, C) for B, C in zip(Bs, Cs)]
        nw = -(-n // RED_UNITS)
        M = torch.stack([F.pad(M, (0, nw * RED_UNITS - n, 0, Q - M.shape[0])) for M in ICs])
        return M.reshape(4, Q, nw, RED_UNITS).permute(2, 1, 0, 3).reshape(nw, Q * 32)

    def rows(Bs, n, K):  # (nw, K·256): [k][u][lane]
        nw = -(-n // RED_UNITS)
        B = flat_B(Bs)
        B = F.pad(B, (0, 32 * K - B.shape[1], 0, nw * RED_UNITS - n))
        return B.reshape(nw, RED_UNITS, K, 32).permute(0, 2, 1, 3).reshape(nw, K * 256)

    blocks = []
    for i, l in enumerate(layers):
        wB, wC, uB, uC = _sides(l)
        parts = [columns(wB, wC, l.units, geom.QW), columns(uB, uC, l.units, geom.QU),
                 rows(uB, l.units, geom.KU)]
        if i + 1 < len(layers):
            parts.append(rows(_sides(layers[i + 1])[0], l.units, geom.KN))
        else:  # the last layer feeds no layer
            parts.append(parts[-1].new_zeros((parts[-1].shape[0], geom.KN * 256)))
        blocks.append(torch.cat(parts, dim=1))
    P = torch.cat(blocks)
    P = F.pad(P, (0, 0, 0, warps_total - P.shape[0]))
    wB0 = flat_B(_sides(layers[0])[0])
    wx = F.pad(wB0, (0, 32 * geom.KX - wB0.shape[1]))
    flat = torch.cat([P.reshape(-1), wx.reshape(-1)])
    return (flat.to(torch.bfloat16) if fast else flat).contiguous()


def _launch_reduced_stack(model: ReducedLSTM, x: torch.Tensor, fast: bool, plan: ReducedStackPlan,
                          out: torch.Tensor) -> None:
    """One launch of K4 as ``plan`` says, into ``out`` (T, n_out), on
    checked card tensors."""
    T, d = x.shape
    units, w_ranks, u_ranks = _stack_ranks(model)
    check_reduced_stack_plan(plan, units, d, w_ranks, u_ranks, fast)
    if plan.route == "layers":
        packed = []
        for l in model.layers:
            wB, wC, uB, uC = _sides(l)
            w_side = [_stored(t, fast) for t in _pack_reduced(wB, wC, l.units)]
            u_side = [_stored(t, fast) for t in _pack_reduced(uB, uC, l.units)]
            packed.append((*w_side, *u_side))
        meta = np.array(
            [[l.input_dim, l.units, wBt.shape[0], uBt.shape[0], wBt.data_ptr(), wIC.data_ptr(),
              uBt.data_ptr(), uIC.data_ptr(), l.b.data_ptr()]
             for l, (wBt, wIC, uBt, uIC) in zip(model.layers, packed)],
            dtype=np.int64,
        )
        _launch("fused_reduced_stack", x.device,
                meta.ctypes.data, len(units), x.data_ptr(), out.data_ptr(), T, d, int(fast))
        return
    P = pack_reduced_stack(model, plan.cluster * plan.warps, fast)
    meta = np.array(
        [[l.units, len(wr), *(wr + (0,) * (4 - len(wr))), *(ur + (0,) * (4 - len(ur))),
          l.b.data_ptr()]
         for l, wr, ur in zip(model.layers, w_ranks, u_ranks)],
        dtype=np.int64,
    )
    _launch("reduced_stack_wave", x.device, meta.ctypes.data, len(units), P.data_ptr(), P.numel(),
            x.data_ptr(), out.data_ptr(), T, d, plan.cluster, plan.warps,
            RED_HOMES.index(plan.home), int(fast))


@torch.no_grad()
def fused_reduced_stack(model: ReducedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Whole reduced stack in one kernel, both sides in the folded two-step
    form (:func:`reduced_stack_plan` picks which and how); the head is
    applied to the last layer's hidden sequence outside it. x (T, d) ->
    (T, out)."""
    fast = _is_fast(dot_precision)
    T = _check_layers("fused_reduced_stack", model, x)
    d = x.shape[1]
    tensors, din = [x], d
    for i, l in enumerate(model.layers):
        n = l.units
        wB, wC, uB, uC = _sides(l)
        tensors += _check_factors(f"layers[{i}].w", wB, wC, din, n)
        tensors += _check_factors(f"layers[{i}].u", uB, uC, n, n)
        _check(f"layers[{i}].b", l.b, (4 * n,))
        tensors.append(l.b)
        din = n
    if not _on_card(*tensors):
        return fused_reduced_stack_plain(model, x, dot_precision)
    h = torch.empty((T, model.layers[-1].units), dtype=torch.float32, device=x.device)
    _launch_reduced_stack(model, x, fast, card_reduced_stack_plan(x.device, model, d, fast), h)
    _count("fused_reduced_stack", fast)
    return model.head(h)


# ---------------------------------------------------------------------------
# hybrid paths: torch.matmul x-side projections + recurrence kernels
# ---------------------------------------------------------------------------

@torch.no_grad()
def dense_forward_hybrid(model: StackedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Per layer: one matmul for the input projection, the recurrence
    kernel for the time loop. x (T, d) -> (T, out). ``dot_precision=
    "default"``: the x-side product's operands h and W rounded to bf16 as
    well as the recurrence's; the head is exact float32."""
    operand = operand_map(_is_fast(dot_precision))
    h = x
    for l in model.layers:
        xp = torch.matmul(operand(h), operand(l.W)) + l.b
        h = lstm_recurrence(xp, l.U, dot_precision=dot_precision)
    return model.head(h)


@torch.no_grad()
def reduced_forward_hybrid(model: ReducedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Reduced model: factored two-step input projections as matmuls, the
    folded two-step recurrence kernel for the time loop. x (T, d) -> (T, out).
    ``dot_precision="default"``: both sides with bf16-rounded operands; the
    head is exact float32."""
    fast = _is_fast(dot_precision)
    h = x
    for l in model.layers:
        xp = reduced_projection(l, h, "w", bf16=fast) + l.b
        _, _, uB, uC = _sides(l)
        h = reduced_recurrence(xp, uB, uC, dot_precision=dot_precision)
    return model.head(h)
