"""LSTM training kernels: CUDA wrappers, plain versions, autograd Functions
and the training dispatch.

Counterpart of ``svd_lstm_tpu/ops/pallas_train_fused.py`` (K7),
``svd_lstm_tpu/ops/pallas_train_compact.py`` (K8),
``svd_lstm_tpu/ops/pallas_train_wide.py`` (K9), the recurrence-only pair
of ``svd_lstm_tpu/ops/pallas_train.py`` (K6) and its dispatch. The kernels
are hand-written CUDA in ``csrc/lstm_train.cu`` (design notes there):

============================== ==================================== ====================================
wrapper                        plain version                        replaces
============================== ==================================== ====================================
fused_narrow_train_fwd         fused_narrow_train_fwd_plain         pallas_train_fused.py:_fused_fwd
fused_narrow_train_bwd         fused_narrow_train_bwd_plain         pallas_train_fused.py:_fused_bwd
fused_narrow_train_compact_fwd fused_narrow_train_compact_fwd_plain pallas_train_compact.py:_fused_fwd
fused_narrow_train_compact_bwd fused_narrow_train_compact_bwd_plain pallas_train_compact.py:_fused_bwd
wide_layer_fwd                 wide_layer_fwd_plain                 pallas_train_wide.py:_wide_fwd
wide_layer_bwd                 wide_layer_bwd_plain                 pallas_train_wide.py:_wide_bwd
lstm_recurrence_train_fwd      lstm_recurrence_train_fwd_plain      pallas_train.py:_pallas_fwd_hc
lstm_recurrence_train_bwd      lstm_recurrence_train_bwd_plain      pallas_train.py:_pallas_bwd
============================== ==================================== ====================================

K8 computes K7's function (the compact gate packing of the TPU kernel is a
lane layout, not carried over). Both forwards are one kernel, and both
backwards another: a group of lanes (``narrow_fwd_lanes``,
``narrow_bwd_lanes``) owns each unit, the layers run as a wavefront (T + L
− 1 steps forward, T + L back), and the weights are read gate-interleaved,
staged in shared memory wherever the stack fits (``narrow_fwd_smem_bytes``,
``narrow_bwd_staged``) or from the copy :func:`pack_gates` in global
memory. K9's forward is one GEMM for x·W + b over all T·B rows and one
persistent launch for the recurrence (:func:`wide_fwd`); its backward runs
four phases (:func:`wide_bwd`: GEMMs for z, dx and the weight gradients
over all T·B rows, and one persistent launch for the dh chain). K6 runs
K9's kernels with the x·W part taken out. K9f's and K6f's forward
(:func:`wide_fwd_bf16`) runs its x-side on ``gemm_bf16`` and its chain on
K5's ``batched_chain`` with c stored, planned by ``cuda_batched.batched_plan``
(past n = 1152 its unstaged tile, U read from a global copy).

Every wrapper, plain version and autograd Function takes ``bf16``. False
(exact): everything in float32. True: the bf16-operand variant, the
arithmetic of the JAX kernels' ``precision=DEFAULT`` dots on the TPU (K7f,
K8f, K9f, K6f): each operand of an in-kernel product rounded to bf16
(round to nearest even) where it enters the product, the products exact,
the sums, the state c, the bias, xp and the gate math float32, every output
float32 and unrounded; db is the unrounded sum of dz, as the JAX kernels
take it. The narrow kernels round where an operand enters a product
(``csrc/lstm_train.cu``, template flag ``BF16``), and the copies of the
weights a wrapper makes for them (:func:`pack_gates`) are rounded once by
the wrapper; K9f and K6f take bf16 copies of their operands (x and W by
:func:`bf16_copy`, U as bf16(U)ᵀ for the forward chain, :func:`bf16_operands`
for the backward; the forward chain stores each h_t's bf16 copy for the
next step) and run on the tensor cores; the plain versions round with
``bf16_round``. (On the CPU the JAX package's DEFAULT dots are exact float32, so its CPU output cannot show
bf16 numerics: the tests hold the bf16 plain versions to a float64
emulation that rounds the same operands.)

Layouts are time-major, as the TPU kernels take them: x (T, B, d), every
layer's h and c (T, B, n). The weights keep the Keras layout, unpadded: the
128-lane gate padding of the TPU kernels is not carried over, and K9 takes
the first layer's input width d as a parameter instead of zero-padding it
to n.

A wrapper checks shapes, contiguity and the kernel's limits, then routes on
the device of its tensors: CPU tensors take the plain version (float32 or
float64), CUDA tensors launch the kernel (float32 only) and raise if it
fails; there is no fallback from the card to the plain version.
``LAUNCHES`` counts the launches of each kernel variant (``REPLACES``'
keys: the wrapper's name, with ``_fast`` for its bf16-operand variant); a
wrapper adds one where it launches its kernel. The kernels compute on the
CUDA cores, but for K9f and K6f, forward and backward (``gemm_bf16`` on
``wgmma``, the chains' products on ``mma.sync``).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import (
    gate_update,
    gate_update_bwd,
    lstm_layer_apply,
    stacked_lstm_apply,
)
from svd_lstm_tpu_torch.models.reduced import operand_map
from svd_lstm_tpu_torch.ops import cuda_batched as cb
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT, _check_smem, _check_T, _launch, _on_card
from svd_lstm_tpu_torch.utils.precision import dot

SOURCE = "svd_lstm_tpu_torch/ops/csrc/lstm_train.cu"
# the TPU kernel each wrapper replaces, as file:line of its definition
REPLACES = {
    "fused_narrow_train_fwd": "svd_lstm_tpu/ops/pallas_train_fused.py:67",
    "fused_narrow_train_bwd": "svd_lstm_tpu/ops/pallas_train_fused.py:122",
    "fused_narrow_train_compact_fwd": "svd_lstm_tpu/ops/pallas_train_compact.py:151",
    "fused_narrow_train_compact_bwd": "svd_lstm_tpu/ops/pallas_train_compact.py:201",
    "wide_layer_fwd": "svd_lstm_tpu/ops/pallas_train_wide.py:82",
    "wide_layer_bwd": "svd_lstm_tpu/ops/pallas_train_wide.py:130",
    "lstm_recurrence_train_fwd": "svd_lstm_tpu/ops/pallas_train.py:105",
    "lstm_recurrence_train_bwd": "svd_lstm_tpu/ops/pallas_train.py:165",
}
# the bf16-operand variants replace the same TPU kernels (whose dots are
# DEFAULT, i.e. bf16-pass, on the TPU)
REPLACES.update({f"{name}_fast": where for name, where in list(REPLACES.items())})
LAUNCHES = dict.fromkeys(REPLACES, 0)  # launches of each kernel variant so far
NARROW_MAX = 128      # largest layer width and input width of K7
MAX_LAYERS = 8        # csrc MAX_LAYERS
NARROW_ROWS = 4       # csrc NARROW_ROWS: batch rows per CTA of K7 and K8
COMPACT_MAX_UNITS = 64  # K8's layers: the JAX package's ≥ 2 gates per 128-lane block
COMPACT_MIN_BATCH = 128  # compact="auto" takes K8 from this batch on, as the JAX dispatch
WIDE_ALIGN = 128      # K9 takes n % 128 == 0, as the TPU kernel did
FWD_MAX_THREADS = 1024  # csrc FWD_MAX_THREADS: the narrow forward's block
BWD_MAX_THREADS = 1024  # csrc BWD_MAX_THREADS: the narrow backward's block
# state floats a thread of the backward loads a step, by S (its twin: csrc
# bwd_loads<S>; change both together)
BWD_LOADS = {1: 5, 2: 2, 4: 1, 8: 1}
_SM_COUNT = 132       # H100 SXM: the weight-gradient split fills about two waves

Layer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (W, U, b)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _card(tensors: Sequence[torch.Tensor]) -> bool:
    """True when the tensors lie on the card (then all must be float32),
    False when they lie on the CPU."""
    if not _on_card(*tensors):
        return False
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA train kernels take float32, got {t.dtype}")
    return True


def _check_layers(layers: Sequence[Layer], d: int) -> List[int]:
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused narrow train: 1 to {MAX_LAYERS} layers, got {len(layers)}")
    units, din = [], d
    for i, (W, U, b) in enumerate(layers):
        n = U.shape[0]
        _check(f"layers[{i}].W", W, (din, 4 * n))
        _check(f"layers[{i}].U", U, (n, 4 * n))
        _check(f"layers[{i}].b", b, (4 * n,))
        units.append(n)
        din = n
    if max(units) > NARROW_MAX or d > NARROW_MAX:
        raise ValueError(
            f"fused narrow train: every layer and the input at most {NARROW_MAX} wide, "
            f"got units {units}, input {d}"
        )
    return units


def _check_wide(x, W, U, b) -> Tuple[int, int, int, int]:
    T, B, din = x.shape
    n = U.shape[0]
    _check_T("wide layer train", T)
    _check("x", x, (T, B, din))
    _check("W", W, (din, 4 * n))
    _check("U", U, (n, 4 * n))
    _check("b", b, (4 * n,))
    if n % WIDE_ALIGN:
        raise ValueError(f"wide layer train: n % {WIDE_ALIGN} == 0 required, got n = {n}")
    return T, B, din, n


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _count(name: str, bf16: bool) -> None:
    LAUNCHES[f"{name}_fast" if bf16 else name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions (also the CPU path of every wrapper)
# ---------------------------------------------------------------------------

def lstm_recurrence_train_fwd_plain(xp, U, bf16: bool = False):
    """The recurrence over time (the port of pallas_train.py:_fwd_scan_hc):
    h, c (T, B, n) from the hoisted projection xp (T, B, 4n). ``bf16``: h
    and U rounded before each product."""
    T, B, _ = xp.shape
    n = U.shape[0]
    op = operand_map(bf16)
    h = torch.zeros((B, n), dtype=xp.dtype, device=xp.device)
    c = torch.zeros_like(h)
    Ur = op(U)
    hs, cs = [], []
    for t in range(T):
        h, c = gate_update(xp[t] + torch.matmul(op(h), Ur), c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_recurrence_train_bwd_plain(xp, U, h, c, dh_seq, bf16: bool = False):
    """Reverse-time backward of the recurrence through gate_update_bwd (the
    port of pallas_train.py:_trainable_bwd). Returns (dxp, dU). ``bf16``:
    every product's operands rounded (the z recompute as the forward's)."""
    T, B, _ = xp.shape
    n = U.shape[0]
    op = operand_map(bf16)
    zeros = torch.zeros((B, n), dtype=xp.dtype, device=xp.device)
    h_prev = op(torch.cat([zeros[None], h[:-1]]))
    c_prev = torch.cat([zeros[None], c[:-1]])
    Ur = op(U)
    Ut = Ur.t()
    dh_c, dc = zeros, zeros
    dzs = [None] * T
    for t in range(T - 1, -1, -1):
        z = xp[t] + torch.matmul(h_prev[t], Ur)  # gate recompute (remat)
        dz, dc = gate_update_bwd(z, c_prev[t], c[t], dh_seq[t] + dh_c, dc)
        dh_c = torch.matmul(op(dz), Ut)
        dzs[t] = dz
    dz = torch.stack(dzs)
    return dz, torch.einsum("tbn,tbg->ng", h_prev, op(dz))


def _layer_fwd_plain(x, W, U, b, bf16: bool = False):
    """One layer over time: h, c (T, B, n) from x (T, B, d)."""
    op = operand_map(bf16)
    return lstm_recurrence_train_fwd_plain(torch.matmul(op(x), op(W)) + b, U, bf16)


def _layer_bwd_plain(x, W, U, b, h, c, dh_seq, bf16: bool = False):
    """Reverse-time backward of one layer. Returns (dx, dW, dU, db)."""
    op = operand_map(bf16)
    dz, dU = lstm_recurrence_train_bwd_plain(torch.matmul(op(x), op(W)) + b, U, h, c, dh_seq, bf16)
    dW = torch.einsum("tbd,tbg->dg", op(x), op(dz))
    return torch.matmul(op(dz), op(W).t()), dW, dU, dz.sum(dim=(0, 1))


def fused_narrow_train_fwd_plain(layers: Sequence[Layer], x: torch.Tensor, bf16: bool = False):
    """x (T, B, d) -> (hs, cs): every layer's h and c, (T, B, n_l) each."""
    hs, cs, inp = [], [], x
    for W, U, b in layers:
        h, c = _layer_fwd_plain(inp, W, U, b, bf16)
        hs.append(h)
        cs.append(c)
        inp = h
    return hs, cs


def fused_narrow_train_bwd_plain(layers: Sequence[Layer], x, hs, cs, dh_last, bf16: bool = False):
    """Top-down, layer by layer, each layer in reverse time. dh_last (T, B,
    n_last) is the cotangent on the last layer's h. Returns
    (dWs, dUs, dbs, dx), the lists in layer order."""
    L = len(layers)
    dWs, dUs, dbs = [None] * L, [None] * L, [None] * L
    dh = dh_last
    for i in range(L - 1, -1, -1):
        W, U, b = layers[i]
        inp = x if i == 0 else hs[i - 1]
        dh, dWs[i], dUs[i], dbs[i] = _layer_bwd_plain(inp, W, U, b, hs[i], cs[i], dh, bf16)
    return dWs, dUs, dbs, dh


def wide_layer_fwd_plain(x, W, U, b, bf16: bool = False):
    """x (T, B, d) -> h, c (T, B, n)."""
    return _layer_fwd_plain(x, W, U, b, bf16)


def wide_layer_bwd_plain(x, W, U, b, h, c, dh_seq, bf16: bool = False):
    """Returns (dx, dW, dU, db)."""
    return _layer_bwd_plain(x, W, U, b, h, c, dh_seq, bf16)


# ---------------------------------------------------------------------------
# weight gradients on the card (shared by both backward kernels)
# ---------------------------------------------------------------------------

def _splits(M: int, p: int, G: int) -> int:
    """How many contiguous ranges of M the weight-gradient sum is split
    into: enough CTAs for about two waves, each range ≥ 256 rows."""
    tiles = math.ceil(G / 64) * math.ceil(p / 64)
    return max(1, min(math.ceil(M / 256), math.ceil(2 * _SM_COUNT / tiles)))


def _weight_grad(A: torch.Tensor | None, shift: int, dz: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Σ_m a_m ⊗ dz_m over the rows of dz (M, G): a_m = A[m - shift] (zero
    for m < shift), or 1 when A is None (then the result is (G,)). ``bf16``:
    a_m and dz_m rounded, except for the sum of dz (A None)."""
    M, G = dz.shape
    p = 1 if A is None else A.shape[1]
    S = _splits(M, p, G)
    out = torch.empty((p, G), dtype=torch.float32, device=dz.device)
    partial = torch.empty((S, p, G), dtype=torch.float32, device=dz.device) if S > 1 else None
    _launch("weight_grad", dz.device, _ptr(A), shift, dz.data_ptr(), out.data_ptr(),
            _ptr(partial), M, p, G, S, int(bf16))
    return out[0] if A is None else out


def _layer_weight_grads(inp, h, dz, bf16: bool = False):
    """dW = Σ inpᵀ·dz, dU = Σ h_prevᵀ·dz, db = Σ dz for one layer."""
    T, B, G = dz.shape
    dz2 = dz.view(T * B, G)
    return (
        _weight_grad(inp.view(T * B, -1), 0, dz2, bf16),
        _weight_grad(h.view(T * B, -1), B, dz2, bf16),
        _weight_grad(None, 0, dz2),
    )


# ---------------------------------------------------------------------------
# K7 and K8: the narrow whole-stack train pairs (one function, two kernels)
# ---------------------------------------------------------------------------

def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def _staged_weight_floats(units: Sequence[int], d: int, stride) -> int:
    """Floats of every layer's [W; U] rows staged gate-interleaved, four
    floats an entry, at ``stride(n)`` entries a row."""
    total, din = 0, d
    for n in units:
        total += (din + n) * stride(n) * 4
        din = n
    return total


def narrow_fwd_threads(units: Sequence[int], d: int, lanes: int) -> int:
    """Threads of the forward's block (csrc ``fwd_threads``): ``lanes`` a
    unit, and at least one for each of x_t's NARROW_ROWS·d entries."""
    return max(_round_up(lanes * sum(units), 32), _round_up(NARROW_ROWS * d, 32))


def narrow_fwd_smem_bytes(units: Sequence[int], d: int, staged: bool) -> int:
    """Shared memory of the forward (csrc ``narrow_fwd_launch``): with
    ``staged`` every layer's [W; U] rows, four gates each, then two parities
    of the state vector [x_t | h_0 | ... | h_{L-1}], four rows an entry."""
    weights = _staged_weight_floats(units, d, lambda n: n) if staged else 0
    return 4 * (weights + 2 * NARROW_ROWS * (d + sum(units)))


def narrow_fwd_lanes(units: Sequence[int], d: int) -> int:
    """Lanes S a unit of the forward: the largest of 8, 4, 2, 1 whose block
    has at most FWD_MAX_THREADS threads. The wrapper passes it to the
    launcher, which checks it."""
    for lanes in (8, 4, 2):
        if narrow_fwd_threads(units, d, lanes) <= FWD_MAX_THREADS:
            return lanes
    return 1


def narrow_bwd_threads(units: Sequence[int], d: int, lanes: int) -> int:
    """Threads of the backward's block: ``lanes`` a unit of every layer and
    of the dx layer, at most BWD_MAX_THREADS (then dx units share layer 0's
    groups). The wrapper passes it to the launcher, which checks it."""
    return min(BWD_MAX_THREADS, _round_up(lanes * (sum(units) + d), 32))


def narrow_bwd_fits(units: Sequence[int], d: int, lanes: int, staged: bool) -> bool:
    """The launcher's checks (csrc ``narrow_bwd_launch`` and
    ``launch_bwd_wave``; change both together): S·Σn lanes and a group for
    every dx unit within the block, the state vector's NARROW_ROWS·(d + Σn)
    floats within the loads its threads make a step, and S = 1 only from
    the global copy (its stacks never fit staged)."""
    if lanes not in BWD_LOADS or (lanes == 1 and staged):
        return False
    threads = narrow_bwd_threads(units, d, lanes)
    return (lanes * sum(units) <= threads and d <= threads // lanes
            and NARROW_ROWS * (d + sum(units)) <= BWD_LOADS[lanes] * threads)


def narrow_bwd_lanes(units: Sequence[int], d: int) -> int:
    """Lanes S a unit of the backward: the largest of 8, 4, 2 whose block
    gives every unit and every dx unit a group of its own (S = 4 at 4×40
    and on the 4×30 view), else 1, where dx units past the block's 1024
    threads share layer 0's groups (8×128). Sharing at S = 8 on the 4×30
    view ran slower than S = 4 (scripts/probe_torch_narrow_bwd.py). The
    wrapper passes S to the launcher, which checks it."""
    for lanes in (8, 4, 2):
        if lanes * (sum(units) + d) <= BWD_MAX_THREADS:
            return lanes
    return 1


def narrow_bwd_smem_bytes(units: Sequence[int], d: int, staged: bool) -> int:
    """Shared memory of the backward (csrc ``narrow_bwd_launch``): with
    ``staged`` every layer's [W; U] rows, four gates an entry, at the odd
    row stride n | 1; then two parities of the state vector [x | h_0 | ...
    | h_{L-1}] and of every layer's dz, four rows an entry each."""
    weights = _staged_weight_floats(units, d, lambda n: n | 1) if staged else 0
    return 4 * (weights + 2 * NARROW_ROWS * (d + sum(units) + 4 * sum(units)))


def narrow_bwd_staged(units: Sequence[int], d: int) -> bool:
    """Where the backward keeps its weights: staged in shared memory when
    the stack fits, else read from the global copy :func:`pack_gates`,
    which fits every stack K7 admits (167 936 B at 8×128, d = 128)."""
    return narrow_bwd_smem_bytes(units, d, True) <= _SMEM_LIMIT


def pack_gates(W: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """K7's gate-interleaved copy of a layer for the kernels that read their
    weights from global memory: P (din + n, n, 4) with P[k, j, g] = [W;
    U][k, g·n + j] (csrc ``FwdLayer.P``, ``BwdLayer.P``)."""
    din, n = W.shape[0], U.shape[0]
    return torch.cat([W.view(din, 4, n), U.view(n, 4, n)]).transpose(1, 2).contiguous()


def compact_smem_bytes(units: Sequence[int], d: int) -> int:
    """K8's route rule, in bytes (193 184 + 14 720 B at 4×40, d = 16): the
    shared memory of the backward K8 first ran, every W, U and b at row
    stride 4n + 1 and four rows of its carries and scratch. The rule keeps
    that value, so the route stays where it was; the kernels K8 runs now fit
    every stack it admits (:func:`narrow_fwd_smem_bytes`,
    :func:`narrow_bwd_staged`)."""
    weights, din = 0, d
    for n in units:
        weights += (din + n) * (4 * n + 1) + 4 * n
        din = n
    scratch = NARROW_ROWS * (2 * sum(units) + 14 * max(units) + max(d, max(units)))
    return 4 * (weights + scratch)


def compact_fits(units: Sequence[int], d: int) -> bool:
    """K8's shape rule (:func:`compact_smem_bytes` within the shared memory
    one H100 block may use). A compact-eligible stack that does not fit
    (e.g. 4×64, or 8 layers of 64 with d = 128) trains through K7."""
    return compact_smem_bytes(units, d) <= _SMEM_LIMIT


def compact_eligible(model, d_in: int) -> bool:
    """The JAX package's eligibility for the compact train pair
    (``pallas_train_compact.compact_eligible``): every layer packs at least
    two gates into a 128-lane block (n ≤ 64) and the input fits one block."""
    return all(l.units <= COMPACT_MAX_UNITS for l in model.layers) and d_in <= NARROW_MAX


def _check_compact(name: str, units: List[int], d: int) -> None:
    if max(units) > COMPACT_MAX_UNITS:
        raise ValueError(f"{name}: every layer at most {COMPACT_MAX_UNITS} units, got {units}")
    if not compact_fits(units, d):
        raise ValueError(
            f"{name}: the route rule gives {compact_smem_bytes(units, d)} B of shared "
            f"memory, over {_SMEM_LIMIT}; such a stack trains through K7"
        )


def _narrow_fwd(wrapper, plain, layers: Sequence[Layer], x: torch.Tensor, bf16: bool):
    """The checks and the launch of K7's (``fused_narrow_train_fwd``) or
    K8's (``fused_narrow_train_compact_fwd``) forward; ``plain`` runs CPU
    tensors."""
    name = wrapper.__name__
    resident = wrapper is fused_narrow_train_compact_fwd
    T, B, d = x.shape
    _check_T(name, T)
    _check("x", x, (T, B, d))
    units = _check_layers(layers, d)
    if resident:
        _check_compact(name, units, d)
    if not _card([x, *(w for l in layers for w in l)]):
        return plain(layers, x, bf16)
    # K8 always stages its weights: a stack compact_fits admits fits staged
    # (tests/test_torch_narrow_fwd.py)
    staged = resident or narrow_fwd_smem_bytes(units, d, True) <= _SMEM_LIMIT
    hs, cs = _launch_narrow_fwd(name, layers, x, narrow_fwd_lanes(units, d), staged, bf16)
    _count(name, bf16)
    return hs, cs


def _launch_narrow_fwd(name: str, layers: Sequence[Layer], x: torch.Tensor, lanes: int,
                       staged: bool, bf16: bool = False):
    """One launch of the narrow forward ``name`` (K7's or K8's launcher) on
    checked card tensors, at ``lanes`` a unit, the weights staged in shared
    memory (the bf16 variant rounds them as it stages them) or read from
    :func:`pack_gates`' copy (rounded here for the bf16 variant)."""
    T, B, d = x.shape
    units = [U.shape[0] for _, U, _ in layers]
    if lanes not in (1, 2, 4, 8) or narrow_fwd_threads(units, d, lanes) > FWD_MAX_THREADS:
        raise ValueError(f"{name}: {lanes} lanes a unit do not fit a block of {FWD_MAX_THREADS} threads")
    _check_smem(name, narrow_fwd_smem_bytes(units, d, staged) // 4)
    hs = [torch.empty((T, B, n), dtype=torch.float32, device=x.device) for n in units]
    cs = [torch.empty_like(h) for h in hs]
    op = operand_map(bf16)
    packed = [None if staged else op(pack_gates(W, U)) for W, U, _ in layers]
    meta = np.array(
        [[W.shape[0], U.shape[0], W.data_ptr(), U.data_ptr(), b.data_ptr(), h.data_ptr(),
          c.data_ptr(), _ptr(P) or 0] for (W, U, b), h, c, P in zip(layers, hs, cs, packed)],
        dtype=np.int64,
    )
    _launch(name, x.device, meta.ctypes.data, len(layers), x.data_ptr(), T, B, d, lanes, int(bf16))
    return hs, cs


def _narrow_bwd(wrapper, plain, layers: Sequence[Layer], x, hs, cs, dh_last, bf16: bool):
    """The checks and the launches of K7's or K8's backward (the reverse-time
    kernel, then ``weight_grad`` per layer); ``plain`` runs CPU tensors."""
    name = wrapper.__name__
    T, B, d = x.shape
    _check_T(name, T)
    _check("x", x, (T, B, d))
    units = _check_layers(layers, d)
    if wrapper is fused_narrow_train_compact_bwd:
        _check_compact(name, units, d)
    if len(hs) != len(layers) or len(cs) != len(layers):
        raise ValueError(f"{name}: one h and one c per layer")
    for i, n in enumerate(units):
        _check(f"hs[{i}]", hs[i], (T, B, n))
        _check(f"cs[{i}]", cs[i], (T, B, n))
    _check("dh_last", dh_last, (T, B, units[-1]))
    if not _card([x, dh_last, *hs, *cs, *(w for l in layers for w in l)]):
        return plain(layers, x, hs, cs, dh_last, bf16)
    dx, dzs = _launch_narrow_bwd(name, layers, x, hs, cs, dh_last, narrow_bwd_lanes(units, d),
                                 narrow_bwd_staged(units, d), bf16)
    grads = [_layer_weight_grads(x if i == 0 else hs[i - 1], hs[i], dzs[i], bf16)
             for i in range(len(layers))]
    _count(name, bf16)
    dWs, dUs, dbs = (list(g) for g in zip(*grads))
    return dWs, dUs, dbs, dx


def _launch_narrow_bwd(name: str, layers: Sequence[Layer], x, hs, cs, dh_last, lanes: int,
                       staged: bool, bf16: bool = False):
    """One launch of the narrow backward ``name`` (K7's or K8's launcher) on
    checked card tensors, at ``lanes`` a unit, the weights staged in shared
    memory or read from :func:`pack_gates`' copy (rounded here for the bf16
    variant). Returns dx (T, B, d) and every layer's dz (T, B, 4n)."""
    T, B, d = x.shape
    units = [U.shape[0] for _, U, _ in layers]
    if not narrow_bwd_fits(units, d, lanes, staged):
        raise ValueError(f"{name}: no block of {lanes} lanes a unit with the weights "
                         f"{'staged' if staged else 'in the global copy'}")
    _check_smem(name, narrow_bwd_smem_bytes(units, d, staged) // 4)
    dx = torch.empty((T, B, d), dtype=torch.float32, device=x.device)
    dzs = [torch.empty((T, B, 4 * n), dtype=torch.float32, device=x.device) for n in units]
    op = operand_map(bf16)
    packed = [None if staged else op(pack_gates(W, U)) for W, U, _ in layers]
    meta = np.array(
        [[W.shape[0], U.shape[0], W.data_ptr(), U.data_ptr(), b.data_ptr(), _ptr(P) or 0,
          h.data_ptr(), c.data_ptr(), dz.data_ptr()]
         for (W, U, b), P, h, c, dz in zip(layers, packed, hs, cs, dzs)],
        dtype=np.int64,
    )
    _launch(name, x.device, meta.ctypes.data, len(layers), x.data_ptr(), dh_last.data_ptr(),
            dx.data_ptr(), T, B, d, lanes, narrow_bwd_threads(units, d, lanes), int(bf16))
    return dx, dzs


def fused_narrow_train_fwd(layers: Sequence[Layer], x: torch.Tensor, bf16: bool = False):
    """K7 (K7f with ``bf16``), whole-stack forward for narrow stacks (every
    layer n ≤ 128, d ≤ 128, at most 8 layers). x (T, B, d) -> (hs, cs),
    (T, B, n_l) per layer."""
    return _narrow_fwd(fused_narrow_train_fwd, fused_narrow_train_fwd_plain, layers, x, bf16)


def fused_narrow_train_bwd(layers: Sequence[Layer], x, hs, cs, dh_last, bf16: bool = False):
    """K7 (K7f), whole-stack reverse-time backward. dh_last (T, B, n_last)
    is the cotangent on the last layer's h. Returns (dWs, dUs, dbs, dx)."""
    return _narrow_bwd(fused_narrow_train_bwd, fused_narrow_train_bwd_plain, layers, x, hs, cs,
                       dh_last, bf16)


def fused_narrow_train_compact_fwd_plain(layers: Sequence[Layer], x: torch.Tensor,
                                         bf16: bool = False):
    """K8's function is K7's: its plain version is K7's."""
    return fused_narrow_train_fwd_plain(layers, x, bf16)


def fused_narrow_train_compact_bwd_plain(layers: Sequence[Layer], x, hs, cs, dh_last,
                                         bf16: bool = False):
    """K8's function is K7's: its plain version is K7's."""
    return fused_narrow_train_bwd_plain(layers, x, hs, cs, dh_last, bf16)


def fused_narrow_train_compact_fwd(layers: Sequence[Layer], x: torch.Tensor, bf16: bool = False):
    """K8 (K8f with ``bf16``), the whole-stack forward with the weights
    resident in shared memory, for compact-eligible stacks (every layer
    n ≤ 64, d ≤ 128) that fit (:func:`compact_fits`). x (T, B, d) -> (hs,
    cs)."""
    return _narrow_fwd(fused_narrow_train_compact_fwd, fused_narrow_train_compact_fwd_plain,
                       layers, x, bf16)


def fused_narrow_train_compact_bwd(layers: Sequence[Layer], x, hs, cs, dh_last,
                                   bf16: bool = False):
    """K8 (K8f), the whole-stack reverse-time backward. Returns (dWs, dUs,
    dbs, dx)."""
    return _narrow_bwd(fused_narrow_train_compact_bwd, fused_narrow_train_compact_bwd_plain,
                       layers, x, hs, cs, dh_last, bf16)


def _stack_forward(ctx, fwd, bf16, x, weights):
    layers = [tuple(weights[i : i + 3]) for i in range(0, len(weights), 3)]
    hs, cs = fwd(layers, x, bf16)
    ctx.save_for_backward(x, *weights, *hs, *cs)
    ctx.num_layers, ctx.bf16 = len(layers), bf16
    return hs[-1]


def _stack_backward(ctx, bwd, dh_last):
    L = ctx.num_layers
    saved = ctx.saved_tensors
    x, weights = saved[0], saved[1 : 1 + 3 * L]
    hs, cs = list(saved[1 + 3 * L : 1 + 4 * L]), list(saved[1 + 4 * L :])
    layers = [tuple(weights[i : i + 3]) for i in range(0, 3 * L, 3)]
    dWs, dUs, dbs, dx = bwd(layers, x, hs, cs, dh_last.contiguous(), ctx.bf16)
    return (None, dx, *(g for tri in zip(dWs, dUs, dbs) for g in tri))


class FusedNarrowTrain(torch.autograd.Function):
    """Differentiable whole-stack recurrence through K7 (K7f with
    ``bf16``): (bf16, x (T, B, d), W0, U0, b0, W1, ...) -> the last layer's
    h (T, B, n_last). The forward saves every layer's h and c; the backward
    is the reverse-time kernel."""

    @staticmethod
    def forward(ctx, bf16, x, *weights):
        return _stack_forward(ctx, fused_narrow_train_fwd, bf16, x, weights)

    @staticmethod
    def backward(ctx, dh_last):
        return _stack_backward(ctx, fused_narrow_train_bwd, dh_last)


class FusedNarrowTrainCompact(torch.autograd.Function):
    """:class:`FusedNarrowTrain` through K8 (K8f; the same function and
    kernels, the weights staged in shared memory)."""

    @staticmethod
    def forward(ctx, bf16, x, *weights):
        return _stack_forward(ctx, fused_narrow_train_compact_fwd, bf16, x, weights)

    @staticmethod
    def backward(ctx, dh_last):
        return _stack_backward(ctx, fused_narrow_train_compact_bwd, dh_last)


def _stack_apply(fn, model, x_seq: torch.Tensor, return_sequences: bool, bf16: bool):
    x = x_seq.transpose(0, 1).contiguous()  # (T, B, d)
    weights = [w.contiguous() for l in model.layers for w in (l.W, l.U, l.b)]
    h = fn.apply(bf16, x, *weights)  # (T, B, n)
    if not return_sequences:
        return model.head(h[-1])
    return model.head(h).transpose(0, 1)


def fused_narrow_train_apply(model, x_seq: torch.Tensor, return_sequences: bool = True,
                             bf16: bool = False):
    """Whole-stack trainable forward for narrow models through K7 (K7f with
    ``bf16``). ``model`` has ``layers`` (each with W, U, b) and a ``head``.
    x_seq (B, T, d) -> (B, T, out), or (B, out) for the last step."""
    return _stack_apply(FusedNarrowTrain, model, x_seq, return_sequences, bf16)


def fused_narrow_train_apply_compact(model, x_seq: torch.Tensor, return_sequences: bool = True,
                                     bf16: bool = False):
    """:func:`fused_narrow_train_apply` through K8 (K8f), for
    compact-eligible stacks that fit (:func:`compact_eligible`,
    :func:`compact_fits`)."""
    return _stack_apply(FusedNarrowTrainCompact, model, x_seq, return_sequences, bf16)


# ---------------------------------------------------------------------------
# K9's and K6's backward: phases R, C, X, G (csrc gemm_f32, wide_bwd_chain;
# K9f's and K6f's: gemm_bf16, wide_bwd_chain's BF16 instantiation)
# ---------------------------------------------------------------------------

GEMM_TILE = (128, 128)  # csrc GM_BM, GM_BN: a GEMM CTA's rows × columns of C
GEMM_BK = 16           # csrc GM_BK: the K chunk of a GEMM
GEMM_MAX_SEGS = 2      # csrc GM_MAX_SEGS: products summed by one GEMM
GEMM_MAX_SPLITS = 16
GEMM_PER_SM = 2        # gemm_f32's CTAs an SM (csrc __launch_bounds__)
GEMM_BF16_BK = 64      # csrc GB_BK: gemm_bf16's K chunk, one TMA box deep
GEMM_BF16_PER_SM = 1   # gemm_bf16's CTAs an SM: its ring of 4 stages takes 129 KB
BF16_ALIGN = 8         # a bf16 copy's row stride: whole 16 bytes (TMA's stride rule)
# phase C's tiles, rows × units a CTA (csrc wide_bwd_chain_launch), by width:
# the first whose unit groups the card's SMs hold. U is staged at the first
# only: the wider ones are taken past 16·SMs units, where it never fits.
CHAIN_TILES = ((32, 16), (16, 32), (8, 64))
CHAIN_MAX_ROW_TILES = 8  # csrc CHAIN_MAX_ROW_TILES


class ChainPlan(NamedTuple):
    """Phase C's launches (csrc ``wide_bwd_chain_launch``, which checks
    each): the batch in chunks of at most ``chunk_rows`` rows, one launch a
    chunk; in each, a CTA owns ``units`` units and walks at most
    ``row_tiles`` tiles of ``rows`` batch rows a step; the grid is
    unit_groups × row_groups CTAs (fewer row groups where a chunk has fewer
    row tiles), one an SM at most, all co-resident."""

    rows: int
    units: int
    staged: bool
    unit_groups: int
    row_groups: int
    row_tiles: int
    chunk_rows: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.unit_groups * self.row_groups


def chain_smem_bytes(n: int, rows: int, units: int, staged: bool) -> int:
    """Shared memory of phase C: the tile's dz at the CTA's 4·units gate
    columns, and with ``staged`` those columns of U for all n units."""
    return 4 * 4 * units * (rows + (n if staged else 0))


def chain_smem_bytes_bf16(n: int, rows: int, units: int, staged: bool) -> int:
    """Shared memory of phase C's bf16 instantiation (csrc launch_chain):
    bf16 rows of 4·units + 8 (16 bytes of padding a row), the dz tile's
    rows rounded up to the mma's 16, and with ``staged`` one row a unit of
    U at the CTA's gate columns."""
    return 2 * (4 * units + 8) * (_round_up(rows, 16) + (n if staged else 0))


def bf16_ld(cols: int) -> int:
    """The row stride of a bf16 copy of ``cols`` columns: a multiple of
    BF16_ALIGN, the columns past ``cols`` zero."""
    return _round_up(cols, BF16_ALIGN)


def fwd_chain_smem_bytes(n: int, rows: int, units: int, staged: bool) -> int:
    """Shared memory of the forward chain (csrc ``launch_fwd_chain``): the
    tile's rows of h_{t-1} (n + 4 floats a row), and with ``staged`` the
    CTA's 4·units gate columns of U for all n inputs."""
    return 4 * rows * (n + 4) + (16 * n * units if staged else 0)


def chain_plan(B: int, n: int, sm_count: int, smem_bytes=chain_smem_bytes,
               name: str = "wide backward chain") -> ChainPlan:
    """Phase C's tile, weight home, grid and chunks for a batch of B rows
    and n units on a card of ``sm_count`` SMs: the first of CHAIN_TILES
    whose n / units groups the SMs hold; U staged where it fits a block's
    shared memory (at the first tile), else read from the global copy; as
    many row groups as the SMs left by the unit groups hold, at most one a
    row tile; the batch split into the fewest chunks of equal row tiles that
    keep each CTA within CHAIN_MAX_ROW_TILES. Raises where even the widest
    unit groups outnumber the SMs (n > 64·sm_count) or the tile's shared
    memory (``smem_bytes``; the forward chain's is
    :func:`fwd_chain_smem_bytes`) exceeds a block's."""
    for rows, units in CHAIN_TILES:
        if n // units <= sm_count:
            break
    else:
        raise ValueError(f"{name}: n = {n} needs {-(-n // units)} unit groups of "
                         f"{units}, which cannot be co-resident on {sm_count} SMs")
    if n % units or n % 8:
        raise ValueError(f"{name}: n = {n} does not split into {units}-unit groups")
    staged = (rows, units) == CHAIN_TILES[0] and smem_bytes(n, rows, units, True) <= _SMEM_LIMIT
    smem = smem_bytes(n, rows, units, staged)
    _check_smem(name, smem // 4)
    unit_groups = n // units
    most = sm_count // unit_groups  # row groups the SMs hold
    tiles = -(-B // rows)
    chunks = -(-tiles // (most * CHAIN_MAX_ROW_TILES))
    chunk_tiles = -(-tiles // chunks)
    row_groups = min(chunk_tiles, most)
    row_tiles = -(-chunk_tiles // row_groups)
    return ChainPlan(rows, units, staged, unit_groups, row_groups, row_tiles, chunk_tiles * rows, smem)


def gemm_splits(K: int, tiles: int, sm_count: int, per_sm: int = GEMM_PER_SM) -> int:
    """Splits S of a TN GEMM's reduction over K rows (phase G): the S ≤
    GEMM_MAX_SPLITS, each split at least 256 rows, whose CTAs (``per_sm``
    an SM: two of gemm_f32's, GEMM_BF16_PER_SM of gemm_bf16's) run in the
    fewest waves per unit of work, ⌈tiles·S / slots⌉ / S; the smallest
    such S."""
    slots = per_sm * sm_count
    best, best_cost = 1, math.inf
    for S in range(1, min(GEMM_MAX_SPLITS, max(1, K // 256)) + 1):
        cost = math.ceil(tiles * S / slots) / S
        if cost < best_cost - 1e-12:
            best, best_cost = S, cost
    return best


def _seg(A: torch.Tensor, lda: int, B: torch.Tensor, ldb: int, K: int, a_t: int = 0,
         b_t: int = 0, shift: int = 0, ones_row: int = -1) -> list:
    """One product of a GEMM (csrc ``GemmSeg``, in its meta order)."""
    return [A.data_ptr(), B.data_ptr(), lda, ldb, a_t, b_t, shift, ones_row, K]


def _gemm(C: torch.Tensor, M: int, N: int, segs, offset: int = 0, bias=None, addend=None,
          splits: int = 1, kchunk: int = 0, split_stride: int = 0) -> None:
    """C[offset:] (M, N), row stride N, = Σ of the products ``segs`` (+ bias)
    (+ addend), by csrc gemm_f32; with ``splits`` > 1 split s of the
    reduction goes to C[offset + s·split_stride:]."""
    meta = np.zeros(10 + 9 * GEMM_MAX_SEGS, dtype=np.int64)
    meta[:10] = [len(segs), M, N, C.data_ptr() + 4 * offset, N, _ptr(bias) or 0,
                 _ptr(addend) or 0, splits, kchunk, split_stride]
    for i, seg in enumerate(segs):
        meta[10 + 9 * i : 19 + 9 * i] = seg
    _launch("wide_gemm", C.device, meta.ctypes.data)


def phase_r(x, W, U, b, h) -> torch.Tensor:
    """z (T, B, 4n) = x·W + h_prev·U + b over all T·B rows, h_prev being h
    read B rows back (zero at t = 0); K6 (W None, x the projection xp): z =
    xp + h_prev·U."""
    T, B, din = x.shape
    n = U.shape[0]
    z = torch.empty((T, B, 4 * n), dtype=torch.float32, device=x.device)
    h_prev = _seg(h, n, U, 4 * n, n, shift=B)
    if W is None:
        _gemm(z, T * B, 4 * n, [h_prev], addend=x)
    else:
        _gemm(z, T * B, 4 * n, [_seg(x, din, W, 4 * n, din), h_prev], bias=b)
    return z


def phase_c(z, Ut, c, dh_seq, dz, plan: ChainPlan) -> None:
    """The dh chain (csrc wide_bwd_chain) from z and Ut = Uᵀ (4n, n): every
    step's dz into ``dz`` (T, B, 4n), one launch a chunk of the batch's
    rows."""
    T, B, n = c.shape
    G = 4 * n
    # the partial sums of dh: two parities of unit_groups × chunk rows × n
    P = torch.empty(2 * plan.unit_groups * min(B, plan.chunk_rows) * n, dtype=torch.float32,
                    device=z.device)
    for b0 in range(0, B, plan.chunk_rows):
        rows = min(plan.chunk_rows, B - b0)
        row_groups = min(plan.row_groups, -(-rows // plan.rows))
        _launch("wide_bwd_chain", z.device, z.data_ptr() + 4 * b0 * G, Ut.data_ptr(),
                c.data_ptr() + 4 * b0 * n, dh_seq.data_ptr() + 4 * b0 * n,
                dz.data_ptr() + 4 * b0 * G, P.data_ptr(), T, rows, B, n, plan.rows, plan.units,
                int(plan.staged), row_groups)


def phase_x(dz, W) -> torch.Tensor:
    """dx (T, B, din) = dz·Wᵀ."""
    T, B, G = dz.shape
    dx = torch.empty((T, B, W.shape[0]), dtype=torch.float32, device=dz.device)
    _gemm(dx, T * B, W.shape[0], [_seg(dz, G, W, G, G, b_t=1)])
    return dx


def phase_g(inp, h, dz, sm_count: int):
    """The weight gradients over all T·B rows, split over them in a fixed
    order (:func:`gemm_splits`) and summed in order: one output of rows [dW;
    db; dU] (K9, ``inp`` the layer's input; db is a row of ones beside inp's
    columns), or dU alone (K6, ``inp`` None). Returns (dW, dU, db), views of
    that output, or dU."""
    T, B, G = dz.shape
    n, M = h.shape[2], T * B
    gemms = []  # (first output row, rows, product)
    if inp is not None:
        din = inp.shape[2]
        gemms.append((0, din + 1, _seg(inp, din, dz, G, M, a_t=1, ones_row=din)))
    first = 0 if inp is None else din + 1
    gemms.append((first, n, _seg(h, n, dz, G, M, a_t=1, shift=B)))
    rows = first + n
    BM, BN = GEMM_TILE
    S = gemm_splits(M, sum(-(-r // BM) * -(-G // BN) for _, r, _ in gemms), sm_count)
    out = torch.empty((rows, G), dtype=torch.float32, device=dz.device)
    partial = torch.empty((S, rows, G), dtype=torch.float32, device=dz.device) if S > 1 else out
    kchunk = _round_up(-(-M // S), GEMM_BK)
    for r0, r, seg in gemms:
        _gemm(partial, r, G, [seg], offset=r0 * G, splits=S, kchunk=kchunk,
              split_stride=rows * G)
    if S > 1:
        _launch("sum_splits", dz.device, partial.data_ptr(), out.data_ptr(), rows * G, S)
    if inp is None:
        return out
    return out[:din], out[din + 1 :], out[din]


def sm_count(device: torch.device) -> int:
    """The card's own SM count."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def wide_bwd(x, W, U, b, h, c, dh_seq, bf16: bool = False):
    """K9's backward (W given) or K6's (W and b None, x the projection xp)
    on checked card tensors: phase R (z), C (the dh chain, writing dz; K6's
    dz is dxp), X (dx, K9) and G (the weight gradients). Returns (dx, dW,
    dU, db) or (dxp, dU). ``bf16``: K9f's or K6f's, :func:`wide_bwd_bf16`."""
    if bf16:
        return wide_bwd_bf16(x, W, U, b, h, c, dh_seq)
    T, B, _ = x.shape
    n = U.shape[0]
    sms = sm_count(x.device)
    plan = chain_plan(B, n, sms)
    z = phase_r(x, W, U, b, h)
    dz = torch.empty_like(z)
    phase_c(z, U.t().contiguous(), c, dh_seq, dz, plan)
    del z  # 4·T·B·4n bytes: freed before phases X and G
    if W is None:
        return dz, phase_g(None, h, dz, sms)
    return (phase_x(dz, W), *phase_g(x, h, dz, sms))


# the bf16 backward (K9f, K6f): every product's operands as bf16 copies

class Bf16Operands(NamedTuple):
    """The bf16 copies of one call's operands (csrc bf16_copy, each (rows,
    ld) with its row stride padded by :func:`bf16_ld`): x (T·B, ld(d)) and
    W (ld(d), 4n), whose extra row is zero, so the K of x·W covers x's
    padded columns (K9; None for K6), U (n, 4n), and h (T·B, n)."""

    x: torch.Tensor | None
    W: torch.Tensor | None
    U: torch.Tensor
    h: torch.Tensor


def bf16_copy(a: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """A 2-D float32 card tensor rounded to bf16 (to nearest even) into a
    zeroed copy of ``rows`` rows (at least a's) and :func:`bf16_ld` columns,
    by csrc bf16_copy."""
    r, cols = a.shape
    rows = r if rows is None else rows
    out = torch.empty((rows, bf16_ld(cols)), dtype=torch.bfloat16, device=a.device)
    _launch("bf16_copy", a.device, a.data_ptr(), out.data_ptr(), r, cols, rows, out.shape[1])
    return out


def bf16_xw(x, W) -> Tuple[torch.Tensor, torch.Tensor]:
    """The copies of x (T·B, ld(d)) and W (ld(d), 4n), W's rows past d zero,
    so the K of x·W runs over x's padded columns. (The forward chain's U is
    the one operand not copied by :func:`bf16_copy`: it takes bf16(U)ᵀ,
    transposed, as K5 does, which the copy kernel does not do.)"""
    xb = bf16_copy(x.view(-1, x.shape[2]))
    return xb, bf16_copy(W, rows=xb.shape[1])


def bf16_operands(x, W, U, h) -> Bf16Operands:
    """The copies :class:`Bf16Operands` of one call (W None: K6, no x)."""
    T, B, n = h.shape
    xb, Wb = (None, None) if W is None else bf16_xw(x, W)
    return Bf16Operands(xb, Wb, bf16_copy(U), bf16_copy(h.view(T * B, n)))


def _seg_bf16(A: torch.Tensor, B: torch.Tensor, K: int, shift: int = 0) -> list:
    """One product of gemm_bf16 (csrc gemm_bf16_launch's meta row): A and B
    bf16 copies (rows, ld)."""
    return [A.data_ptr(), A.shape[0], A.shape[1], B.data_ptr(), B.shape[0], B.shape[1], shift, K]


GEMM_FORMS = {"NN": 0, "NT": 1, "TN": 2}  # csrc gemm_bf16_launch's form


def _gemm_bf16(C: torch.Tensor, M: int, N: int, form: str, segs, offset: int = 0, bias=None,
               addend=None, splits: int = 1, kchunk: int = 0, split_stride: int = 0) -> None:
    """C[offset:] (M, N), row stride N, = Σ of the bf16 products ``segs``
    (+ bias) (+ addend, float32), by csrc gemm_bf16 in ``form`` (NN: A and
    B as stored; NT: B read transposed; TN: A read transposed); with
    ``splits`` > 1 split s of the reduction goes to C[offset +
    s·split_stride:]."""
    meta = np.zeros(11 + 8 * GEMM_MAX_SEGS, dtype=np.int64)
    meta[:11] = [len(segs), M, N, C.data_ptr() + 4 * offset, N, _ptr(bias) or 0,
                 _ptr(addend) or 0, splits, kchunk, split_stride, GEMM_FORMS[form]]
    for i, seg in enumerate(segs):
        meta[11 + 8 * i : 19 + 8 * i] = seg
    _launch("gemm_bf16", C.device, meta.ctypes.data)


def phase_r_bf16(ops: Bf16Operands, b, xp, B: int) -> torch.Tensor:
    """z (T·B, 4n) float32 = x·W + h_prev·U + b (K9), or xp + h_prev·U (K6,
    xp (T, B, 4n)), on the copies, h_prev being h read B rows back: the
    bias and xp added unrounded."""
    M, n = ops.h.shape
    z = torch.empty((M, 4 * n), dtype=torch.float32, device=ops.h.device)
    h_prev = _seg_bf16(ops.h, ops.U, n, shift=B)
    if ops.x is None:
        _gemm_bf16(z, M, 4 * n, "NN", [h_prev], addend=xp)
    else:
        _gemm_bf16(z, M, 4 * n, "NN", [_seg_bf16(ops.x, ops.W, ops.x.shape[1]), h_prev], bias=b)
    return z


def phase_c_bf16(z, Ub, c, dh_seq, dz, dzb, plan: ChainPlan) -> None:
    """The bf16 dh chain (csrc wide_bwd_chain's BF16 instantiation) from z
    and U's copy Ub (n, 4n): every step's dz into ``dz`` (T, B, 4n) and,
    rounded, into ``dzb`` (T·B, 4n), one launch a chunk of the batch's
    rows."""
    T, B, n = c.shape
    G = 4 * n
    P = torch.empty(2 * plan.unit_groups * min(B, plan.chunk_rows) * n, dtype=torch.float32,
                    device=z.device)
    for b0 in range(0, B, plan.chunk_rows):
        rows = min(plan.chunk_rows, B - b0)
        row_groups = min(plan.row_groups, -(-rows // plan.rows))
        _launch("wide_bwd_chain_bf16", z.device, z.data_ptr() + 4 * b0 * G, Ub.data_ptr(),
                c.data_ptr() + 4 * b0 * n, dh_seq.data_ptr() + 4 * b0 * n,
                dz.data_ptr() + 4 * b0 * G, dzb.data_ptr() + 2 * b0 * G, P.data_ptr(), T, rows, B,
                n, plan.rows, plan.units, int(plan.staged), row_groups)


def phase_x_bf16(dzb, Wb, din: int) -> torch.Tensor:
    """dx (T·B, din) = dz·Wᵀ on the copies (W's read transposed)."""
    M, G = dzb.shape
    dx = torch.empty((M, din), dtype=torch.float32, device=dzb.device)
    _gemm_bf16(dx, M, din, "NT", [_seg_bf16(dzb, Wb, G)])
    return dx


def phase_g_bf16(ops: Bf16Operands, dzb, dz, din: int, B: int, sm_count: int):
    """The weight gradients on the copies, as :func:`phase_g` orders them
    (split over the T·B rows by :func:`gemm_splits`, each split's K a whole
    number of gemm_bf16's chunks, summed in order), into rows [dW; db; dU]
    (K9) or dU (K6); db, the unrounded sum of dz, comes from
    ``weight_grad``: the GEMM would round dz."""
    M, G = dzb.shape
    n = ops.h.shape[1]
    gemms = []  # (first output row, rows, product)
    if ops.x is not None:
        gemms.append((0, din, _seg_bf16(ops.x, dzb, M)))
    first = 0 if ops.x is None else din + 1
    gemms.append((first, n, _seg_bf16(ops.h, dzb, M, shift=B)))
    rows = first + n
    BM, BN = GEMM_TILE
    S = gemm_splits(M, sum(-(-r // BM) * -(-G // BN) for _, r, _ in gemms), sm_count,
                    GEMM_BF16_PER_SM)
    out = torch.empty((rows, G), dtype=torch.float32, device=dzb.device)
    partial = torch.empty((S, rows, G), dtype=torch.float32, device=dzb.device) if S > 1 else out
    kchunk = _round_up(-(-M // S), GEMM_BF16_BK)
    for r0, r, seg in gemms:
        _gemm_bf16(partial, r, G, "TN", [seg], offset=r0 * G, splits=S, kchunk=kchunk,
                   split_stride=rows * G)
    if S > 1:
        _launch("sum_splits", dzb.device, partial.data_ptr(), out.data_ptr(), rows * G, S)
    if ops.x is None:
        return out
    out[din] = _weight_grad(None, 0, dz.view(M, G))
    return out[:din], out[din + 1 :], out[din]


def wide_bwd_bf16(x, W, U, b, h, c, dh_seq):
    """K9f's backward (W given) or K6f's (W and b None, x the projection
    xp) on checked card tensors: the operands' bf16 copies, phase R
    (gemm_bf16), C (the bf16 chain, writing dz and its bf16 copy), X and G
    (gemm_bf16; db by weight_grad). Returns (dx, dW, dU, db) or (dxp, dU)."""
    T, B, din = x.shape
    n = U.shape[0]
    sms = sm_count(x.device)
    plan = chain_plan(B, n, sms, chain_smem_bytes_bf16)
    ops = bf16_operands(x, W, U, h)
    z = phase_r_bf16(ops, b, x if W is None else None, B)
    dz = torch.empty((T, B, 4 * n), dtype=torch.float32, device=x.device)
    dzb = torch.empty((T * B, 4 * n), dtype=torch.bfloat16, device=x.device)
    phase_c_bf16(z, ops.U, c, dh_seq, dz, dzb, plan)
    del z  # 4·T·B·4n bytes: freed before phases X and G
    if W is None:
        return dz, phase_g_bf16(ops, dzb, dz, 0, B, sms)
    dx = phase_x_bf16(dzb, ops.W, din).view(T, B, din)
    return (dx, *phase_g_bf16(ops, dzb, dz, din, B, sms))


# ---------------------------------------------------------------------------
# K9's and K6's forward: the x-side GEMM and the chain (csrc wide_fwd_chain)
# ---------------------------------------------------------------------------

def fwd_chain_plan(B: int, n: int, sm_count: int) -> ChainPlan:
    """The forward chain's tile, weight home, grid and chunks:
    :func:`chain_plan`'s rule with the forward's shared memory."""
    return chain_plan(B, n, sm_count, fwd_chain_smem_bytes, "wide forward chain")


def pack_gates_interleaved(U: torch.Tensor) -> torch.Tensor:
    """U (n, 4n) as (n, n, 4): P[k, j, g] = U[k, g·n + j], a unit's four
    gates at input k in one 16-byte entry."""
    n = U.shape[0]
    return U.reshape(n, 4, n).transpose(1, 2).contiguous()


def phase_x_side(x, W, b) -> torch.Tensor:
    """xz (T, B, 4n) = x·W + b over all T·B rows (gemm_f32 NN, the bias
    added to each row)."""
    T, B, din = x.shape
    G = W.shape[1]
    xz = torch.empty((T, B, G), dtype=torch.float32, device=x.device)
    _gemm(xz, T * B, G, [_seg(x, din, W, G, din)], bias=b)
    return xz


def phase_chain_fwd(xz, Ui, h, c, plan: ChainPlan) -> None:
    """The forward chain (csrc wide_fwd_chain) from the x-side xz (T, B,
    4n) and U gate-interleaved: h and c (T, B, n), one launch a chunk of
    the batch's rows."""
    T, B, n = h.shape
    G = 4 * n
    for b0 in range(0, B, plan.chunk_rows):
        rows = min(plan.chunk_rows, B - b0)
        row_groups = min(plan.row_groups, -(-rows // plan.rows))
        _launch("wide_fwd_chain", h.device, xz.data_ptr() + 4 * b0 * G, Ui.data_ptr(),
                h.data_ptr() + 4 * b0 * n, c.data_ptr() + 4 * b0 * n, T, rows, B, n, plan.rows,
                plan.units, int(plan.staged), row_groups)


def wide_fwd(x, W, U, b, bf16: bool = False):
    """K9's forward (W given: the x-side GEMM, then the chain) or K6's (W
    and b None, x the projection xp: the chain alone) on checked card
    tensors. Returns h, c (T, B, n). ``bf16``: K9f's or K6f's,
    :func:`wide_fwd_bf16`."""
    if bf16:
        return wide_fwd_bf16(x, W, U, b)
    T, B, _ = x.shape
    n = U.shape[0]
    plan = fwd_chain_plan(B, n, sm_count(x.device))
    xz = x if W is None else phase_x_side(x, W, b)
    h = torch.empty((T, B, n), dtype=torch.float32, device=x.device)
    c = torch.empty_like(h)
    phase_chain_fwd(xz, pack_gates_interleaved(U), h, c, plan)
    return h, c


# the bf16 forward (K9f, K6f): the x-side on gemm_bf16, the chain on
# batched_chain (K5's kernel) with c stored

def fwd_plan_bf16(device: torch.device, B: int, n: int) -> cb.BatchedPlan:
    """The bf16 forward chain's tile, grid and chunks: K5's rule and tile
    order (``cuda_batched.batched_plan``: every launch's grid co-resident, T
    steps a launch, the batch in the fewest chunks of rows) at the occupancy
    of batched_chain's c-storing instantiation on the card of ``device``,
    then, where no staged tile fits (n ≥ 1280 on the H100), the unstaged
    tiles. At B = 128, n = 512 it takes 32 x 32 tiles, 64 CTAs: faster there
    than 32 x 16's 128 CTAs (PERF.md §6)."""
    return cb.card_plan(device, B, n, False, cell=True)


def phase_x_side_bf16(x, W, b) -> torch.Tensor:
    """xz (T, B, 4n) = bf16(x)·bf16(W) + b over all T·B rows: gemm_bf16 NN
    on the copies of :func:`bf16_xw`, the bias added unrounded."""
    T, B, _ = x.shape
    G = W.shape[1]
    xb, Wb = bf16_xw(x, W)
    xz = torch.empty((T, B, G), dtype=torch.float32, device=x.device)
    _gemm_bf16(xz, T * B, G, "NN", [_seg_bf16(xb, Wb, xb.shape[1])], bias=b)
    return xz


def phase_chain_fwd_bf16(xz, Ut, h, c, plan: cb.BatchedPlan) -> None:
    """The bf16 forward chain (csrc batched_chain, c stored) from the
    float32 x-side xz (T, B, 4n) and Ut = bf16(U)ᵀ (4n, n; for an unstaged
    plan its ``cuda_batched.fragment_order`` copy): h and c (T, B, n)
    float32, one cooperative launch a chunk of the batch's rows; the steps
    exchange h through a two-slot bf16 copy (2, B, n)."""
    T, B, n = h.shape
    G = 4 * n
    hb = torch.empty((2, B, n), dtype=torch.bfloat16, device=h.device)
    for b0 in range(0, B, plan.chunk_rows):
        _launch("batched_lstm_recurrence", h.device, xz.data_ptr() + 4 * b0 * G, Ut.data_ptr(),
                h.data_ptr() + 4 * b0 * n, c.data_ptr() + 4 * b0 * n, hb.data_ptr() + 2 * b0 * n,
                T, min(plan.chunk_rows, B - b0), B, n, plan.rows, plan.units, 0, int(plan.staged))


def wide_fwd_bf16(x, W, U, b):
    """K9f's forward (W given: the x-side on gemm_bf16, then the chain) or
    K6f's (W and b None, x the projection xp: the chain alone) on checked
    card tensors: every product's operands bf16, its sums float32, h and c
    float32 and unrounded. Returns h, c (T, B, n)."""
    T, B, _ = x.shape
    n = U.shape[0]
    plan = fwd_plan_bf16(x.device, B, n)
    xz = x if W is None else phase_x_side_bf16(x, W, b)
    h = torch.empty((T, B, n), dtype=torch.float32, device=x.device)
    c = torch.empty_like(h)
    # rounded once, as K5's wrapper rounds it (the TPU's DEFAULT dot rounds U each step)
    Ut = U.t().to(torch.bfloat16).contiguous()
    phase_chain_fwd_bf16(xz, Ut if plan.staged else cb.fragment_order(Ut), h, c, plan)
    return h, c


# ---------------------------------------------------------------------------
# K9: one wide layer, train pair
# ---------------------------------------------------------------------------

def wide_layer_fwd(x, W, U, b, bf16: bool = False):
    """K9 (K9f with ``bf16``), one wide layer (n % 128 == 0): x (T, B, d)
    -> h, c (T, B, n)."""
    T, B, din, n = _check_wide(x, W, U, b)
    if not _card([x, W, U, b]):
        return wide_layer_fwd_plain(x, W, U, b, bf16)
    h, c = wide_fwd(x, W, U, b, bf16)
    _count("wide_layer_fwd", bf16)
    return h, c


def wide_layer_bwd(x, W, U, b, h, c, dh_seq, bf16: bool = False):
    """K9 (K9f), reverse-time backward of one wide layer. Returns (dx, dW,
    dU, db)."""
    T, B, din, n = _check_wide(x, W, U, b)
    for name, t in (("h", h), ("c", c), ("dh_seq", dh_seq)):
        _check(name, t, (T, B, n))
    if not _card([x, W, U, b, h, c, dh_seq]):
        return wide_layer_bwd_plain(x, W, U, b, h, c, dh_seq, bf16)
    grads = wide_bwd(x, W, U, b, h, c, dh_seq, bf16)
    _count("wide_layer_bwd", bf16)
    return grads


class WideLayerTrain(torch.autograd.Function):
    """Differentiable wide layer: (bf16, x (T, B, d), W, U, b) -> h (T, B,
    n), through K9 (K9f with ``bf16``)."""

    @staticmethod
    def forward(ctx, bf16, x, W, U, b):
        h, c = wide_layer_fwd(x, W, U, b, bf16)
        ctx.save_for_backward(x, W, U, b, h, c)
        ctx.bf16 = bf16
        return h

    @staticmethod
    def backward(ctx, dh):
        return (None, *wide_layer_bwd(*ctx.saved_tensors, dh.contiguous(), ctx.bf16))


def wide_layer_trainable(x, W, U, b, bf16: bool = False):
    """Differentiable fused LSTM layer, n % 128 == 0: x (T, B, d) time-major
    -> h_seq (T, B, n); gradients flow to all four inputs."""
    return WideLayerTrain.apply(bf16, x.contiguous(), W.contiguous(), U.contiguous(),
                                b.contiguous())


# ---------------------------------------------------------------------------
# K6: the recurrence-only train pair (K9's kernels without the x·W part)
# ---------------------------------------------------------------------------

def _check_recurrence(xp, U) -> Tuple[int, int, int]:
    T, B, _ = xp.shape
    n = U.shape[0]
    _check_T("recurrence train", T)
    _check("xp", xp, (T, B, 4 * n))
    _check("U", U, (n, 4 * n))
    if n % WIDE_ALIGN:
        raise ValueError(f"recurrence train: n % {WIDE_ALIGN} == 0 required, got n = {n}")
    return T, B, n


def lstm_recurrence_train_fwd(xp, U, bf16: bool = False):
    """K6 (K6f with ``bf16``), the recurrence from the hoisted projection
    (bias included), n % 128 == 0: xp (T, B, 4n), U (n, 4n) -> h, c (T, B,
    n)."""
    T, B, n = _check_recurrence(xp, U)
    if not _card([xp, U]):
        return lstm_recurrence_train_fwd_plain(xp, U, bf16)
    h, c = wide_fwd(xp, None, U, None, bf16)
    _count("lstm_recurrence_train_fwd", bf16)
    return h, c


def lstm_recurrence_train_bwd(xp, U, h, c, dh_seq, bf16: bool = False):
    """K6 (K6f), reverse-time backward of the recurrence. Returns (dxp,
    dU)."""
    T, B, n = _check_recurrence(xp, U)
    for name, t in (("h", h), ("c", c), ("dh_seq", dh_seq)):
        _check(name, t, (T, B, n))
    if not _card([xp, U, h, c, dh_seq]):
        return lstm_recurrence_train_bwd_plain(xp, U, h, c, dh_seq, bf16)
    grads = wide_bwd(xp, None, U, None, h, c, dh_seq, bf16)
    _count("lstm_recurrence_train_bwd", bf16)
    return grads


class RecurrenceTrain(torch.autograd.Function):
    """Differentiable recurrence: (bf16, xp (T, B, 4n), U) -> h (T, B, n),
    through K6 (K6f with ``bf16``). The forward saves h and c; the backward
    is the reverse-time kernel."""

    @staticmethod
    def forward(ctx, bf16, xp, U):
        h, c = lstm_recurrence_train_fwd(xp, U, bf16)
        ctx.save_for_backward(xp, U, h, c)
        ctx.bf16 = bf16
        return h

    @staticmethod
    def backward(ctx, dh):
        return (None, *lstm_recurrence_train_bwd(*ctx.saved_tensors, dh.contiguous(), ctx.bf16))


def lstm_recurrence_trainable(xp, U, bf16: bool = False):
    """Differentiable batched recurrence, n % 128 == 0: xp (T, B, 4n)
    time-major, bias included -> h_seq (T, B, n); gradients flow to xp and U."""
    return RecurrenceTrain.apply(bf16, xp.contiguous(), U.contiguous())


# ---------------------------------------------------------------------------
# the training dispatch
# ---------------------------------------------------------------------------

class LayerView(NamedTuple):
    """A layer's (W, U, b) as plain tensors, which may be the output of a
    differentiable reconstruction (the singular fine-tune)."""

    W: torch.Tensor
    U: torch.Tensor
    b: torch.Tensor

    @property
    def units(self) -> int:
        return self.U.shape[0]


class DenseView(NamedTuple):
    layers: Tuple[LayerView, ...]
    head: torch.nn.Module


def is_narrow(model, d_in: int) -> bool:
    """Eligibility for the whole-stack narrow kernels: every layer and the
    input at most 128 wide."""
    return all(l.units <= NARROW_MAX for l in model.layers) and d_in <= NARROW_MAX


def stacked_lstm_apply_fast_train(model, x_seq: torch.Tensor, return_sequences: bool = True,
                                  compact: bool | str = "auto", bf16: bool = False):
    """Drop-in training apply for ``fit`` that runs the recurrences through
    the train kernels, their bf16-operand variants with ``bf16`` (K7f, K8f,
    K9f, K6f). ``model`` is a ``StackedLSTM`` or a ``DenseView``. The
    products outside the kernels (the head, K6's x-side and the plain scan
    of the other layers) follow the training regime
    (``utils.precision.train_matmul_scope``).

    * **compact narrow stack** (``compact`` true, every layer n ≤ 64, input
      ≤ 128, and :func:`compact_fits`): one whole-stack kernel per direction
      with the weights staged in shared memory (K8,
      :func:`fused_narrow_train_apply_compact`). ``compact="auto"`` means
      B ≥ 128, the JAX dispatch's rule; the dense ``fit`` passes
      ``TrainConfig.compact_gates``, the singular and reduced views "auto".
    * **narrow stack** (every layer n ≤ 128, input ≤ 128): one whole-stack
      kernel per direction (K7, :func:`fused_narrow_train_apply`).
    * **uniform wide stack** (≥ 2 layers, all the same n, n % 128 == 0,
      input ≤ n): the fused layer kernel (K9) layer by layer; the first
      layer takes its input width as it is.
    * **exactly one aligned layer** (n % 128 == 0) otherwise: layer by
      layer, ``xp = h·W + b`` as a differentiable ``torch.matmul``, the
      recurrence-only pair (K6) on the aligned layer and the plain autograd
      scan on the others — the JAX package's rule (``n_aligned == 1``), kept
      as it is.
    * otherwise: the plain autograd scan.

    The TPU workarounds of the JAX dispatch (batch chunking past B = 512,
    the B % 8 condition, ``wide_fused``) are not carried over.
    x_seq (B, T, d) -> (B, T, out), or (B, out) for the last step.
    """
    units = [l.units for l in model.layers]
    B, _, d_in = x_seq.shape
    narrow = is_narrow(model, d_in)
    if compact == "auto":
        compact = B >= COMPACT_MIN_BATCH
    if compact and narrow and compact_eligible(model, d_in) and compact_fits(units, d_in):
        return fused_narrow_train_apply_compact(model, x_seq, return_sequences, bf16)
    if narrow:
        return fused_narrow_train_apply(model, x_seq, return_sequences, bf16)
    n0 = units[0]
    uniform = len(units) >= 2 and all(u == n0 for u in units) and n0 % WIDE_ALIGN == 0 and d_in <= n0
    n_aligned = sum(1 for u in units if u % WIDE_ALIGN == 0)
    if not uniform and n_aligned != 1:
        return stacked_lstm_apply(model, x_seq, return_sequences)
    h = x_seq.transpose(0, 1)  # (T, B, d)
    for l in model.layers:
        if uniform:
            h = wide_layer_trainable(h, l.W, l.U, l.b, bf16)
        elif l.units % WIDE_ALIGN == 0:
            h = lstm_recurrence_trainable(dot(h, l.W) + l.b, l.U, bf16)
        else:
            h = lstm_layer_apply(l, h.transpose(0, 1)).transpose(0, 1)
    if not return_sequences:
        return model.head(h[-1])
    return model.head(h).transpose(0, 1)
