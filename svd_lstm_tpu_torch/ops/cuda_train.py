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
lane layout, not carried over). Both forwards are one kernel: a group of
``narrow_fwd_lanes`` lanes owns each unit, the layers run as a wavefront
(T + L − 1 steps), and the weights are read gate-interleaved, staged in
shared memory (K8 always; K7 when the stack fits) or from K7's copy
:func:`pack_gates` in global memory. The backwards differ: K8's
keeps its own resident copy of the weights, K7's reads Wᵀ and Uᵀ from
global memory. K6 runs K9's step kernels with the x·W part taken out. All
compute in float32 (exact mode). The JAX kernels' ``precision=DEFAULT``
dots are exact float32 on the CPU, where the tests compare.

Layouts are time-major, as the TPU kernels take them: x (T, B, d), every
layer's h and c (T, B, n). The weights keep the Keras layout, unpadded: the
128-lane gate padding of the TPU kernels is not carried over, and K9 takes
the first layer's input width d as a parameter instead of zero-padding it
to n.

A wrapper checks shapes, contiguity and the kernel's limits, then routes on
the device of its tensors: CPU tensors take the plain version (float32 or
float64), CUDA tensors launch the kernel (float32 only) and raise if it
fails; there is no fallback from the card to the plain version. Each
wrapper counts its launches in ``<wrapper>.launches``. The kernels compute
in float32 on the CUDA cores, as the JAX package's kernels do on the CPU.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import gate_update, gate_update_bwd, stacked_lstm_apply
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT, _check_smem, _check_T, _launch, _on_card

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
NARROW_MAX = 128      # largest layer width and input width of K7
MAX_LAYERS = 8        # csrc MAX_LAYERS
NARROW_ROWS = 4       # csrc NARROW_ROWS: batch rows per CTA of K7 and K8
COMPACT_MAX_UNITS = 64  # K8's layers: the JAX package's ≥ 2 gates per 128-lane block
COMPACT_MIN_BATCH = 128  # compact="auto" takes K8 from this batch on, as the JAX dispatch
WIDE_ALIGN = 128      # K9 takes n % 128 == 0, as the TPU kernel did
FWD_MAX_THREADS = 1024  # csrc FWD_MAX_THREADS: the narrow forward's block
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


# ---------------------------------------------------------------------------
# plain versions (also the CPU path of every wrapper)
# ---------------------------------------------------------------------------

def lstm_recurrence_train_fwd_plain(xp, U):
    """The recurrence over time (the port of pallas_train.py:_fwd_scan_hc):
    h, c (T, B, n) from the hoisted projection xp (T, B, 4n)."""
    T, B, _ = xp.shape
    n = U.shape[0]
    h = torch.zeros((B, n), dtype=xp.dtype, device=xp.device)
    c = torch.zeros_like(h)
    hs, cs = [], []
    for t in range(T):
        h, c = gate_update(xp[t] + torch.matmul(h, U), c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_recurrence_train_bwd_plain(xp, U, h, c, dh_seq):
    """Reverse-time backward of the recurrence through gate_update_bwd (the
    port of pallas_train.py:_trainable_bwd). Returns (dxp, dU)."""
    T, B, _ = xp.shape
    n = U.shape[0]
    zeros = torch.zeros((B, n), dtype=xp.dtype, device=xp.device)
    h_prev = torch.cat([zeros[None], h[:-1]])
    c_prev = torch.cat([zeros[None], c[:-1]])
    Ut = U.t()
    dh_c, dc = zeros, zeros
    dzs = [None] * T
    for t in range(T - 1, -1, -1):
        z = xp[t] + torch.matmul(h_prev[t], U)  # gate recompute (remat)
        dz, dc = gate_update_bwd(z, c_prev[t], c[t], dh_seq[t] + dh_c, dc)
        dh_c = torch.matmul(dz, Ut)
        dzs[t] = dz
    dz = torch.stack(dzs)
    return dz, torch.einsum("tbn,tbg->ng", h_prev, dz)


def _layer_fwd_plain(x, W, U, b):
    """One layer over time: h, c (T, B, n) from x (T, B, d)."""
    return lstm_recurrence_train_fwd_plain(torch.matmul(x, W) + b, U)


def _layer_bwd_plain(x, W, U, b, h, c, dh_seq):
    """Reverse-time backward of one layer. Returns (dx, dW, dU, db)."""
    dz, dU = lstm_recurrence_train_bwd_plain(torch.matmul(x, W) + b, U, h, c, dh_seq)
    dW = torch.einsum("tbd,tbg->dg", x, dz)
    return torch.matmul(dz, W.t()), dW, dU, dz.sum(dim=(0, 1))


def fused_narrow_train_fwd_plain(layers: Sequence[Layer], x: torch.Tensor):
    """x (T, B, d) -> (hs, cs): every layer's h and c, (T, B, n_l) each."""
    hs, cs, inp = [], [], x
    for W, U, b in layers:
        h, c = _layer_fwd_plain(inp, W, U, b)
        hs.append(h)
        cs.append(c)
        inp = h
    return hs, cs


def fused_narrow_train_bwd_plain(layers: Sequence[Layer], x, hs, cs, dh_last):
    """Top-down, layer by layer, each layer in reverse time. dh_last (T, B,
    n_last) is the cotangent on the last layer's h. Returns
    (dWs, dUs, dbs, dx), the lists in layer order."""
    L = len(layers)
    dWs, dUs, dbs = [None] * L, [None] * L, [None] * L
    dh = dh_last
    for i in range(L - 1, -1, -1):
        W, U, b = layers[i]
        inp = x if i == 0 else hs[i - 1]
        dh, dWs[i], dUs[i], dbs[i] = _layer_bwd_plain(inp, W, U, b, hs[i], cs[i], dh)
    return dWs, dUs, dbs, dh


def wide_layer_fwd_plain(x, W, U, b):
    """x (T, B, d) -> h, c (T, B, n)."""
    return _layer_fwd_plain(x, W, U, b)


def wide_layer_bwd_plain(x, W, U, b, h, c, dh_seq):
    """Returns (dx, dW, dU, db)."""
    return _layer_bwd_plain(x, W, U, b, h, c, dh_seq)


# ---------------------------------------------------------------------------
# weight gradients on the card (shared by both backward kernels)
# ---------------------------------------------------------------------------

def _splits(M: int, p: int, G: int) -> int:
    """How many contiguous ranges of M the weight-gradient sum is split
    into: enough CTAs for about two waves, each range ≥ 256 rows."""
    tiles = math.ceil(G / 64) * math.ceil(p / 64)
    return max(1, min(math.ceil(M / 256), math.ceil(2 * _SM_COUNT / tiles)))


def _weight_grad(A: torch.Tensor | None, shift: int, dz: torch.Tensor) -> torch.Tensor:
    """Σ_m a_m ⊗ dz_m over the rows of dz (M, G): a_m = A[m - shift] (zero
    for m < shift), or 1 when A is None (then the result is (G,))."""
    M, G = dz.shape
    p = 1 if A is None else A.shape[1]
    S = _splits(M, p, G)
    out = torch.empty((p, G), dtype=torch.float32, device=dz.device)
    partial = torch.empty((S, p, G), dtype=torch.float32, device=dz.device) if S > 1 else None
    _launch("weight_grad", dz.device, _ptr(A), shift, dz.data_ptr(), out.data_ptr(),
            _ptr(partial), M, p, G, S)
    return out[0] if A is None else out


def _layer_weight_grads(inp, h, dz):
    """dW = Σ inpᵀ·dz, dU = Σ h_prevᵀ·dz, db = Σ dz for one layer."""
    T, B, G = dz.shape
    dz2 = dz.view(T * B, G)
    return (
        _weight_grad(inp.view(T * B, -1), 0, dz2),
        _weight_grad(h.view(T * B, -1), B, dz2),
        _weight_grad(None, 0, dz2),
    )


# ---------------------------------------------------------------------------
# K7 and K8: the narrow whole-stack train pairs (one function, two kernels)
# ---------------------------------------------------------------------------

def _resident_floats(units: Sequence[int], d: int) -> int:
    """Floats of K8's resident weights (csrc ``resident_floats``): per layer
    W (din, 4n) and U (n, 4n) at row stride 4n + 1, and b (4n)."""
    total, din = 0, d
    for n in units:
        total += (din + n) * (4 * n + 1) + 4 * n
        din = n
    return total


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def _narrow_state_floats(units: Sequence[int], d: int, backward: bool) -> int:
    """Floats of shared memory a K7 or K8 CTA holds for its state (csrc
    launchers): the backward's carries and scratch, or the forward's two
    parities of the state vector [x_t | h_0 | ... | h_{L-1}], four rows an
    entry."""
    nmax = max(units)
    if backward:
        return NARROW_ROWS * (2 * sum(units) + 14 * nmax + max(d, nmax))
    return 2 * NARROW_ROWS * (d + sum(units))


def narrow_fwd_threads(units: Sequence[int], d: int, lanes: int) -> int:
    """Threads of the forward's block (csrc ``fwd_threads``): ``lanes`` a
    unit, and at least one for each of x_t's NARROW_ROWS·d entries."""
    return max(_round_up(lanes * sum(units), 32), _round_up(NARROW_ROWS * d, 32))


def narrow_fwd_smem_bytes(units: Sequence[int], d: int, staged: bool) -> int:
    """Shared memory of the forward (csrc ``narrow_fwd_launch``): with
    ``staged`` every layer's [W; U] rows, four gates each, then the
    state."""
    weights, din = 0, d
    for n in units:
        weights += (din + n) * 4 * n
        din = n
    return 4 * ((weights if staged else 0) + _narrow_state_floats(units, d, False))


def narrow_fwd_lanes(units: Sequence[int], d: int) -> int:
    """Lanes S a unit of the forward: the largest of 8, 4, 2, 1 whose block
    has at most FWD_MAX_THREADS threads. The wrapper passes it to the
    launcher, which checks it."""
    for lanes in (8, 4, 2):
        if narrow_fwd_threads(units, d, lanes) <= FWD_MAX_THREADS:
            return lanes
    return 1


def pack_gates(W: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """K7's gate-interleaved copy of a layer for its forward: P (din + n, n,
    4) with P[k, j, g] = [W; U][k, g·n + j] (csrc ``FwdLayer.P``)."""
    din, n = W.shape[0], U.shape[0]
    return torch.cat([W.view(din, 4, n), U.view(n, 4, n)]).transpose(1, 2).contiguous()


def compact_smem_bytes(units: Sequence[int], d: int) -> int:
    """Shared memory of K8's larger kernel, the backward: the resident
    weights and K7's backward state (193 184 + 14 720 B at 4×40, d = 16)."""
    return 4 * (_resident_floats(units, d) + _narrow_state_floats(units, d, backward=True))


def compact_fits(units: Sequence[int], d: int) -> bool:
    """K8's shape rule: the stack's weights and a CTA's state fit in the
    shared memory one H100 block may use. A compact-eligible stack that does
    not fit (e.g. 4×64, or 8 layers of 64 with d = 128) trains through K7."""
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
            f"{name}: the resident weights need {compact_smem_bytes(units, d)} B of shared "
            f"memory, over {_SMEM_LIMIT}; such a stack trains through K7"
        )


def _narrow_fwd(wrapper, plain, layers: Sequence[Layer], x: torch.Tensor):
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
        return plain(layers, x)
    # K8 always stages its weights: a stack compact_fits admits fits staged
    # (tests/test_torch_narrow_fwd.py)
    staged = resident or narrow_fwd_smem_bytes(units, d, True) <= _SMEM_LIMIT
    hs, cs = _launch_narrow_fwd(name, layers, x, narrow_fwd_lanes(units, d), staged)
    wrapper.launches += 1
    return hs, cs


def _launch_narrow_fwd(name: str, layers: Sequence[Layer], x: torch.Tensor, lanes: int,
                       staged: bool):
    """One launch of the narrow forward ``name`` (K7's or K8's launcher) on
    checked card tensors, at ``lanes`` a unit, the weights staged in shared
    memory or read from :func:`pack_gates`' copy."""
    T, B, d = x.shape
    units = [U.shape[0] for _, U, _ in layers]
    if lanes not in (1, 2, 4, 8) or narrow_fwd_threads(units, d, lanes) > FWD_MAX_THREADS:
        raise ValueError(f"{name}: {lanes} lanes a unit do not fit a block of {FWD_MAX_THREADS} threads")
    _check_smem(name, narrow_fwd_smem_bytes(units, d, staged) // 4)
    hs = [torch.empty((T, B, n), dtype=torch.float32, device=x.device) for n in units]
    cs = [torch.empty_like(h) for h in hs]
    packed = [None if staged else pack_gates(W, U) for W, U, _ in layers]
    meta = np.array(
        [[W.shape[0], U.shape[0], W.data_ptr(), U.data_ptr(), b.data_ptr(), h.data_ptr(),
          c.data_ptr(), _ptr(P) or 0] for (W, U, b), h, c, P in zip(layers, hs, cs, packed)],
        dtype=np.int64,
    )
    _launch(name, x.device, meta.ctypes.data, len(layers), x.data_ptr(), T, B, d, lanes)
    return hs, cs


def _narrow_bwd(wrapper, plain, layers: Sequence[Layer], x, hs, cs, dh_last):
    """The checks and the launches of K7's or K8's backward (the reverse-time
    kernel, then ``weight_grad`` per layer); ``plain`` runs CPU tensors."""
    name = wrapper.__name__
    resident = wrapper is fused_narrow_train_compact_bwd
    T, B, d = x.shape
    _check_T(name, T)
    _check("x", x, (T, B, d))
    units = _check_layers(layers, d)
    if resident:
        _check_compact(name, units, d)
    if len(hs) != len(layers) or len(cs) != len(layers):
        raise ValueError(f"{name}: one h and one c per layer")
    for i, n in enumerate(units):
        _check(f"hs[{i}]", hs[i], (T, B, n))
        _check(f"cs[{i}]", cs[i], (T, B, n))
    _check("dh_last", dh_last, (T, B, units[-1]))
    if not _card([x, dh_last, *hs, *cs, *(w for l in layers for w in l)]):
        return plain(layers, x, hs, cs, dh_last)
    _check_smem(name, (_resident_floats(units, d) if resident else 0)
                + _narrow_state_floats(units, d, backward=True))
    dev = x.device
    dx = torch.empty((T, B, d), dtype=torch.float32, device=dev)
    dzs = [torch.empty((T, B, 4 * n), dtype=torch.float32, device=dev) for n in units]
    # K7 reads Wᵀ and Uᵀ by row from global memory; K8 reads its resident W and U
    Wts = [None if resident else W.t().contiguous() for W, _, _ in layers]
    Uts = [None if resident else U.t().contiguous() for _, U, _ in layers]
    meta = np.array(
        [[W.shape[0], U.shape[0], W.data_ptr(), U.data_ptr(), b.data_ptr(), _ptr(Wt) or 0,
          _ptr(Ut) or 0, h.data_ptr(), c.data_ptr(), dz.data_ptr()]
         for (W, U, b), Wt, Ut, h, c, dz in zip(layers, Wts, Uts, hs, cs, dzs)],
        dtype=np.int64,
    )
    _launch(name, dev, meta.ctypes.data, len(layers), x.data_ptr(), dh_last.data_ptr(),
            dx.data_ptr(), T, B, d)
    grads = [_layer_weight_grads(x if i == 0 else hs[i - 1], hs[i], dzs[i])
             for i in range(len(layers))]
    wrapper.launches += 1
    dWs, dUs, dbs = (list(g) for g in zip(*grads))
    return dWs, dUs, dbs, dx


def fused_narrow_train_fwd(layers: Sequence[Layer], x: torch.Tensor):
    """K7, whole-stack forward for narrow stacks (every layer n ≤ 128,
    d ≤ 128, at most 8 layers). x (T, B, d) -> (hs, cs), (T, B, n_l) per
    layer."""
    return _narrow_fwd(fused_narrow_train_fwd, fused_narrow_train_fwd_plain, layers, x)


def fused_narrow_train_bwd(layers: Sequence[Layer], x, hs, cs, dh_last):
    """K7, whole-stack reverse-time backward. dh_last (T, B, n_last) is the
    cotangent on the last layer's h. Returns (dWs, dUs, dbs, dx)."""
    return _narrow_bwd(fused_narrow_train_bwd, fused_narrow_train_bwd_plain, layers, x, hs, cs,
                       dh_last)


def fused_narrow_train_compact_fwd_plain(layers: Sequence[Layer], x: torch.Tensor):
    """K8's function is K7's: its plain version is K7's."""
    return fused_narrow_train_fwd_plain(layers, x)


def fused_narrow_train_compact_bwd_plain(layers: Sequence[Layer], x, hs, cs, dh_last):
    """K8's function is K7's: its plain version is K7's."""
    return fused_narrow_train_bwd_plain(layers, x, hs, cs, dh_last)


def fused_narrow_train_compact_fwd(layers: Sequence[Layer], x: torch.Tensor):
    """K8, the whole-stack forward with the weights resident in shared
    memory, for compact-eligible stacks (every layer n ≤ 64, d ≤ 128) that
    fit (:func:`compact_fits`). x (T, B, d) -> (hs, cs)."""
    return _narrow_fwd(fused_narrow_train_compact_fwd, fused_narrow_train_compact_fwd_plain,
                       layers, x)


def fused_narrow_train_compact_bwd(layers: Sequence[Layer], x, hs, cs, dh_last):
    """K8, the whole-stack reverse-time backward. Returns (dWs, dUs, dbs,
    dx)."""
    return _narrow_bwd(fused_narrow_train_compact_bwd, fused_narrow_train_compact_bwd_plain,
                       layers, x, hs, cs, dh_last)


fused_narrow_train_fwd.launches = 0
fused_narrow_train_bwd.launches = 0
fused_narrow_train_compact_fwd.launches = 0
fused_narrow_train_compact_bwd.launches = 0


def _stack_forward(ctx, fwd, x, weights):
    layers = [tuple(weights[i : i + 3]) for i in range(0, len(weights), 3)]
    hs, cs = fwd(layers, x)
    ctx.save_for_backward(x, *weights, *hs, *cs)
    ctx.num_layers = len(layers)
    return hs[-1]


def _stack_backward(ctx, bwd, dh_last):
    L = ctx.num_layers
    saved = ctx.saved_tensors
    x, weights = saved[0], saved[1 : 1 + 3 * L]
    hs, cs = list(saved[1 + 3 * L : 1 + 4 * L]), list(saved[1 + 4 * L :])
    layers = [tuple(weights[i : i + 3]) for i in range(0, 3 * L, 3)]
    dWs, dUs, dbs, dx = bwd(layers, x, hs, cs, dh_last.contiguous())
    return (dx, *(g for tri in zip(dWs, dUs, dbs) for g in tri))


class FusedNarrowTrain(torch.autograd.Function):
    """Differentiable whole-stack recurrence through K7: (x (T, B, d), W0,
    U0, b0, W1, ...) -> the last layer's h (T, B, n_last). The forward saves
    every layer's h and c; the backward is the reverse-time kernel."""

    @staticmethod
    def forward(ctx, x, *weights):
        return _stack_forward(ctx, fused_narrow_train_fwd, x, weights)

    @staticmethod
    def backward(ctx, dh_last):
        return _stack_backward(ctx, fused_narrow_train_bwd, dh_last)


class FusedNarrowTrainCompact(torch.autograd.Function):
    """:class:`FusedNarrowTrain` through K8 (the same function, the weights
    resident in shared memory)."""

    @staticmethod
    def forward(ctx, x, *weights):
        return _stack_forward(ctx, fused_narrow_train_compact_fwd, x, weights)

    @staticmethod
    def backward(ctx, dh_last):
        return _stack_backward(ctx, fused_narrow_train_compact_bwd, dh_last)


def _stack_apply(fn, model, x_seq: torch.Tensor, return_sequences: bool):
    x = x_seq.transpose(0, 1).contiguous()  # (T, B, d)
    weights = [w.contiguous() for l in model.layers for w in (l.W, l.U, l.b)]
    h = fn.apply(x, *weights)  # (T, B, n)
    if not return_sequences:
        return model.head(h[-1])
    return model.head(h).transpose(0, 1)


def fused_narrow_train_apply(model, x_seq: torch.Tensor, return_sequences: bool = True):
    """Whole-stack trainable forward for narrow models through K7. ``model``
    has ``layers`` (each with W, U, b) and a ``head``. x_seq (B, T, d) ->
    (B, T, out), or (B, out) for the last step."""
    return _stack_apply(FusedNarrowTrain, model, x_seq, return_sequences)


def fused_narrow_train_apply_compact(model, x_seq: torch.Tensor, return_sequences: bool = True):
    """:func:`fused_narrow_train_apply` through K8, for compact-eligible
    stacks that fit (:func:`compact_eligible`, :func:`compact_fits`)."""
    return _stack_apply(FusedNarrowTrainCompact, model, x_seq, return_sequences)


# ---------------------------------------------------------------------------
# K9: one wide layer, train pair
# ---------------------------------------------------------------------------

def wide_layer_fwd(x, W, U, b):
    """One wide layer (n % 128 == 0): x (T, B, d) -> h, c (T, B, n)."""
    T, B, din, n = _check_wide(x, W, U, b)
    if not _card([x, W, U, b]):
        return wide_layer_fwd_plain(x, W, U, b)
    h = torch.empty((T, B, n), dtype=torch.float32, device=x.device)
    c = torch.empty_like(h)
    _launch("wide_layer_fwd", x.device, x.data_ptr(), W.data_ptr(), U.data_ptr(), b.data_ptr(),
            h.data_ptr(), c.data_ptr(), T, B, din, n)
    wide_layer_fwd.launches += 1
    return h, c


wide_layer_fwd.launches = 0


def wide_layer_bwd(x, W, U, b, h, c, dh_seq):
    """Reverse-time backward of one wide layer. Returns (dx, dW, dU, db)."""
    T, B, din, n = _check_wide(x, W, U, b)
    for name, t in (("h", h), ("c", c), ("dh_seq", dh_seq)):
        _check(name, t, (T, B, n))
    if not _card([x, W, U, b, h, c, dh_seq]):
        return wide_layer_bwd_plain(x, W, U, b, h, c, dh_seq)
    dev = x.device
    dx = torch.empty((T, B, din), dtype=torch.float32, device=dev)
    dz = torch.empty((T, B, 4 * n), dtype=torch.float32, device=dev)
    dhc = torch.zeros((B, n), dtype=torch.float32, device=dev)
    dcc = torch.zeros((B, n), dtype=torch.float32, device=dev)
    _launch("wide_layer_bwd", dev, x.data_ptr(), W.data_ptr(), U.data_ptr(), b.data_ptr(),
            h.data_ptr(), c.data_ptr(), dh_seq.data_ptr(), dx.data_ptr(), dz.data_ptr(),
            dhc.data_ptr(), dcc.data_ptr(), T, B, din, n)
    dW, dU, db = _layer_weight_grads(x, h, dz)
    wide_layer_bwd.launches += 1
    return dx, dW, dU, db


wide_layer_bwd.launches = 0


class WideLayerTrain(torch.autograd.Function):
    """Differentiable wide layer: (x (T, B, d), W, U, b) -> h (T, B, n)."""

    @staticmethod
    def forward(ctx, x, W, U, b):
        h, c = wide_layer_fwd(x, W, U, b)
        ctx.save_for_backward(x, W, U, b, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        return wide_layer_bwd(*ctx.saved_tensors, dh.contiguous())


def wide_layer_trainable(x, W, U, b):
    """Differentiable fused LSTM layer, n % 128 == 0: x (T, B, d) time-major
    -> h_seq (T, B, n); gradients flow to all four inputs."""
    return WideLayerTrain.apply(x.contiguous(), W.contiguous(), U.contiguous(), b.contiguous())


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


def lstm_recurrence_train_fwd(xp, U):
    """Recurrence from the hoisted projection (bias included), n % 128 ==
    0: xp (T, B, 4n), U (n, 4n) -> h, c (T, B, n)."""
    T, B, n = _check_recurrence(xp, U)
    if not _card([xp, U]):
        return lstm_recurrence_train_fwd_plain(xp, U)
    h = torch.empty((T, B, n), dtype=torch.float32, device=xp.device)
    c = torch.empty_like(h)
    # K9's launcher with no W and no b: xp in x's place, din = 0
    _launch("wide_layer_fwd", xp.device, xp.data_ptr(), None, U.data_ptr(), None, h.data_ptr(),
            c.data_ptr(), T, B, 0, n)
    lstm_recurrence_train_fwd.launches += 1
    return h, c


lstm_recurrence_train_fwd.launches = 0


def lstm_recurrence_train_bwd(xp, U, h, c, dh_seq):
    """Reverse-time backward of the recurrence. Returns (dxp, dU)."""
    T, B, n = _check_recurrence(xp, U)
    for name, t in (("h", h), ("c", c), ("dh_seq", dh_seq)):
        _check(name, t, (T, B, n))
    if not _card([xp, U, h, c, dh_seq]):
        return lstm_recurrence_train_bwd_plain(xp, U, h, c, dh_seq)
    dev = xp.device
    dxp = torch.empty((T, B, 4 * n), dtype=torch.float32, device=dev)
    dhc = torch.zeros((B, n), dtype=torch.float32, device=dev)
    dcc = torch.zeros((B, n), dtype=torch.float32, device=dev)
    # K9's launcher with no W, no b and no dx: its dz store is dxp
    _launch("wide_layer_bwd", dev, xp.data_ptr(), None, U.data_ptr(), None, h.data_ptr(),
            c.data_ptr(), dh_seq.data_ptr(), None, dxp.data_ptr(), dhc.data_ptr(), dcc.data_ptr(),
            T, B, 0, n)
    dU = _weight_grad(h.view(T * B, n), B, dxp.view(T * B, 4 * n))
    lstm_recurrence_train_bwd.launches += 1
    return dxp, dU


lstm_recurrence_train_bwd.launches = 0

KERNELS = (fused_narrow_train_fwd, fused_narrow_train_bwd, fused_narrow_train_compact_fwd,
           fused_narrow_train_compact_bwd, wide_layer_fwd, wide_layer_bwd,
           lstm_recurrence_train_fwd, lstm_recurrence_train_bwd)


class RecurrenceTrain(torch.autograd.Function):
    """Differentiable recurrence: (xp (T, B, 4n), U) -> h (T, B, n). The
    forward saves h and c; the backward is the reverse-time kernel."""

    @staticmethod
    def forward(ctx, xp, U):
        h, c = lstm_recurrence_train_fwd(xp, U)
        ctx.save_for_backward(xp, U, h, c)
        return h

    @staticmethod
    def backward(ctx, dh):
        return lstm_recurrence_train_bwd(*ctx.saved_tensors, dh.contiguous())


def lstm_recurrence_trainable(xp, U):
    """Differentiable batched recurrence, n % 128 == 0: xp (T, B, 4n)
    time-major, bias included -> h_seq (T, B, n); gradients flow to xp and U."""
    return RecurrenceTrain.apply(xp.contiguous(), U.contiguous())


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
                                  compact: bool | str = "auto"):
    """Drop-in training apply for ``fit`` that runs the recurrences through
    the train kernels. ``model`` is a ``StackedLSTM`` or a ``DenseView``.

    * **compact narrow stack** (``compact`` true, every layer n ≤ 64, input
      ≤ 128, and :func:`compact_fits`): one whole-stack kernel per direction
      with the weights resident in shared memory (K8,
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
        return fused_narrow_train_apply_compact(model, x_seq, return_sequences)
    if narrow:
        return fused_narrow_train_apply(model, x_seq, return_sequences)
    n0 = units[0]
    uniform = len(units) >= 2 and all(u == n0 for u in units) and n0 % WIDE_ALIGN == 0 and d_in <= n0
    n_aligned = sum(1 for u in units if u % WIDE_ALIGN == 0)
    if not uniform and n_aligned != 1:
        return stacked_lstm_apply(model, x_seq, return_sequences)
    h = x_seq.transpose(0, 1)  # (T, B, d)
    for l in model.layers:
        if uniform:
            h = wide_layer_trainable(h, l.W, l.U, l.b)
        elif l.units % WIDE_ALIGN == 0:
            h = lstm_recurrence_trainable(torch.matmul(h, l.W) + l.b, l.U)
        else:
            h = lstm_recurrence_train_fwd_plain(torch.matmul(h, l.W) + l.b, l.U)[0]
    if not return_sequences:
        return model.head(h[-1])
    return model.head(h).transpose(0, 1)
