"""Batch-1 LSTM recurrence kernels: CUDA wrappers and their plain versions.

Counterpart of ``svd_lstm_tpu/ops/pallas_lstm.py``. Each TPU kernel on the
batch-1 inference path has a hand-written CUDA kernel in
``csrc/lstm_recurrence.cu`` (design notes there) and a plain PyTorch version
beside its wrapper here:

==================== ============================== =========================
wrapper              plain version                  replaces (pallas_lstm.py)
==================== ============================== =========================
fused_dense_stack    fused_dense_stack_plain        fused_dense_stack_pallas
reduced_recurrence   reduced_recurrence_plain       reduced_recurrence_pallas
lstm_recurrence      lstm_recurrence_plain          lstm_recurrence_pallas
==================== ============================== =========================

A wrapper checks dtype (float32), shapes and contiguity, then routes on the
device of its tensors: CPU tensors take the plain version, CUDA tensors
launch the kernel (and raise if it fails), any other device raises. There
is no fallback from the card to the plain version. Each wrapper counts its
kernel launches in ``<wrapper>.launches``.

The kernels are inference-only (no autograd), so the wrappers run under
``torch.no_grad()``. The x-side projections and the head stay
``torch.matmul``, as XLA computed them outside the Pallas kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import StackedLSTM, gate_update, scan_recurrence
from svd_lstm_tpu_torch.models.reduced import (
    ReducedLSTM,
    apply_split_projection,
    pack_split_projection,
    reduced_projection,
)
from svd_lstm_tpu_torch.ops import _build
from svd_lstm_tpu_torch.utils.linalg import fold_IC

SOURCE = "svd_lstm_tpu_torch/ops/csrc/lstm_recurrence.cu"
# the TPU kernel each wrapper replaces, as file:line of its definition
REPLACES = {
    "fused_dense_stack": "svd_lstm_tpu/ops/pallas_lstm.py:369",
    "reduced_recurrence": "svd_lstm_tpu/ops/pallas_lstm.py:255",
    "lstm_recurrence": "svd_lstm_tpu/ops/pallas_lstm.py:195",
}
MAX_LAYERS = 8  # csrc MAX_LAYERS
_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block can use


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


def _check_T(name: str, T: int) -> None:
    if T < 1:
        raise ValueError(f"{name}: empty sequence")


# ---------------------------------------------------------------------------
# K3: dense h-side recurrence
# ---------------------------------------------------------------------------

@torch.no_grad()
def lstm_recurrence_plain(xp, U, h0=None, c0=None) -> torch.Tensor:
    """z_t = xp_t + h·U, gate update. xp (T, 4n) -> h_seq (T, n)."""
    n = U.shape[0]
    h0 = None if h0 is None else h0.reshape(1, n)
    c0 = None if c0 is None else c0.reshape(1, n)
    return scan_recurrence(xp[None], lambda h: torch.matmul(h, U), h0, c0)[0][0]


@torch.no_grad()
def lstm_recurrence(xp, U, h0=None, c0=None) -> torch.Tensor:
    """Dense h-side recurrence from the hoisted input projection (bias
    included). xp (T, 4n), U (n, 4n), optional h0/c0 (n,) -> (T, n)."""
    T, n = xp.shape[0], U.shape[0]
    _check_T("lstm_recurrence", T)
    _check("xp", xp, (T, 4 * n))
    _check("U", U, (n, 4 * n))
    h0, c0 = _state("h0", h0, n), _state("c0", c0, n)
    if not _on_card(xp, U, *(s for s in (h0, c0) if s is not None)):
        return lstm_recurrence_plain(xp, U, h0, c0)
    _check_smem("lstm_recurrence", 6 * n)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)
    _launch(
        "lstm_recurrence", xp.device,
        xp.data_ptr(), U.data_ptr(), _ptr(h0), _ptr(c0), out.data_ptr(), T, n,
    )
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0


# ---------------------------------------------------------------------------
# K2: low-rank h-side recurrence
# ---------------------------------------------------------------------------

def _is_split(uB) -> bool:
    return not isinstance(uB, torch.Tensor)


@torch.no_grad()
def reduced_recurrence_plain(xp, uB, uC, h0=None, c0=None) -> torch.Tensor:
    """z_t = xp_t + (h·B)·[I|C], merged (uB (n, r), uC (r, 4n−r)) or split
    (4 per-gate pairs uB[g] (n, r_g), uC[g] (r_g, n−r_g)). -> (T, n)."""
    n = xp.shape[1] // 4
    if _is_split(uB):
        Bp, ICp = pack_split_projection(uB, uC)
        rec = lambda h: apply_split_projection(h, Bp, ICp)
    else:
        IC = fold_IC(uB, uC)
        rec = lambda h: torch.matmul(torch.matmul(h, uB), IC)
    h0 = None if h0 is None else h0.reshape(1, n)
    c0 = None if c0 is None else c0.reshape(1, n)
    return scan_recurrence(xp[None], rec, h0, c0)[0][0]


def _pack_reduced(uB, uC, n: int):
    """(Bt (R, n), IC (R, 4n)) for the kernel. Split: all gates' B side by
    side, transposed, and a block-diagonal IC with fold_IC(B_g, C_g) in gate
    g's rows and columns (the zero blocks add exact zeros)."""
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


@torch.no_grad()
def reduced_recurrence(xp, uB, uC, h0=None, c0=None) -> torch.Tensor:
    """Low-rank h-side recurrence in the folded form (h·B)·[I|C].
    xp (T, 4n); merged uB (n, r), uC (r, 4n−r); split: 4 each of
    uB[g] (n, r_g), uC[g] (r_g, n−r_g). Optional h0/c0 (n,). -> (T, n)."""
    T, g4 = xp.shape
    n = g4 // 4
    _check_T("reduced_recurrence", T)
    _check("xp", xp, (T, 4 * n))
    if _is_split(uB):
        if len(uB) != 4 or len(uC) != 4:
            raise ValueError("split factors: expected 4 per-gate uB and uC")
        for g, (B, C) in enumerate(zip(uB, uC)):
            r = B.shape[1]
            _check(f"uB[{g}]", B, (n, r))
            _check(f"uC[{g}]", C, (r, n - r))
        factors = [*uB, *uC]
    else:
        r = uB.shape[1]
        _check("uB", uB, (n, r))
        _check("uC", uC, (r, 4 * n - r))
        factors = [uB, uC]
    h0, c0 = _state("h0", h0, n), _state("c0", c0, n)
    if not _on_card(xp, *factors, *(s for s in (h0, c0) if s is not None)):
        return reduced_recurrence_plain(xp, uB, uC, h0, c0)
    Bt, IC = _pack_reduced(uB, uC, n)
    R = Bt.shape[0]
    _check_smem("reduced_recurrence", 6 * n + R)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)
    _launch(
        "reduced_recurrence", xp.device,
        xp.data_ptr(), Bt.data_ptr(), IC.data_ptr(), _ptr(h0), _ptr(c0),
        out.data_ptr(), T, n, R,
    )
    reduced_recurrence.launches += 1
    return out


reduced_recurrence.launches = 0


# ---------------------------------------------------------------------------
# K1: whole dense stack, one kernel
# ---------------------------------------------------------------------------

@torch.no_grad()
def fused_dense_stack_plain(model: StackedLSTM, x: torch.Tensor) -> torch.Tensor:
    """Time-outer, layer-inner loop, as the kernel runs it: per step, per
    layer z = x_t·W + h·U + b and the gate update. x (T, d) -> (T, out)."""
    T = x.shape[0]
    hs = [torch.zeros((1, l.units), dtype=x.dtype, device=x.device) for l in model.layers]
    cs = [torch.zeros_like(h) for h in hs]
    h_seq = torch.empty((T, model.layers[-1].units), dtype=x.dtype, device=x.device)
    for t in range(T):
        inp = x[t : t + 1]
        for i, l in enumerate(model.layers):
            z = torch.matmul(inp, l.W) + torch.matmul(hs[i], l.U) + l.b
            hs[i], cs[i] = gate_update(z, cs[i])
            inp = hs[i]
        h_seq[t] = inp[0]
    return model.head(h_seq)


@torch.no_grad()
def fused_dense_stack(model: StackedLSTM, x: torch.Tensor) -> torch.Tensor:
    """Whole dense stack in one kernel; the head is applied to the last
    layer's hidden sequence outside it. x (T, d) -> (T, out)."""
    T, d = x.shape
    _check_T("fused_dense_stack", T)
    _check("x", x, (T, model.layers[0].input_dim))
    L = len(model.layers)
    if L > MAX_LAYERS:
        raise ValueError(f"fused_dense_stack: at most {MAX_LAYERS} layers, got {L}")
    din = d
    for i, l in enumerate(model.layers):
        n = l.units
        _check(f"layers[{i}].W", l.W, (din, 4 * n))
        _check(f"layers[{i}].U", l.U, (n, 4 * n))
        _check(f"layers[{i}].b", l.b, (4 * n,))
        din = n
    weights = [p for l in model.layers for p in (l.W, l.U, l.b)]
    if not _on_card(x, *weights):
        return fused_dense_stack_plain(model, x)
    units = [l.units for l in model.layers]
    _check_smem("fused_dense_stack", 2 * sum(units) + 4 * max(units) + d)
    meta = np.array(
        [[l.input_dim, l.units, l.W.data_ptr(), l.U.data_ptr(), l.b.data_ptr()]
         for l in model.layers],
        dtype=np.int64,
    )
    h = torch.empty((T, units[-1]), dtype=torch.float32, device=x.device)
    _launch(
        "fused_dense_stack", x.device,
        meta.ctypes.data, L, x.data_ptr(), h.data_ptr(), T, d,
    )
    fused_dense_stack.launches += 1
    return model.head(h)


fused_dense_stack.launches = 0

KERNELS = (fused_dense_stack, reduced_recurrence, lstm_recurrence)


# ---------------------------------------------------------------------------
# hybrid paths: torch.matmul x-side projections + recurrence kernels
# ---------------------------------------------------------------------------

@torch.no_grad()
def dense_forward_hybrid(model: StackedLSTM, x: torch.Tensor) -> torch.Tensor:
    """Per layer: one matmul for the input projection, the recurrence
    kernel for the time loop. x (T, d) -> (T, out)."""
    h = x
    for l in model.layers:
        h = lstm_recurrence(torch.matmul(h, l.W) + l.b, l.U)
    return model.head(h)


@torch.no_grad()
def reduced_forward_hybrid(model: ReducedLSTM, x: torch.Tensor) -> torch.Tensor:
    """Reduced model: factored two-step input projections as matmuls, the
    folded two-step recurrence kernel for the time loop. x (T, d) -> (T, out)."""
    h = x
    for l in model.layers:
        xp = reduced_projection(l, h, "w") + l.b
        uB = tuple(l.uB) if l.split else l.uB
        uC = tuple(l.uC) if l.split else l.uC
        h = reduced_recurrence(xp, uB, uC)
    return model.head(h)
