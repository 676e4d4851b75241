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
_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block can use
_DOT_PRECISIONS = (None, "default", "highest")


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


@torch.no_grad()
def lstm_recurrence(xp, U, h0=None, c0=None, dot_precision=None) -> torch.Tensor:
    """Dense h-side recurrence from the hoisted input projection (bias
    included). xp (T, 4n), U (n, 4n), optional h0/c0 (n,) -> (T, n)."""
    fast = _is_fast(dot_precision)
    T, n = xp.shape[0], U.shape[0]
    _check_T("lstm_recurrence", T)
    _check("xp", xp, (T, 4 * n))
    _check("U", U, (n, 4 * n))
    h0, c0 = _state("h0", h0, n), _state("c0", c0, n)
    if not _on_card(xp, U, *(s for s in (h0, c0) if s is not None)):
        return lstm_recurrence_plain(xp, U, h0, c0, dot_precision)
    _check_smem("lstm_recurrence", 6 * n)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)
    _launch(
        "lstm_recurrence", xp.device,
        xp.data_ptr(), _stored(U, fast).data_ptr(), _ptr(h0), _ptr(c0), out.data_ptr(), T, n,
        int(fast),
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
    """(Bt (R, rows), IC (R, 4n)) for the kernels, of either side. Split: all
    gates' B side by side, transposed, and a block-diagonal IC with
    fold_IC(B_g, C_g) in gate g's rows and columns (the zero blocks add exact
    zeros)."""
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
def reduced_recurrence(xp, uB, uC, h0=None, c0=None, dot_precision=None) -> torch.Tensor:
    """Low-rank h-side recurrence in the folded form (h·B)·[I|C].
    xp (T, 4n); merged uB (n, r), uC (r, 4n−r); split: 4 each of
    uB[g] (n, r_g), uC[g] (r_g, n−r_g). Optional h0/c0 (n,). -> (T, n)."""
    fast = _is_fast(dot_precision)
    T, g4 = xp.shape
    n = g4 // 4
    _check_T("reduced_recurrence", T)
    _check("xp", xp, (T, 4 * n))
    factors = _check_factors("u", uB, uC, n, n)
    h0, c0 = _state("h0", h0, n), _state("c0", c0, n)
    if not _on_card(xp, *factors, *(s for s in (h0, c0) if s is not None)):
        return reduced_recurrence_plain(xp, uB, uC, h0, c0, dot_precision)
    Bt, IC = (_stored(t, fast) for t in _pack_reduced(uB, uC, n))
    R = Bt.shape[0]
    _check_smem("reduced_recurrence", 6 * n + R)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)
    _launch(
        "reduced_recurrence", xp.device,
        xp.data_ptr(), Bt.data_ptr(), IC.data_ptr(), _ptr(h0), _ptr(c0),
        out.data_ptr(), T, n, R, int(fast),
    )
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


@torch.no_grad()
def fused_dense_stack(model: StackedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Whole dense stack in one kernel; the head is applied to the last
    layer's hidden sequence outside it. x (T, d) -> (T, out)."""
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
    _check_smem("fused_dense_stack", 2 * sum(units) + 4 * max(units) + d)
    weights = [(_stored(l.W, fast), _stored(l.U, fast), l.b) for l in model.layers]
    meta = np.array(
        [[l.input_dim, l.units, W.data_ptr(), U.data_ptr(), b.data_ptr()]
         for l, (W, U, b) in zip(model.layers, weights)],
        dtype=np.int64,
    )
    h = torch.empty((T, units[-1]), dtype=torch.float32, device=x.device)
    _launch(
        "fused_dense_stack", x.device,
        meta.ctypes.data, len(units), x.data_ptr(), h.data_ptr(), T, d, int(fast),
    )
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


@torch.no_grad()
def fused_reduced_stack(model: ReducedLSTM, x: torch.Tensor, dot_precision=None) -> torch.Tensor:
    """Whole reduced stack in one kernel, both sides in the folded two-step
    form; the head is applied to the last layer's hidden sequence outside
    it. x (T, d) -> (T, out)."""
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
    packed = []
    for l in model.layers:
        wB, wC, uB, uC = _sides(l)
        w_side = [_stored(t, fast) for t in _pack_reduced(wB, wC, l.units)]
        u_side = [_stored(t, fast) for t in _pack_reduced(uB, uC, l.units)]
        packed.append((*w_side, *u_side))
    units = [l.units for l in model.layers]
    rmax = max(wBt.shape[0] + uBt.shape[0] for wBt, _, uBt, _ in packed)
    _check_smem("fused_reduced_stack", 2 * sum(units) + 4 * max(units) + rmax + d)
    meta = np.array(
        [[l.input_dim, l.units, wBt.shape[0], uBt.shape[0], wBt.data_ptr(), wIC.data_ptr(),
          uBt.data_ptr(), uIC.data_ptr(), l.b.data_ptr()]
         for l, (wBt, wIC, uBt, uIC) in zip(model.layers, packed)],
        dtype=np.int64,
    )
    h = torch.empty((T, units[-1]), dtype=torch.float32, device=x.device)
    _launch(
        "fused_reduced_stack", x.device,
        meta.ctypes.data, len(units), x.data_ptr(), h.data_ptr(), T, d, int(fast),
    )
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
