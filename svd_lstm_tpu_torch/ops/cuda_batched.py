"""Batched fast-mode LSTM recurrence (K5): CUDA wrapper, plain version and
the whole batched fast forward.

Counterpart of ``svd_lstm_tpu/ops/pallas_batched.py``. The kernel is
hand-written CUDA in ``csrc/lstm_train.cu`` (``batched_chain``, design
notes there: one persistent cooperative launch for all T steps, the
product on the tensor cores); it replaces ``batched_lstm_recurrence_pallas``:

    z_t = bf16(h_{t-1}) · bf16(U) + xp_t      (float32 accumulation)
    h_t, c_t = gate update of z_t, c_{t-1}    (float32)

with c and h kept in float32 and h_t written out in xp's dtype (bf16 or
float32). On the TPU the bf16 operands came from the MXU's single-pass
``precision=DEFAULT`` dot; here they are rounded to bf16 (round to nearest
even) and multiplied by ``mma.sync`` with float32 sums, which gives the same
exact products, summed in the tensor cores' own order within each k group
of 16.

The wrapper routes on the device of its tensors, as every wrapper of the
port does: CPU tensors take the plain version, CUDA tensors launch the
kernel and raise if it fails. It counts its calls that launch the kernel
in ``batched_lstm_recurrence.launches``; a call launches the kernel once
for each chunk of rows of :func:`batched_plan` (once at B = 256, n = 512).
The kernel's instantiation that also stores c is the forward chain of K9f
and K6f (``ops/cuda_train.py``: ``wide_fwd_bf16``), launched and counted by
those wrappers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from svd_lstm_tpu_torch.models.lstm import StackedLSTM, gate_update
from svd_lstm_tpu_torch.ops import _build
from svd_lstm_tpu_torch.ops.cuda_lstm import _SMEM_LIMIT, _check_T, _launch, _on_card

SOURCE = "svd_lstm_tpu_torch/ops/csrc/lstm_train.cu"
# the TPU kernel the wrapper replaces, as file:line of its definition
REPLACES = {"batched_lstm_recurrence": "svd_lstm_tpu/ops/pallas_batched.py:56"}
_DTYPES = (torch.bfloat16, torch.float32)
# the CTA's tiles, rows × units (csrc BATCHED_TILES), in the order the rule
# tries them: the first whose shared memory fits and whose unit groups the
# card holds at once; the CTA stages its units' columns of Ut
BATCHED_TILES = ((32, 32), (32, 16), (16, 8))
# the c-storing instantiation's tiles past those (csrc UNSTAGED_TILES; K9f's
# and K6f's forward chain, ops/cuda_train.py), for the widths at which no
# staged tile fits: Ut read from a global copy (:func:`fragment_order`),
# only the h tile in shared memory. 16 x 64 ran 1.35x (n = 1280) and 4.2x
# (n = 2176) faster than 32 x 32 unstaged and needs fewer unit groups and
# fewer bytes a CTA at every width, so it is the one (PERF.md §6)
UNSTAGED_TILES = ((16, 64),)


class BatchedPlan(NamedTuple):
    """K5's launches (csrc ``batched_lstm_recurrence_launch`` checks each):
    the batch in chunks of at most ``chunk_rows`` rows, one cooperative
    launch a chunk, each for all T steps; in each, a CTA owns ``rows`` batch
    rows × ``units`` units (all four gate columns of them, staged in shared
    memory or, not ``staged``, read from the global copy), the grid
    ``unit_groups`` × ⌈chunk / rows⌉, all co-resident."""

    rows: int
    units: int
    unit_groups: int
    chunk_rows: int
    smem_bytes: int
    staged: bool = True

    def chunks(self, B: int) -> int:
        return -(-B // self.chunk_rows)


def batched_kp(n: int, staged: bool = True) -> int:
    """The product's K (csrc ``BatchedTile::kp``): n rounded up to the k
    group of 16, or, Ut not staged, to the 32 k of one load of its
    fragment-ordered copy."""
    return -(-n // 16) * 16 if staged else -(-n // 32) * 32


def batched_smem_bytes(n: int, rows: int, units: int, staged: bool = True) -> int:
    """Shared memory of a CTA: its rows of bf16 h_{t-1} and, ``staged``, its
    4·units columns of bf16 Uᵀ, each a row of :func:`batched_kp` values and
    16 bytes of padding (csrc ``BatchedTile::smem``)."""
    return 2 * ((4 * units if staged else 0) + rows) * (batched_kp(n, staged) + 8)


def batched_plan(B: int, n: int, sm_count: int, per_sm: Callable[[int, int, bool], int],
                 unstaged: bool = False) -> BatchedPlan:
    """K5's tile, grid and chunks for a batch of B rows and n units on a card
    of ``sm_count`` SMs, ``per_sm(rows, units, staged)`` being the kernel's
    CTAs an SM (the occupancy API's, on the card): the first of
    BATCHED_TILES (and then, with ``unstaged``, of UNSTAGED_TILES) whose
    shared memory fits a block and whose ⌈n / units⌉ unit groups the card
    holds at once; as many row tiles a launch as the CTAs left by the unit
    groups hold; the batch split into the fewest chunks of equal row tiles.
    Raises where no tile fits: the kernel is never run another way."""
    tiles = [(r, u, True) for r, u in BATCHED_TILES]
    tiles += [(r, u, False) for r, u in UNSTAGED_TILES] if unstaged else []
    for rows, units, staged in tiles:
        smem = batched_smem_bytes(n, rows, units, staged)
        if smem > _SMEM_LIMIT:
            continue
        unit_groups = -(-n // units)
        most = per_sm(rows, units, staged) * sm_count  # CTAs co-resident at once
        if unit_groups <= most:
            break
    else:
        raise ValueError(f"batched_lstm_recurrence: n = {n} fits no tile of {tiles} "
                         f"(shared memory, or unit groups co-resident on {sm_count} SMs)")
    tiles = -(-B // rows)
    chunks = -(-tiles // (most // unit_groups))
    return BatchedPlan(rows, units, unit_groups, -(-tiles // chunks) * rows, smem, staged)


def card_plan(dev: torch.device, B: int, n: int, bf16: bool, cell: bool = False) -> BatchedPlan:
    """:func:`batched_plan` on the card of ``dev``: its SM count and the
    occupancy there of the kernel's instantiation for ``bf16`` and a c
    output (``cell``: K9f's and K6f's forward chain, ops/cuda_train.py,
    which also takes the unstaged tiles)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return batched_plan(B, n, sms, lambda r, u, staged: _per_sm(idx, n, bf16, r, u, cell, staged),
                        unstaged=cell)


@functools.cache
def _per_sm(device_index: int, n: int, bf16: bool, rows: int, units: int, cell: bool = False,
            staged: bool = True) -> int:
    """The kernel's CTAs an SM at this width and tile (the occupancy API)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().batched_lstm_per_sm(n, rows, units, int(bf16), int(cell),
                                                   int(staged), ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"batched_lstm_recurrence: occupancy query failed with cudaError {err}")
    return out.value


def fragment_order(Ut: torch.Tensor) -> torch.Tensor:
    """Ut (4n, n) bf16 as the unstaged tiles read it: each row zero-padded
    to :func:`batched_kp` (a multiple of 32) and each 32 k reordered so that
    one 16-byte load at 8·t (t = lane % 4) holds the lane's mma B fragments
    of both k groups of 16: position 8t + 4g + 2i + l holds k = 16g + 8i +
    2t + l (g the k group, i the fragment register, l its half)."""
    G, n = Ut.shape
    K = batched_kp(n, staged=False)
    padded = torch.nn.functional.pad(Ut, (0, K - n))
    return padded.view(G, K // 32, 2, 2, 4, 2).permute(0, 1, 4, 2, 3, 5).reshape(G, K).contiguous()


@torch.no_grad()
def batched_lstm_recurrence_plain(xp: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic as a time loop. xp (T, B, 4n), U (n, 4n) ->
    h (T, B, n) in xp's dtype. The state is float32, or float64 for a
    float64 xp (the reference that ``chip_smoke.py`` measures the float32
    drift against); the dot's operands are bf16 in every case."""
    T, B, _ = xp.shape
    n = U.shape[0]
    acc = torch.float64 if xp.dtype == torch.float64 else torch.float32
    U16 = U.to(torch.bfloat16).to(acc)
    h = torch.zeros((B, n), dtype=acc, device=xp.device)
    c = torch.zeros_like(h)
    out = torch.empty((T, B, n), dtype=xp.dtype, device=xp.device)
    for t in range(T):
        z = xp[t].to(acc) + torch.matmul(h.to(torch.bfloat16).to(acc), U16)
        h, c = gate_update(z, c)
        out[t] = h
    return out


@torch.no_grad()
def batched_lstm_recurrence(xp: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """Batched h-side recurrence from the hoisted projection (bias
    included). xp (T, B, 4n) bf16 or float32, U (n, 4n) float32 or bf16 ->
    h (T, B, n) in xp's dtype."""
    T, B, g4 = xp.shape
    n = U.shape[0]
    _check_T("batched_lstm_recurrence", T)
    if tuple(U.shape) != (n, 4 * n) or g4 != 4 * n:
        raise ValueError(f"expected xp (T, B, 4n) and U (n, 4n), got {tuple(xp.shape)} "
                         f"and {tuple(U.shape)}")
    for name, t in (("xp", xp), ("U", U)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: expected bfloat16 or float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    if not _on_card(xp, U):
        return batched_lstm_recurrence_plain(xp, U)
    dev = xp.device
    bf16 = xp.dtype == torch.bfloat16
    plan = card_plan(dev, B, n, bf16)
    Ut = U.t().to(torch.bfloat16).contiguous()  # rounded once, as the MXU rounds U per step
    h = torch.empty((T, B, n), dtype=xp.dtype, device=dev)
    size = xp.element_size()
    for b0 in range(0, B, plan.chunk_rows):
        _launch("batched_lstm_recurrence", dev, xp.data_ptr() + b0 * 4 * n * size, Ut.data_ptr(),
                h.data_ptr() + b0 * n * size, None, None, T, min(plan.chunk_rows, B - b0), B, n,
                plan.rows, plan.units, int(bf16), 1)
    batched_lstm_recurrence.launches += 1
    return h


batched_lstm_recurrence.launches = 0

KERNELS = (batched_lstm_recurrence,)


@torch.no_grad()
def batched_forward_fast(model: StackedLSTM, x: torch.Tensor) -> torch.Tensor:
    """Whole dense model, batched, in fast precision. x (B, T, d) -> (B, T,
    out) float32.

    Per layer: the x-side ``bf16(h) · bf16(W)`` as one ``torch.matmul`` with
    a bf16 result, ``+ bf16(b)`` in bf16, then K5 on the layer's U. The head
    runs in float32 from the bf16 h. Every width goes to K5: the JAX package
    sent layers with ``n % 128 != 0`` to an all-bf16 XLA scan, because lane
    padding to 128 tripled the xp stream on the TPU; the H100 has no lanes to
    pad, so that branch is not carried over (the CPU tests hold the port to
    it within the fast band)."""
    h = x.transpose(0, 1).to(torch.bfloat16)  # (T, B, d)
    for l in model.layers:
        xp = torch.matmul(h, l.W.to(torch.bfloat16)) + l.b.to(torch.bfloat16)  # (T, B, 4n) bf16
        h = batched_lstm_recurrence(xp.contiguous(), l.U.contiguous())
    out = torch.matmul(h.float(), model.head.w.float()) + model.head.b.float()
    return out.transpose(0, 1)
