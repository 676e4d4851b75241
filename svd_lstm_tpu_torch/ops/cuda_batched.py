"""Batched fast-mode LSTM recurrence (K5): CUDA wrapper, plain version and
the whole batched fast forward.

Counterpart of ``svd_lstm_tpu/ops/pallas_batched.py``. The kernel is
hand-written CUDA in ``csrc/lstm_train.cu`` (``batched_step``, design notes
there); it replaces ``batched_lstm_recurrence_pallas``:

    z_t = bf16(h_{t-1}) · bf16(U) + xp_t      (float32 accumulation)
    h_t, c_t = gate update of z_t, c_{t-1}    (float32)

with c and h kept in float32 and h_t written out in xp's dtype (bf16 or
float32). On the TPU the bf16 operands came from the MXU's single-pass
``precision=DEFAULT`` dot; here they are rounded to bf16 (round to nearest
even) before a float32 multiply-add, which gives the same exact products.

The wrapper routes on the device of its tensors, as every wrapper of the
port does: CPU tensors take the plain version, CUDA tensors launch the
kernel and raise if it fails. It counts its launches in
``batched_lstm_recurrence.launches``.
"""

from __future__ import annotations

import torch

from svd_lstm_tpu_torch.models.lstm import StackedLSTM, gate_update
from svd_lstm_tpu_torch.ops.cuda_lstm import _check_T, _launch, _on_card

SOURCE = "svd_lstm_tpu_torch/ops/csrc/lstm_train.cu"
# the TPU kernel the wrapper replaces, as file:line of its definition
REPLACES = {"batched_lstm_recurrence": "svd_lstm_tpu/ops/pallas_batched.py:56"}
_DTYPES = (torch.bfloat16, torch.float32)


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
    U16 = U.to(torch.bfloat16).contiguous()  # rounded once, as the MXU rounds it per step
    h = torch.empty((T, B, n), dtype=xp.dtype, device=dev)
    c = torch.empty((B, n), dtype=torch.float32, device=dev)  # the cell state, in place
    _launch("batched_lstm_recurrence", dev, xp.data_ptr(), U16.data_ptr(), h.data_ptr(),
            c.data_ptr(), T, B, n, int(xp.dtype == torch.bfloat16))
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
