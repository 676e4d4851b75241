"""Shared folding helpers used by model applies and kernels.

Counterpart of ``svd_lstm_tpu/utils/linalg.py``. The TPU lane-padding and
compact-gate helpers are not carried over: the CUDA kernels take the Keras
layout as it is stored.
"""

from __future__ import annotations

import torch


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def fold_IC(B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """[I | C]: (r, r + C.cols). (x@B) @ [I|C] == concat(x@B, (x@B)@C) —
    the folded form of the exact two-step product (no concatenation)."""
    r = B.shape[1]
    eye = torch.eye(r, dtype=B.dtype, device=B.device)
    return torch.cat([eye, C], dim=1) if C.shape[1] else eye
