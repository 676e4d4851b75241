"""Configuration dataclasses.

Counterpart of ``svd_lstm_tpu/config.py``: the same four dataclasses with
the same fields and defaults, so a configuration carries across the two
packages unchanged (the reference's constants: sampling period 500/16 µs,
frame width 16, split at 30.7 s, units (40, 40, 40, 40), 20 000 windows ×
200 steps, 30 epochs of Adam on the window-end MSE, hoyer 0.01, cutoff 0.05).

Some knobs have no port yet. The training code raises
``NotImplementedError`` where it would use one of them, naming its ROADMAP
item; see :func:`check_train_config`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """DROPBEAR preprocessing knobs."""

    sampling_period: float = 500 / 16 * 1e-6   # seconds between raw samples
    frame_width: int = 16                      # samples per LSTM step
    start_time: float = 1.5                    # drop everything before t=1.5 s
    split_time: float = 30.7                   # train/test boundary (seconds)
    json_path: str = "data_6_with_FFT.json"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Stacked-LSTM regressor structure."""

    input_dim: int = 16
    units: Sequence[int] = (40, 40, 40, 40)
    head_dim: int = 1
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Windowed-BPTT training knobs.

    ``recurrence_kernel=True`` runs the training recurrences through the
    hand-written CUDA train kernels (``ops/cuda_train.py``): narrow stacks
    (every layer ≤ 128 units) through the whole-stack pair, uniform wide
    stacks (n % 128 == 0) through the per-layer pair. Both compute in
    float32, so unlike the JAX package's bf16-pass kernels they keep the
    exact-mode numerics.

    ``compact_gates`` picks the narrow whole-stack pair of the dense scan:
    True sends stacks of layers ≤ 64 units (input ≤ 128) whose weights fit
    in shared memory to K8 (``fused_narrow_train_apply_compact``, the
    weights resident on chip), False keeps K7, "auto" takes K8 from
    B = 128 on, the JAX package's rule. The singular and reduced views
    always use "auto". The 128-lane gate packing of the JAX package's
    compact layout is a TPU layout and is not carried over.
    """

    num_windows: int = 20_000
    window_len: int = 200
    batch_size: int = 32
    epochs: int = 30
    learning_rate: float = 1e-3     # keras adam default
    seed: int = 0
    nan_rollback: bool = True
    checkpoint_dir: str = "./model_saves"
    matmul_precision: str = "float32"   # only "float32" is ported
    recurrence_kernel: bool = False
    compact_gates: bool | str = "auto"
    auto_flags: bool = False            # not ported
    remat_chunk: int = 0                # not ported


@dataclasses.dataclass(frozen=True)
class FactorConfig:
    """SVD factorization / fine-tune knobs."""

    merged_kernel: bool = False     # split (per-gate) factorization is the reference default
    hoyer: float = 0.01             # Hoyer L1/L2 coefficient on σ vectors
    trace_norm: float = 0.0         # L1 on σ (the trace norm); 0 = off
    orthogonal: float = 0.0         # orthogonality penalty on U/V factors; >0 => train U/V
    train_uv: bool = False
    cutoff: float = 0.05            # σ truncation threshold
    finetune_epochs: int = 10
    finetune_batch_size: int = 32
    dropout: float = 0.0            # not ported
    recurrent_dropout: float = 0.0  # not ported


def check_train_config(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for the knobs the port does not have."""
    if cfg.matmul_precision != "float32":
        raise NotImplementedError(
            f"matmul_precision={cfg.matmul_precision!r} is not ported yet (ROADMAP "
            "queue 1, item 5: precision modes); use 'float32'"
        )
    if cfg.remat_chunk:
        raise NotImplementedError(
            "remat_chunk is not ported yet (ROADMAP queue 1, item 4: dropout and "
            "remat of the model applies); use remat_chunk=0"
        )
    if cfg.auto_flags:
        raise NotImplementedError(
            "auto_flags (the autotune cache) is not ported yet (ROADMAP queue 1, "
            "item 9); set the flags explicitly"
        )
