"""Configuration dataclasses.

Counterpart of ``svd_lstm_tpu/config.py``: the same five dataclasses with
the same fields and defaults, so a configuration carries across the two
packages unchanged (the reference's constants: sampling period 500/16 µs,
frame width 16, split at 30.7 s, units (40, 40, 40, 40), 20 000 windows ×
200 steps, 30 epochs of Adam on the window-end MSE, hoyer 0.01, cutoff 0.05).

:func:`check_train_config` refuses an unknown ``matmul_precision``.
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

    ``matmul_precision`` sets the products of the train step, forward and
    backward (``utils.precision.train_matmul_scope``; validation always runs
    exact): "float32" exact, "tensorfloat32" TF32 on the card (the JAX
    package's 3-pass bf16 on the TPU), "bfloat16" the TPU's single-pass
    DEFAULT dot (bf16 operands, float32 sums, a float32 result).

    ``recurrence_kernel=True`` runs the training recurrences through the
    hand-written CUDA train kernels (``ops/cuda_train.py``): narrow stacks
    (every layer ≤ 128 units) through the whole-stack pair (K7, or K8 by
    ``compact_gates``), uniform wide stacks (n % 128 == 0) through the
    per-layer pair (K9), one aligned layer through the recurrence pair (K6).
    Which kernels, by ``matmul_precision``:

    * "float32": the float32 kernels, exact (the JAX package has no exact
      train kernel: its kernels are always bf16-pass);
    * "tensorfloat32": the float32 kernels, with the products outside them
      (the head, K6's x-side) in TF32;
    * "bfloat16": their bf16-operand variants (K7f, K8f, K9f, K6f: every
      in-kernel product on bf16-rounded operands, float32 sums, state and
      gate math), the JAX package's ``recurrence_kernel`` regime
      (``fused_kernel`` in its training autotune).

    ``auto_flags=True`` makes ``fit`` look up the autotune cache
    (``bench/autotune.py``, written by ``tune --train``) for this model,
    window batch and device, and on a hit train with the stored
    ``(matmul_precision, recurrence_kernel, compact_gates)``.

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
    matmul_precision: str = "float32"   # "float32", "tensorfloat32" or "bfloat16"
    recurrence_kernel: bool = False
    compact_gates: bool | str = "auto"
    auto_flags: bool = False
    # Chunked-time activation rematerialization of the plain scan's train
    # step (``torch.utils.checkpoint`` around each chunk of this many
    # steps, ``models/lstm.chunked_remat_scan``): the backward pass keeps
    # only the raw input chunks and the chunk-boundary (h, c) and
    # recomputes the rest, O(T/K + K) live activation memory instead of
    # O(T) for ~2x the forward's work, the same values. It lets windows
    # train whose saved activations would not fit in the card's memory.
    # 0 = off. Ignored when recurrence_kernel takes the step (the train
    # kernels keep their own residuals).
    remat_chunk: int = 0


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
    # Keras-semantics dropout during the fine-tune: masks on the cell inputs
    # / on h(t-1), constant across time, fresh each batch (the reference's
    # SingularLSTMCell). Fine-tunes with dropout keep the plain scan.
    dropout: float = 0.0
    recurrent_dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Rank-reduction sweep knobs (reference code/old_versions/svd_acceleration.py:61-88)."""

    protect_first_layer_w: bool = True   # reference :67-68
    evaluate_every: int = 1
    threshold: float | None = None       # stop when the RMSE ratio exceeds this


TRAIN_PRECISIONS = ("float32", "tensorfloat32", "bfloat16")  # TrainConfig.matmul_precision


def check_train_config(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for an unknown ``matmul_precision``."""
    if cfg.matmul_precision not in TRAIN_PRECISIONS:
        raise ValueError(
            f"unknown matmul_precision {cfg.matmul_precision!r}; expected one of {TRAIN_PRECISIONS}"
        )
