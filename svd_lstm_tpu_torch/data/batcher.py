"""Random-window batching for windowed-BPTT training (numpy only).

Counterpart of ``svd_lstm_tpu/data/batcher.py``, unchanged in behaviour.

Parity with the reference batcher (code/train_full_model_v4.py:82-87):
sample `batch_size` windows of `train_len` steps uniformly from the training
run; the label is the target value at the window *end* (many-to-one).
"""

from __future__ import annotations

import numpy as np


def split_train_random(
    X_train: np.ndarray,
    y_train: np.ndarray,
    batch_size: int,
    train_len: int,
    seed: int | None = None,
):
    """X_train: (1, T, d); y_train: (T,). Returns (batch, train_len, d), (batch,)."""
    rng = np.random.default_rng(seed)
    run_size = X_train.shape[1]
    if train_len >= run_size:
        raise ValueError(
            f"window_len {train_len} must be shorter than the training run "
            f"({run_size} frames) — no window fits"
        )
    starts = rng.integers(0, run_size - train_len, size=batch_size)
    # Gather windows with one vectorized fancy-index instead of a Python loop.
    offsets = np.arange(train_len)
    idx = starts[:, None] + offsets[None, :]
    X_mini = X_train[0][idx]                 # (batch, train_len, d)
    y_mini = y_train[starts + train_len]     # label at window end
    return np.ascontiguousarray(X_mini), np.ascontiguousarray(y_mini)


def split_train_random_multi(
    X_runs: np.ndarray,
    y_runs: np.ndarray,
    batch_size: int,
    train_len: int,
    seed: int | None = None,
):
    """Multi-run variant (reference code/svd_acceleration_v2.py:80-86 and
    old_versions/toy-convolution.py:43-49): X_runs (R, T, d), y_runs (R, T);
    windows are sampled uniformly over (run, offset) pairs."""
    rng = np.random.default_rng(seed)
    R, T = X_runs.shape[0], X_runs.shape[1]
    if train_len >= T:
        raise ValueError(
            f"window_len {train_len} must be shorter than the runs "
            f"({T} frames) — no window fits"
        )
    runs = rng.integers(0, R, size=batch_size)
    starts = rng.integers(0, T - train_len, size=batch_size)
    offsets = np.arange(train_len)
    idx = starts[:, None] + offsets[None, :]
    X_mini = X_runs[runs[:, None], idx]
    y_mini = y_runs[runs, starts + train_len]
    return np.ascontiguousarray(X_mini), np.ascontiguousarray(y_mini)


def window_epoch_iterator(
    X_mini: np.ndarray,
    y_mini: np.ndarray,
    batch_size: int,
    seed: int = 0,
):
    """Yield shuffled (x, y) minibatches of a fixed window set, dropping the
    ragged tail so every step sees the same batch shape."""
    rng = np.random.default_rng(seed)
    n = X_mini.shape[0]
    perm = rng.permutation(n)
    n_full = (n // batch_size) * batch_size
    if n_full == 0:
        # yielding nothing would crash the caller far from the
        # misconfiguration (the mean of an empty loss list)
        raise ValueError(
            f"window count ({n}) < batch_size ({batch_size}): zero batches"
        )
    for i in range(0, n_full, batch_size):
        sel = perm[i : i + batch_size]
        yield X_mini[sel], y_mini[sel]
