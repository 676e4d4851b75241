"""DROPBEAR dataset loading + preprocessing (numpy only).

Counterpart of ``svd_lstm_tpu/data/dropbear.py``, unchanged in behaviour.

Behavioral parity with the reference pipeline
(code/train_full_model_v4.py:24-80, identical copies in v3 and
svd_acceleration_v3.py:24-80):

1. load `data_6_with_FFT.json` with keys `acceleration_data`,
   `time_acceleration_data`, `measured_pin_location`,
   `measured_pin_location_tt`;
2. forward-fill NaNs in the pin signal;
3. drop everything before t = 1.5 s and rebase time;
4. FFT-resample the acceleration onto a uniform `sampling_period` clock
   (scipy.signal.resample semantics);
5. linearly interpolate the pin location onto that clock;
6. standard-scale both channels;
7. reshape into `frame_width`-wide frames so one LSTM step sees
   `frame_width` consecutive samples;
8. split train/test at t = 30.7 s.

The raw JSON is not shipped with the reference repo (gitignored); when it is
absent we can fall back to a deterministic synthetic surrogate with the same
shape and statistics (`svd_lstm_tpu_torch.data.synthetic.synthetic_dropbear_raw`)
so the full pipeline stays exercisable end-to-end.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import numpy as np

from svd_lstm_tpu_torch.config import DataConfig
from svd_lstm_tpu_torch.data.scalers import StandardScaler


@dataclasses.dataclass
class RawRun:
    """Raw (unprocessed) DROPBEAR-style signals."""

    acc: np.ndarray      # acceleration samples
    acc_t: np.ndarray    # acceleration timestamps (s)
    pin: np.ndarray      # measured pin location (m)
    pin_t: np.ndarray    # pin timestamps (s)


@dataclasses.dataclass
class Dataset:
    """Preprocessed DROPBEAR run, framed for the LSTM.

    X: (1, T, frame_width) standardized acceleration frames
    y: (T,) standardized pin location at each frame start
    t: (T,) frame-start times (s)
    """

    X: np.ndarray
    y: np.ndarray
    t: np.ndarray
    X_train: np.ndarray
    y_train: np.ndarray
    t_train: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray
    t_test: np.ndarray
    pin_scaler: StandardScaler
    acc_scaler: StandardScaler


def load_dropbear_json(path: str) -> RawRun:
    with open(path) as f:
        data = json.load(f)
    return RawRun(
        acc=np.array(data["acceleration_data"], dtype=np.float64),
        acc_t=np.array(data["time_acceleration_data"], dtype=np.float64),
        pin=np.array(data["measured_pin_location"], dtype=np.float64),
        pin_t=np.array(data["measured_pin_location_tt"], dtype=np.float64),
    )


def forward_fill_nan(x: np.ndarray) -> np.ndarray:
    """Vectorized forward-fill of NaNs (reference does a Python loop,
    v4:41-43). LEADING NaNs back-fill from the first finite value — the
    reference's loop accidentally wraps index −1 there; leaving them in
    place would silently poison the scalers and the whole dataset."""
    x = np.asarray(x, dtype=np.float64).copy()
    mask = np.isnan(x)
    if not mask.any():
        return x
    if mask.all():
        raise ValueError("forward_fill_nan: input is all-NaN")
    idx = np.where(~mask, np.arange(x.size), 0)
    np.maximum.accumulate(idx, out=idx)
    x[mask] = x[idx[mask]]
    still = np.isnan(x)
    if still.any():  # leading run: no earlier value exists
        x[still] = x[np.flatnonzero(~still)[0]]
    return x


def _fft_resample_numpy(x: np.ndarray, num: int) -> np.ndarray:
    """numpy implementation of scipy.signal.resample's rfft path."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    X = np.fft.rfft(x)
    Y = np.zeros(num // 2 + 1, dtype=complex)
    N = min(num, n)
    nyq = N // 2 + 1
    Y[:nyq] = X[:nyq]
    if N % 2 == 0:
        if num < n:
            # Down-sampling: fold the -Nyquist component into +Nyquist.
            Y[N // 2] *= 2.0
        elif num > n:
            # Up-sampling: the old Nyquist bin splits between ±Nyquist.
            Y[N // 2] *= 0.5
    return np.fft.irfft(Y, num) * (float(num) / float(n))


def fft_resample(x: np.ndarray, num: int, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """FFT-based resampling with `scipy.signal.resample(x, num, t)` semantics
    (reference uses scipy directly, code/train_full_model_v4.py:52).

    Uses scipy when importable for bit-exact parity, else a numpy
    implementation of the same algorithm. The returned time axis is uniform
    starting at t[0] with step (t[1]-t[0]) * len(x) / num.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    try:
        from scipy import signal as _signal

        y, t_new = _signal.resample(x, num, t)
        return y, t_new
    except ImportError:
        pass
    y = _fft_resample_numpy(x, num)
    dt = (t[1] - t[0]) * n / float(num)
    t_new = np.arange(num) * dt + t[0]
    return y, t_new


def preprocess_raw(raw: RawRun, cfg: DataConfig = DataConfig()) -> Dataset:
    """Run the full preprocessing pipeline on raw signals."""
    pin = forward_fill_nan(raw.pin)
    pin_t, acc, acc_t = raw.pin_t, raw.acc, raw.acc_t

    keep_p = pin_t > cfg.start_time
    pin, pin_t = pin[keep_p], pin_t[keep_p] - cfg.start_time
    keep_a = acc_t > cfg.start_time
    acc, acc_t = acc[keep_a], acc_t[keep_a] - cfg.start_time

    num = int((acc_t[-1] - acc_t[0]) / cfg.sampling_period)
    resample_acc, resample_t = fft_resample(acc, num, acc_t)
    resample_pin = np.interp(resample_t, pin_t, pin)

    acc_scaler = StandardScaler().fit(resample_acc.reshape(-1, 1))
    acc_s = acc_scaler.transform(resample_acc.reshape(-1, 1)).flatten()
    pin_scaler = StandardScaler().fit(resample_pin.reshape(-1, 1))
    pin_s = pin_scaler.transform(resample_pin.reshape(-1, 1)).flatten().astype(np.float32)

    ds = cfg.frame_width
    T = acc_s.size // ds
    X = acc_s[: T * ds].reshape(T, ds).astype(np.float32)
    t = resample_t[: T * ds].reshape(T, ds)[:, 0]
    y = pin_s[: T * ds].reshape(T, ds)[:, 0]

    X = X[None]  # (1, T, ds)

    tr = t < cfg.split_time
    te = t > cfg.split_time
    return Dataset(
        X=X, y=y, t=t,
        X_train=X[:, tr], y_train=y[tr], t_train=t[tr],
        X_test=X[:, te], y_test=y[te], t_test=t[te],
        pin_scaler=pin_scaler, acc_scaler=acc_scaler,
    )


def preprocess(cfg: DataConfig = DataConfig(), allow_synthetic: bool = True) -> Dataset:
    """Load + preprocess DROPBEAR; fall back to the synthetic surrogate when
    the raw JSON (gitignored upstream) is unavailable."""
    if os.path.exists(cfg.json_path):
        raw = load_dropbear_json(cfg.json_path)
    elif allow_synthetic:
        from svd_lstm_tpu_torch.data.synthetic import synthetic_dropbear_raw

        raw = synthetic_dropbear_raw()
    else:
        raise FileNotFoundError(
            f"{cfg.json_path} not found and allow_synthetic=False"
        )
    return preprocess_raw(raw, cfg)
