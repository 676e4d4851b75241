"""The benchmark's input data: a DROPBEAR-shaped run made from a seed.

A frozen copy of the port's ``data/synthetic.synthetic_dropbear_raw`` and of
the part of ``data/dropbear.preprocess_raw`` that frames it (forward-fill of
the pin channel, the cut at 1.5 s, the FFT resampling onto the 31.25 µs
clock, standard scaling, 16-sample frames). The real ``data_6_with_FFT.json``
is not in the repository. NumPy only: the program never makes the inputs,
and the reference reads the same arrays the program is given.

Every seed gives a run of the same length, so every seed gives the same
amount of work; the seed moves the sensor noise and the offsets the traffic
draws, nothing else.
"""

from __future__ import annotations

import numpy as np

SAMPLING_PERIOD = 500 / 16 * 1e-6  # s between resampled samples
START_TIME = 1.5                   # s cut from the start of the run


def _pin_profile(t: np.ndarray) -> np.ndarray:
    """Square wave early, sinusoid mid-run, impulses late (the DROPBEAR
    test profile)."""
    pin = np.full_like(t, 0.11)
    sq = (t >= 4) & (t < 16)
    pin[sq] = 0.08 + 0.07 * (np.floor((t[sq] - 4) / 2.0) % 2)
    si = (t >= 16) & (t < 30)
    pin[si] = 0.11 + 0.06 * np.sin(2 * np.pi * (t[si] - 16) / 5.0)
    im = t >= 30
    pin[im] = 0.11 + 0.06 * np.exp(-((t[im] % 4.0) - 0.5) ** 2 / 0.08) * np.sign(
        np.sin(2 * np.pi * t[im] / 8.0)
    )
    return pin


def raw_run(seed: int, duration: float, noise: float, acc_rate: float = 51_200.0 / 16.0,
            pin_rate: float = 250.0):
    """(acc, acc_t, pin, pin_t): a resonant response whose frequency falls
    as the pin extends, broadband noise of std ``noise``, and 25 NaNs in the
    pin channel."""
    rng = np.random.default_rng(seed)
    acc_t = np.arange(0.0, duration, 1.0 / acc_rate)
    pin_t = np.arange(0.0, duration, 1.0 / pin_rate)
    pin = _pin_profile(pin_t)
    pin_on_acc = _pin_profile(acc_t)
    freq = 120.0 - 350.0 * (pin_on_acc - 0.05)
    phase = 2 * np.pi * np.cumsum(freq) / acc_rate
    amp = 1.0 + 4.0 * (pin_on_acc - 0.05) / 0.12
    acc = amp * np.sin(phase)
    acc += 0.3 * amp * np.sin(2.0 * phase + 0.7)
    acc += noise * rng.standard_normal(acc_t.size)
    nan_idx = rng.choice(pin_t.size - 10, size=25, replace=False) + 5
    pin[nan_idx] = np.nan
    return acc, acc_t, pin, pin_t


def _forward_fill(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    mask = np.isnan(x)
    idx = np.where(~mask, np.arange(x.size), 0)
    np.maximum.accumulate(idx, out=idx)
    x[mask] = x[idx[mask]]
    still = np.isnan(x)
    if still.any():
        x[still] = x[np.flatnonzero(~still)[0]]
    return x


def _fft_resample(x: np.ndarray, num: int) -> np.ndarray:
    """scipy.signal.resample's rfft path (up-sampling)."""
    n = x.shape[0]
    X = np.fft.rfft(x)
    Y = np.zeros(num // 2 + 1, dtype=complex)
    N = min(num, n)
    nyq = N // 2 + 1
    Y[:nyq] = X[:nyq]
    if N % 2 == 0 and num > n:
        Y[N // 2] *= 0.5
    return np.fft.irfft(Y, num) * (float(num) / float(n))


def frames(seed: int, duration: float, noise: float, frame_width: int = 16):
    """``(X, y)``: X (N, frame_width) float32 standardized acceleration
    frames, y (N,) float32 standardized pin location at each frame's start."""
    acc, acc_t, pin, pin_t = raw_run(seed, duration, noise)
    pin = _forward_fill(pin)
    keep_p = pin_t > START_TIME
    pin, pin_t = pin[keep_p], pin_t[keep_p] - START_TIME
    keep_a = acc_t > START_TIME
    acc, acc_t = acc[keep_a], acc_t[keep_a] - START_TIME
    num = int((acc_t[-1] - acc_t[0]) / SAMPLING_PERIOD)
    res = _fft_resample(acc, num)
    res_t = np.arange(num) * ((acc_t[1] - acc_t[0]) * acc.size / float(num)) + acc_t[0]
    res_pin = np.interp(res_t, pin_t, pin)
    acc_s = (res - res.mean()) / res.std()
    pin_s = (res_pin - res_pin.mean()) / res_pin.std()
    n = acc_s.size // frame_width
    X = acc_s[: n * frame_width].reshape(n, frame_width).astype(np.float32)
    y = pin_s[: n * frame_width].reshape(n, frame_width)[:, 0].astype(np.float32)
    return X, y
