"""Synthetic data generators (numpy only).

Counterpart of ``svd_lstm_tpu/data/synthetic.py``, unchanged in behaviour.

* `generate_time_series` — sine-series toy task predicting period /
  amplitude / frequency (parity with reference
  code/old_versions/frequency-prediction-lstm.py:19-31); used throughout the
  test suite as a dataset-free fixture.
* `synthetic_dropbear_raw` — a deterministic DROPBEAR-shaped surrogate (the
  real `data_6_with_FFT.json` is gitignored upstream and not shipped):
  a beam-like acceleration signal whose dominant frequency tracks a
  piecewise pin-location profile, sampled at non-uniform-ish rates matching
  the real dataset's layout.
"""

from __future__ import annotations

import numpy as np


def generate_time_series(
    batch_size: int,
    n_steps: int,
    y_type: str = "period",
    seed: int | None = None,
):
    """Sine series with random period/phase/amplitude plus noise.

    Matches the reference generator semantics: period in [2, 10), phase in
    [0, 2π), amplitude in [0.2, 10), additive U(-0.05, 0.05) noise. Returns
    (X, y) with X of shape (batch, n_steps, 1) float32.
    """
    rng = np.random.default_rng(seed)
    T = rng.random((batch_size, 1)) * 8 + 2
    phase = rng.random((batch_size, 1)) * 2 * np.pi
    A = rng.random((batch_size, 1)) * 9.8 + 0.2
    time = np.linspace(0, n_steps, n_steps)[None, :]
    series = A * np.sin((time - phase) * 2 * np.pi / T)
    series = series + 0.1 * (rng.random((batch_size, n_steps)) - 0.5)
    X = series.astype(np.float32)[..., None]
    if y_type == "amplitude":
        y = A.flatten()
    elif y_type == "frequency":
        y = 1.0 / T.flatten()
    else:
        y = T.flatten()
    return X, y.astype(np.float32)


def _pin_profile(t: np.ndarray) -> np.ndarray:
    """Piecewise pin-location profile (m) over the run: square wave early,
    sinusoid mid-run, impulse-like excursions late — mirroring the DROPBEAR
    test profile described in the reference training notes
    (code/train_full_model_v4.py:16-17: "trained on the square and sinusoid
    profiles and the impulses is left for validation")."""
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


def synthetic_dropbear_raw(
    duration: float = 44.0,
    acc_rate: float = 51_200.0 / 16.0,
    pin_rate: float = 250.0,
    seed: int = 1234,
    noise: float = 0.15,
):
    """Deterministic DROPBEAR-shaped raw run.

    The beam's measured acceleration is modeled as a resonant response whose
    instantaneous frequency decreases with pin extension, plus broadband
    noise; the pin channel gets a few NaNs injected to exercise the
    forward-fill path (the real signal has them, v4:39-43).
    Returns a `RawRun`-compatible object.
    """
    from svd_lstm_tpu_torch.data.dropbear import RawRun

    rng = np.random.default_rng(seed)
    acc_t = np.arange(0.0, duration, 1.0 / acc_rate)
    pin_t = np.arange(0.0, duration, 1.0 / pin_rate)

    pin = _pin_profile(pin_t)
    pin_on_acc = _pin_profile(acc_t)

    # Instantaneous resonant frequency: stiffer (higher f) when pin retracted.
    freq = 120.0 - 350.0 * (pin_on_acc - 0.05)
    phase = 2 * np.pi * np.cumsum(freq) / acc_rate
    amp = 1.0 + 4.0 * (pin_on_acc - 0.05) / 0.12
    acc = amp * np.sin(phase)
    acc += 0.3 * amp * np.sin(2.0 * phase + 0.7)
    # ``noise`` is the broadband sensor-noise std. The default (0.15) gives
    # a very clean task (trained 4×40 reaches SNR ≈ 39 dB); raise it to
    # study the realistic percent-level-error regime the published model
    # operated in (its prediction plot shows visible error —
    # plots/full_model_prediction.png).
    acc += noise * rng.standard_normal(acc_t.size)

    # inject NaNs into pin to exercise forward-fill
    nan_idx = rng.choice(pin_t.size - 10, size=25, replace=False) + 5
    pin[nan_idx] = np.nan

    return RawRun(
        acc=acc.astype(np.float64),
        acc_t=acc_t,
        pin=pin.astype(np.float64),
        pin_t=pin_t,
    )
