"""Evaluation metrics: RMSE / NRMSE / SNR.

Counterpart of ``svd_lstm_tpu/train/metrics.py``: numpy on the host, after
device inference.
"""

from __future__ import annotations

import math

import numpy as np


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true, np.float64).reshape(-1)
    y_pred = np.asarray(y_pred, np.float64).reshape(-1)
    return float(np.sqrt(np.mean(np.square(y_true - y_pred))))


def nrmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """RMSE normalized by the target's range."""
    y_true = np.asarray(y_true, np.float64)
    return rmse(y_true, y_pred) / float(y_true.max() - y_true.min())


def signaltonoise(
    signal: np.ndarray,
    noisy_signal: np.ndarray,
    invert: bool = False,
    dB: bool = True,
) -> float:
    """SNR = (A_signal/A_noise)_rms², in dB by default. ``invert=True``
    returns the noise-to-signal ratio (reduced-vs-full model noise)."""
    signal = np.asarray(signal, np.float64).reshape(-1)
    noisy_signal = np.asarray(noisy_signal, np.float64).reshape(-1)
    noise = signal - noisy_signal
    a_sig = math.sqrt(float(np.mean(np.square(signal))))
    a_noise = math.sqrt(float(np.mean(np.square(noise))))
    snr = (a_sig / a_noise) ** 2 if not invert else (a_noise / a_sig) ** 2
    if not dB:
        return snr
    return 10 * math.log10(snr)
