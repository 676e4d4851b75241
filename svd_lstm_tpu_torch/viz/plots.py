"""Figures of the workflow commands: the reference's published plots.

Counterpart of ``svd_lstm_tpu/viz/plots.py``, figure for figure:

* :func:`plot_rmse_curve`         -> RMSE_plot.png
  (reference old_versions/svd_acceleration.py:144-158)
* :func:`plot_timing_curve`       -> timing_plot.png (slide 15)
* :func:`plot_prediction_overlay` -> full_model_prediction.png
  (reference old_versions/svd_acceleration.py:113-122,
  svd_acceleration_v3.py:176-186)
* :func:`save_prediction_gif`     -> reduce_rank.gif
  (reference old_versions/svd_acceleration.py:175-187)

matplotlib (the Agg backend) and imageio are imported inside the functions,
so ``import svd_lstm_tpu_torch`` works on a machine that has neither; a call
without matplotlib raises ``ImportError``. Series may be numpy arrays,
sequences or tensors on any device.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first call."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(v):
    """A series as a numpy array (tensors leave their device)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _savefig(fig, savepath: str | None, dpi: int = 200):
    if savepath:
        os.makedirs(os.path.dirname(os.path.abspath(savepath)), exist_ok=True)
        fig.savefig(savepath, dpi=dpi)
    return fig


def plot_rmse_curve(x, rmse_ratio, xlabel="n - r", savepath=None, unit_line=True, ylim=None):
    plt = pyplot()
    x, rmse_ratio = _host(x), _host(rmse_ratio)
    fig = plt.figure(figsize=(6, 4))
    plt.title("RMSE change with reduced rank")
    plt.plot(x, rmse_ratio)
    if unit_line:
        plt.plot([min(x), max(x)], [1, 1], "k--", label="unit ratio")
        plt.legend(loc=2)
    if ylim is not None:
        plt.ylim(ylim)
    plt.xlabel(xlabel)
    plt.ylabel("RMSE(reduced)/RMSE(full)")
    plt.tight_layout()
    return _savefig(fig, savepath)


def plot_timing_curve(x, timing_ratio, xlabel="n - r", savepath=None):
    plt = pyplot()
    x, timing_ratio = _host(x), _host(timing_ratio)
    fig = plt.figure(figsize=(6, 4))
    plt.title("Timing change with reduced rank")
    plt.plot(x, timing_ratio)
    plt.plot([min(x), max(x)], [1, 1], "k--", label="unit ratio")
    plt.xlabel(xlabel)
    plt.ylabel("timing(reduced)/timing(full)")
    plt.legend(loc=2)
    plt.tight_layout()
    return _savefig(fig, savepath)


def plot_prediction_overlay(t, y_true, predictions: dict, title="LSTM prediction of pin location",
                            savepath=None, annotate: str | None = None):
    """``predictions``: {label: series}, drawn over the reference series."""
    plt = pyplot()
    fig = plt.figure(figsize=(7, 3.3))
    plt.title(title)
    t = _host(t)
    plt.plot(t, _host(y_true), label="reference", alpha=0.8)
    for label, series in predictions.items():
        plt.plot(t, _host(series), label=label)
    if annotate:
        plt.text(0.05, 0.9, annotate, fontsize=15, transform=plt.gca().transAxes)
    plt.xlabel("time [s]")
    plt.ylabel("pin location [m]")
    plt.legend(loc=1)
    plt.tight_layout()
    return _savefig(fig, savepath)


def save_prediction_gif(t, y_true, predictions: Sequence, savepath: str,
                        labels: Sequence[str] | None = None, duration: float = 0.25,
                        dpi: int = 100):
    """An animated gif of the predictions as the rank is reduced, a frame
    each (the reference rendered per-frame PNGs and stitched them with
    imageio). Raises ``RuntimeError`` without imageio."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise RuntimeError("imageio not available; cannot write gif") from e

    plt = pyplot()
    os.makedirs(os.path.dirname(os.path.abspath(savepath)), exist_ok=True)
    frames = []
    for i, pred in enumerate(predictions):
        label = labels[i] if labels and i < len(labels) else f"n - r = {i}"
        fig = plot_prediction_overlay(t, y_true, {"reduced model": pred}, annotate=label)
        fig.set_dpi(dpi)
        fig.canvas.draw()
        w, h = fig.canvas.get_width_height()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        frames.append(buf.reshape(h, w, 4)[..., :3].copy())
        plt.close(fig)
    imageio.mimsave(savepath, frames, duration=duration)
    return savepath
