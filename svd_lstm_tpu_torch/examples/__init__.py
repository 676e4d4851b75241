"""The workflow commands of ``python -m svd_lstm_tpu_torch``: one module a
command, each the counterpart of the JAX package's script of the same file
name (``examples/*.py``; ``native-bench``: ``scripts/bench_native.py``).

Each module has ``run(...)``, with explicit sizes and a ``device``, and
``main(argv=None)``, which parses the JAX script's flags plus ``--device``
(default ``cuda``: the card) and calls ``run``. What they share lives here:
the device, the output root, the DROPBEAR data block the JAX scripts repeat
(e.g. ``examples/svd_acceleration.py:87-99``), the timer and the figure
switch.

Outputs go under ``torch_runs/`` (``torch_runs/model_saves/``,
``torch_runs/plots/``) of the working directory by default, never into the
repository's committed ``model_saves/`` or ``plots/``. ``--plots ""`` draws
no figure (and says so), so a command runs where matplotlib is absent.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Callable

import numpy as np
import torch

OUT_ROOT = "torch_runs"
SAVES = os.path.join(OUT_ROOT, "model_saves")
PLOTS = os.path.join(OUT_ROOT, "plots")
# the checkpoint compress and sweep start from (a 2x40 stack, d = 16); read only
PRETRAINED = "./model_saves/pretrained_sequential.npz"


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the models run (default: the card; 'cpu' for the CPU)")


def add_plots(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--plots", default=PLOTS,
                    help=f"figure directory (default {PLOTS}); '' draws no figure")


def device_of(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device where there is no card raises
    (no command falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA card is available (use --device cpu)")
    return dev


def quick_dataset(duration: float, split_time: float, noise: float | None = None, cfg=None):
    """The surrogate DROPBEAR run of the ``--quick`` paths: ``duration``
    seconds of ``data/synthetic.py``'s signal (at ``noise``, where given),
    split at ``split_time``."""
    import dataclasses

    from svd_lstm_tpu_torch.config import DataConfig
    from svd_lstm_tpu_torch.data import preprocess_raw, synthetic_dropbear_raw

    kw = {} if noise is None else {"noise": noise}
    cfg = dataclasses.replace(cfg or DataConfig(), split_time=split_time)
    return preprocess_raw(synthetic_dropbear_raw(duration=duration, **kw), cfg)


def full_dataset(cfg=None):
    """The DROPBEAR run (``data.preprocess``: the JSON where present, else
    the surrogate, as in the JAX package)."""
    from svd_lstm_tpu_torch.config import DataConfig
    from svd_lstm_tpu_torch.data import preprocess

    return preprocess(cfg or DataConfig())


def to_metres(ds, v) -> np.ndarray:
    """A scaled pin series (array or tensor) in metres."""
    v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return ds.pin_scaler.inverse_transform(v.reshape(-1, 1)).ravel()


def clock(dev: torch.device) -> str:
    return "CUDA events" if dev.type == "cuda" else "host clock, CPU"


def time_ms(fn: Callable, *args, dev: torch.device, repeats: int = 3) -> float:
    """Median ms of ``fn(*args)`` over ``repeats`` calls after one warm-up:
    on the card CUDA events (``bench/devtime.py``), on the CPU the host's
    clock (a CPU time, never a device metric)."""
    if dev.type == "cuda":
        from svd_lstm_tpu_torch.bench.devtime import device_time_ms

        return device_time_ms(fn, *args, repeats=repeats)
    fn(*args)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class ClippedSGD(torch.optim.SGD):
    """optax's ``chain(clip(clip), sgd(lr, momentum))``: SGD with momentum
    on gradients first clamped element by element to [-clip, clip] (the
    reference's v1 optimizer, ``SGD(momentum=.9, clipvalue=.5)``)."""

    def __init__(self, params, lr: float, momentum: float, clip: float):
        super().__init__(params, lr=lr, momentum=momentum)
        self.clip = clip

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.clamp_(-self.clip, self.clip)
        return super().step(closure)


def figure_path(plots: str, name: str) -> str | None:
    """``plots/name``, or None (and a line saying so) when ``plots`` is ''."""
    if not plots:
        print(f"--plots '': no figure written ({name})")
        return None
    return os.path.join(plots, name)
