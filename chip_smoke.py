#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``svd_lstm_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; with no card it exits non-zero at once and
prints no result. It imports torch, numpy and the port, never JAX.

Phases, each of which raises on failure (no phase is caught):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``svd_lstm_tpu_torch/ops/csrc`` and print the
   build time and the compiler's resource report;
3. check each kernel against its plain PyTorch version on the card at the
   main path's shapes (T = 6656, d = 16, TF32 off): max abs difference at
   most 5e-4 (the layout-exactness bound of ``bench.py``: the sum order
   differs from the plain version and the error grows over 6656 steps), and
   time both;
4. drive the main path through the public entry points — ``load_params`` →
   ``predict(dense)`` → ``make_singular_model`` → ``make_reduced_model`` →
   ``predict(reduced)`` — on the 3×512 checkpoint (merged, r=24) and the 4×30
   one (split, r=15), with ``impl="auto"``; check the outputs (finite, of
   shape (T, 1), and on the first 256 steps within twice the CPU's own
   float32 error of the float64 plain scan), that
   every kernel's launch count rose during this run, and time dense and
   reduced ``predict``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.api import exact_matmul
from svd_lstm_tpu_torch.bench.devtime import device_time_ms
from svd_lstm_tpu_torch.bench.timing import time_full_vs_reduced
from svd_lstm_tpu_torch.models.reduced import reduced_projection
from svd_lstm_tpu_torch.ops import _build
from svd_lstm_tpu_torch.ops import cuda_lstm as ck

T = 6656
D = 16
TOL = 5e-4          # kernel vs plain version, f32 over T = 6656 steps
REF_STEPS = 256     # prefix compared with the plain CPU scan
REF_TOL = 1e-4      # floor of that comparison
SAVES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "model_saves")
DENSE_30 = os.path.join(SAVES, "pretrained_30units_v4_n1.5.npz")
DENSE_512 = os.path.join(SAVES, "pretrained_3x512_n1.5.npz")
WIDE_R24 = os.path.join(SAVES, "wide_r24_progressive.npz")


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = max_err(got, want)
    log(f"[check] {name}: max abs diff {err:.3e} (tol {tol:g})")
    if not err <= tol:
        fail(f"{name}: max abs diff {err:.3e} above {tol:g}")
    return err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    log(f"[build] {info['path']}: nvcc {info['seconds']:.1f} s, "
        f"build+load {time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def recurrence_args(l):
    """What a layer's recurrence kernel takes after xp."""
    if isinstance(l, P.LSTMLayer):
        return (l.U,)
    return (tuple(l.uB), tuple(l.uC)) if l.split else (l.uB, l.uC)


def layer_runs(model, x, proj, plain):
    """Per layer: (layer, xp, plain h). Each layer's hoisted projection xp
    is taken from the plain h of the layer below, so every layer sees the
    inputs the stack gives it."""
    out, h = [], x
    for l in model.layers:
        xp = (proj(l, h) + l.b).contiguous()
        h = plain(xp, *recurrence_args(l))
        out.append((l, xp, h))
    return out


def kernel_checks(dev, x):
    """Phase 3: every kernel against its plain version at main-path shapes."""
    results = {}

    # K1: 4x30 dense, and its split r=15 truncation reconstructed to dense
    m30 = P.load_params(DENSE_30, device=dev)
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    err = 0.0
    for name, m in (("4x30 dense", m30), ("4x30 split r=15 reconstructed", P.reconstruct_dense_model(red30))):
        err = max(err, check_close(f"K1 fused_dense_stack {name}", ck.fused_dense_stack(m, x),
                                   ck.fused_dense_stack_plain(m, x), TOL))
    results["fused_dense_stack"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.fused_dense_stack, m30, x),
        "plain_ms": device_time_ms(ck.fused_dense_stack_plain, m30, x),
        "shape": "4x30, T=6656, d=16",
    }

    # K3: each layer of the 3x512 dense checkpoint
    m512 = P.load_params(DENSE_512, device=dev)
    runs = layer_runs(m512, x, lambda l, h: torch.matmul(h, l.W), ck.lstm_recurrence_plain)
    err = max(check_close(f"K3 lstm_recurrence 3x512 layer {i}", ck.lstm_recurrence(xp, l.U), h, TOL)
              for i, (l, xp, h) in enumerate(runs))
    l0, xp0, _ = runs[0]
    results["lstm_recurrence"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.lstm_recurrence, xp0, l0.U),
        "plain_ms": device_time_ms(ck.lstm_recurrence_plain, xp0, l0.U),
        "shape": "one 512-unit layer, T=6656",
    }

    # K2: merged r=24 checkpoint, and a split r=24 truncation of 3x512
    wide = P.load_params(WIDE_R24, device=dev)
    red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=False), rank=24)
    proj = lambda l, h: reduced_projection(l, h, "w")
    err = 0.0
    timed = None
    for name, m in (("merged r=24 (wide_r24_progressive)", wide), ("split r=24 (3x512)", red512)):
        for i, (l, xp, h) in enumerate(layer_runs(m, x, proj, ck.reduced_recurrence_plain)):
            args = (xp, *recurrence_args(l))
            err = max(err, check_close(f"K2 reduced_recurrence {name} layer {i}",
                                       ck.reduced_recurrence(*args), h, TOL))
            timed = timed or args
    results["reduced_recurrence"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.reduced_recurrence, *timed),
        "plain_ms": device_time_ms(ck.reduced_recurrence_plain, *timed),
        "shape": "one 512-unit layer, merged r=24, T=6656",
    }
    for name, r in results.items():
        log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    return results


def weights(model) -> int:
    return int(sum(p.numel() for l in model.layers for p in l.parameters()))


def main_path(dev, x):
    """Phase 4: the compress-and-predict path through the public entry
    points, counted, checked and timed."""
    configs = (
        ("3x512 merged r=24", DENSE_512, True, 24),
        ("4x30 split r=15", DENSE_30, False, 15),
    )
    for k in ck.KERNELS:
        k.launches = 0
    runs = []
    for name, path, merged, rank in configs:
        dense = P.load_params(path, device=dev)
        y_full = P.predict(dense, x)
        reduced = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)
        y_red = P.predict(reduced, x)
        runs.append((name, path, merged, rank, dense, reduced, y_full, y_red))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ck.KERNELS}
    log(f"[main] kernel launches during the main path: {launches}")
    for k, v in launches.items():
        if v < 1:
            fail(f"kernel {k} was not launched on the main path")

    x_cpu = x[:REF_STEPS].cpu()
    for name, path, merged, rank, dense, reduced, y_full, y_red in runs:
        # The same surgery on the CPU. The reference is its float64 plain
        # scan; the tolerance is twice the float32 error of the same impl on
        # the CPU (plain versions), floored at REF_TOL: a reduced model with
        # large C factors is ill-conditioned in float32 whatever the device.
        dense_cpu = P.load_params(path)
        red_cpu = P.make_reduced_model(P.make_singular_model(dense_cpu, merged_kernel=merged), rank=rank)
        impl = "fused" if max(l.units for l in dense_cpu.layers) <= 128 else "hybrid"  # auto's pick
        for label, y, m in (("dense", y_full, dense_cpu), ("reduced", y_red, red_cpu)):
            if tuple(y.shape) != (T, 1) or not bool(torch.isfinite(y).all()):
                fail(f"{name} {label}: bad output {tuple(y.shape)}")
            cpu32 = P.predict(m, x_cpu, impl=impl)
            ref64 = P.predict(m.double(), x_cpu.double(), impl="scan").float()
            cpu_err = max_err(cpu32, ref64)
            log(f"[info] {name} {label} first {REF_STEPS} steps: CPU float32 impl={impl!r} "
                f"vs float64 scan {cpu_err:.3e}")
            check_close(f"{name} {label} first {REF_STEPS} steps vs CPU float64 scan",
                        y[:REF_STEPS].cpu(), ref64, max(REF_TOL, 2 * cpu_err))
        timing = time_full_vs_reduced(dense, reduced, x)
        err = P.rmse(y_full.cpu().numpy(), y_red.cpu().numpy())
        log(f"[main] {name}: full_ms {timing.full_ms:.3f}  reduced_ms {timing.reduced_ms:.3f}  "
            f"ratio {timing.ratio:.4f}  rmse(reduced vs dense) {err:.6f}  "
            f"weights {weights(dense)} -> {weights(reduced)}")
        if merged:
            scan_ms = device_time_ms(lambda: P.predict(dense, x, impl="scan"))
            log(f"[main] {name}: dense impl='scan' {scan_ms:.3f} ms")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs only "
              "on a CUDA card", file=sys.stderr)
        return 2
    log(card_line())  # the card's name and power limit, as nvidia-smi prints them
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    build_kernels()

    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    with exact_matmul(), torch.no_grad():
        checks = kernel_checks(dev, x)
        launches = main_path(dev, x)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": ck.SOURCE,
            "replaces": ck.REPLACES[name],
            "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": checks[name]["ms"],
            "plain_ms": checks[name]["plain_ms"],
        }
        for name in ck.REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
