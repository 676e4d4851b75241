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
   reduced ``predict``;
5. check the train kernels against their plain versions on the card at the
   training path's shapes (K7 at 4×40, B = 32; K9 on a 512-unit layer and on
   the first layer, d = 16, B = 128; T = 200): h and c within 1e-4 or twice
   the plain float32 version's distance from the float64 one, whichever is
   larger (the cell state is unbounded and drifts by its ulps), every
   gradient within 1e-3 × its largest plain value (a weight gradient sums
   T·B products in another order), and time forward and backward;
6. drive the training path through the public entry points, on windows of
   the package's deterministic DROPBEAR surrogate: run A ``fit`` of a fresh
   4×40 stack (K7), run B ``finetune`` of σ under the Hoyer penalty on the
   factorized 4×30 checkpoint (K7 through the differentiable
   reconstruction), then ``make_reduced_model(cutoff=0.05)`` → ``predict``
   (K1), run C ``fit`` of the 3×512 checkpoint (K9 per layer); check that
   each run launched its kernels, that every loss is finite, that the
   fine-tune froze the factors and moved σ, and the reduced output;
7. hold each run against the same run with ``recurrence_kernel=False`` (the
   plain autograd scan): the first step's loss and gradients under the
   tolerances of 5, the loss histories within rtol 1e-3; time one train
   step of each.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import copy
import dataclasses
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
from svd_lstm_tpu_torch.data import preprocess_raw, split_train_random, synthetic_dropbear_raw
from svd_lstm_tpu_torch.models.reduced import reduced_projection
from svd_lstm_tpu_torch.ops import _build
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.train.finetune import make_finetune_optimizer, regularization_loss
from svd_lstm_tpu_torch.train.loop import default_apply_fn, mse_last_step, resolve_train_apply_fn

T = 6656
D = 16
TOL = 5e-4          # kernel vs plain version, f32 over T = 6656 steps
REF_STEPS = 256     # prefix compared with the plain CPU scan
REF_TOL = 1e-4      # floor of that comparison
TRAIN_T = 200       # window length of the training path
FWD_TOL = 1e-4      # train kernels vs plain: h and c, max abs diff (floor; see check_state)
GRAD_RTOL = 1e-3    # every gradient: max abs diff <= GRAD_RTOL * max |plain gradient|
HIST_RTOL = 1e-3    # loss histories, kernel runs vs plain runs
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


def check_vs_cpu_reference(name: str, y: torch.Tensor, m_cpu, x_cpu: torch.Tensor) -> None:
    """A card output y (T, 1) of predict(impl="auto") of a model: finite, and
    on its first REF_STEPS steps against the float64 plain scan of the same
    model on the CPU. The tolerance is twice the float32 error of the same
    impl on the CPU (plain versions), floored at REF_TOL: a reduced model
    with large C factors is ill-conditioned in float32 whatever the device.
    Converts m_cpu to float64."""
    if y.ndim != 2 or y.shape[1] != 1 or not bool(torch.isfinite(y).all()):
        fail(f"{name}: bad output {tuple(y.shape)}")
    impl = "fused" if max(l.units for l in m_cpu.layers) <= 128 else "hybrid"  # auto's pick
    cpu32 = P.predict(m_cpu, x_cpu, impl=impl)
    ref64 = P.predict(m_cpu.double(), x_cpu.double(), impl="scan").float()
    cpu_err = max_err(cpu32, ref64)
    log(f"[info] {name} first {len(x_cpu)} steps: CPU float32 impl={impl!r} "
        f"vs float64 scan {cpu_err:.3e}")
    check_close(f"{name} first {len(x_cpu)} steps vs CPU float64 scan",
                y[: len(x_cpu)].cpu(), ref64, max(REF_TOL, 2 * cpu_err))


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
        for label, y, m in (("dense", y_full, dense_cpu), ("reduced", y_red, red_cpu)):
            check_vs_cpu_reference(f"{name} {label}", y, m, x_cpu)
        timing = time_full_vs_reduced(dense, reduced, x)
        err = P.rmse(y_full.cpu().numpy(), y_red.cpu().numpy())
        log(f"[main] {name}: full_ms {timing.full_ms:.3f}  reduced_ms {timing.reduced_ms:.3f}  "
            f"ratio {timing.ratio:.4f}  rmse(reduced vs dense) {err:.6f}  "
            f"weights {weights(dense)} -> {weights(reduced)}")
        if merged:
            scan_ms = device_time_ms(lambda: P.predict(dense, x, impl="scan"))
            log(f"[main] {name}: dense impl='scan' {scan_ms:.3f} ms")
    return launches


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainRun:
    name: str
    make: object                       # device -> a fresh initial model
    cfg: P.TrainConfig
    kernels: tuple                     # the wrappers the run must launch
    factor_cfg: P.FactorConfig | None = None  # set: finetune; None: fit


TRAIN_RUNS = (
    TrainRun("A 4x40 fit",
             lambda dev: P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=D,
                                             units=(40, 40, 40, 40), device=dev),
             P.TrainConfig(window_len=TRAIN_T, batch_size=32, learning_rate=1e-3,
                           recurrence_kernel=True, num_windows=128, epochs=2),
             (ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd)),
    TrainRun("B 4x30 split finetune",
             lambda dev: P.make_singular_model(P.load_params(DENSE_30, device=dev), merged_kernel=False),
             P.TrainConfig(batch_size=32, window_len=TRAIN_T, recurrence_kernel=True,
                           num_windows=128, epochs=2),
             (ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd),
             P.FactorConfig(hoyer=0.01)),
    TrainRun("C 3x512 fit",
             lambda dev: P.load_params(DENSE_512, device=dev),
             P.TrainConfig(batch_size=128, window_len=TRAIN_T, recurrence_kernel=True,
                           num_windows=256, epochs=1),
             (ct.wide_layer_fwd, ct.wide_layer_bwd)),
)


def train_data():
    """The package's deterministic DROPBEAR surrogate, preprocessed."""
    return preprocess_raw(synthetic_dropbear_raw(duration=12.0), P.DataConfig(split_time=8.0))


def train(run: TrainRun, model, data, kernel: bool):
    cfg = dataclasses.replace(run.cfg, recurrence_kernel=kernel)
    if run.factor_cfg is None:
        return P.fit(model, data.X_train, data.y_train, cfg)
    return P.finetune(model, data.X_train, data.y_train, run.factor_cfg, cfg)


def first_batch(run: TrainRun, data, dev):
    """The first batch ``fit`` trains on: its sampler's windows, epoch 0's
    order. Returns x (B, T, d), y (B,) on the card."""
    cfg = run.cfg
    X, y = split_train_random(data.X_train, data.y_train, cfg.num_windows, cfg.window_len,
                              seed=cfg.seed)
    sel = np.random.default_rng(cfg.seed).permutation(len(X))[: cfg.batch_size]
    return torch.tensor(X[sel], device=dev), torch.tensor(y[sel], device=dev)


def check_grad(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    return check_close(name, got, want, GRAD_RTOL * float(want.abs().max()))


def check_state(name: str, got: torch.Tensor, plain: torch.Tensor, plain64: torch.Tensor) -> float:
    """A forward h or c of a train kernel against the plain version. The
    cell state is unbounded (|c| passes 100 in the 3x512 checkpoint), so two
    float32 recurrences drift apart by its ulps over T steps: the tolerance
    is FWD_TOL or twice the plain float32 version's own distance from the
    float64 plain version, whichever is larger."""
    drift = max_err(plain.double(), plain64)
    log(f"[info] {name}: max |plain| {float(plain.abs().max()):.3f}, plain float32 vs float64 "
        f"{drift:.3e}")
    return check_close(name, got, plain, max(FWD_TOL, 2 * drift))


def double(tensors):
    return [tuple(t.double() for t in l) if isinstance(l, tuple) else l.double() for l in tensors]


def time_pair(name: str, shape: str, kernel, plain, *args) -> dict:
    r = {"ms": device_time_ms(kernel, *args), "plain_ms": device_time_ms(plain, *args), "shape": shape}
    log(f"[time] {name} ({shape}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")
    return r


@torch.no_grad()
def train_kernel_checks(dev, data) -> dict:
    """Phase 5: K7 and K9 against their plain versions at the training
    path's shapes, timed."""
    rng = np.random.default_rng(1)
    results = {}

    # K7 at run A's shapes: 4x40, B = 32, T = 200, d = 16
    run = TRAIN_RUNS[0]
    layers = [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in run.make(dev).layers]
    x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()  # (T, B, d)
    dh = torch.tensor(rng.normal(size=(*x.shape[:2], 40)), dtype=torch.float32, device=dev)
    hs_p, cs_p = ct.fused_narrow_train_fwd_plain(layers, x)
    hs64, cs64 = ct.fused_narrow_train_fwd_plain(double(layers), x.double())
    hs, cs = ct.fused_narrow_train_fwd(layers, x)
    err = max(check_state(f"K7 fwd 4x40 {k}{i}", a, r, r64)
              for k, got, want, want64 in (("h", hs, hs_p, hs64), ("c", cs, cs_p, cs64))
              for i, (a, r, r64) in enumerate(zip(got, want, want64)))
    shape = "4x40, B=32, T=200, d=16"
    results["fused_narrow_train_fwd"] = {
        "max_abs_err": err,
        **time_pair("K7 fwd", shape, ct.fused_narrow_train_fwd, ct.fused_narrow_train_fwd_plain, layers, x),
    }
    args = (layers, x, hs_p, cs_p, dh)
    got, want = ct.fused_narrow_train_bwd(*args), ct.fused_narrow_train_bwd_plain(*args)
    err = max(check_grad(f"K7 bwd 4x40 {k}{i}", a, r)
              for k, gs, ws in zip(("dW", "dU", "db"), got[:3], want[:3])
              for i, (a, r) in enumerate(zip(gs, ws)))
    err = max(err, check_grad("K7 bwd 4x40 dx", got[3], want[3]))
    results["fused_narrow_train_bwd"] = {
        "max_abs_err": err,
        **time_pair("K7 bwd", shape, ct.fused_narrow_train_bwd, ct.fused_narrow_train_bwd_plain, *args),
    }
    time_pair("K7 fwd+bwd", shape,
              lambda: ct.fused_narrow_train_bwd(layers, x, *ct.fused_narrow_train_fwd(layers, x), dh),
              lambda: ct.fused_narrow_train_bwd_plain(layers, x, *ct.fused_narrow_train_fwd_plain(layers, x), dh))

    # K9 at run C's shapes: the first two layers of 3x512, B = 128, T = 200
    run = TRAIN_RUNS[2]
    m512 = run.make(dev)
    x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()
    fwd_err = bwd_err = 0.0
    for i, l in enumerate(m512.layers[:2]):
        W, U, b = (p.detach() for p in (l.W, l.U, l.b))
        h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b)
        h64, c64 = ct.wide_layer_fwd_plain(*double([x, W, U, b]))
        h, c = ct.wide_layer_fwd(x, W, U, b)
        name = f"K9 layer {i} (d={x.shape[-1]})"
        fwd_err = max(fwd_err, check_state(f"{name} fwd h", h, h_p, h64),
                      check_state(f"{name} fwd c", c, c_p, c64))
        dh = torch.tensor(rng.normal(size=h_p.shape), dtype=torch.float32, device=dev)
        args = (x, W, U, b, h_p, c_p, dh)
        got, want = ct.wide_layer_bwd(*args), ct.wide_layer_bwd_plain(*args)
        bwd_err = max(bwd_err, *(check_grad(f"{name} bwd {k}", a, r)
                                 for k, a, r in zip(("dx", "dW", "dU", "db"), got, want)))
        x = h_p
    shape = "one 512-unit layer, d=512, B=128, T=200"
    results["wide_layer_fwd"] = {
        "max_abs_err": fwd_err,
        **time_pair("K9 fwd", shape, ct.wide_layer_fwd, ct.wide_layer_fwd_plain, *args[:4]),
    }
    results["wide_layer_bwd"] = {
        "max_abs_err": bwd_err,
        **time_pair("K9 bwd", shape, ct.wide_layer_bwd, ct.wide_layer_bwd_plain, *args),
    }
    time_pair("K9 fwd+bwd", shape,
              lambda: ct.wide_layer_bwd(*args[:4], *ct.wide_layer_fwd(*args[:4]), dh),
              lambda: ct.wide_layer_bwd_plain(*args[:4], *ct.wide_layer_fwd_plain(*args[:4]), dh))
    return results


def check_finetune(init, tuned, data, dev) -> None:
    """Run B's end: the factors stayed frozen and σ moved; truncate and
    predict the test half through K1."""
    for i, (old, new) in enumerate(zip(init.layers, tuned.layers)):
        for f in ("wl", "wr", "ul", "ur", "b"):
            if not torch.equal(getattr(old, f), getattr(new, f)):
                fail(f"run B: frozen layers[{i}].{f} changed during the fine-tune")
        for f in ("ws", "us"):
            if torch.equal(getattr(old, f), getattr(new, f)):
                fail(f"run B: layers[{i}].{f} did not move during the fine-tune")
    reduced = P.make_reduced_model(tuned, cutoff=0.05)
    x = torch.tensor(data.X_test[0], device=dev)
    k1 = ck.fused_dense_stack.launches
    y_red = P.predict(reduced, x)
    torch.cuda.synchronize()
    if ck.fused_dense_stack.launches == k1:
        fail("run B: the reduced predict did not launch K1 (fused_dense_stack)")
    y_tuned = P.predict(tuned, x)
    check_vs_cpu_reference("run B reduced predict", y_red, copy.deepcopy(reduced).cpu(),
                           x[:REF_STEPS].cpu())
    y_true = data.y_test
    log(f"[train] run B: weights {weights(tuned)} -> {weights(reduced)} (cutoff 0.05); "
        f"RMSE vs the test targets: fine-tuned {P.rmse(y_tuned[:, 0].cpu().numpy(), y_true):.6f}, "
        f"reduced {P.rmse(y_red[:, 0].cpu().numpy(), y_true):.6f}")


def train_path(dev, data) -> tuple:
    """Phase 6: runs A, B and C through the public entry points, counted.
    Returns (launches, {run name: loss history})."""
    for k in (*ck.KERNELS, *ct.KERNELS):
        k.launches = 0
    histories = {}
    for run in TRAIN_RUNS:
        before = {k.__name__: k.launches for k in ct.KERNELS}
        init = run.make(dev)
        t0 = time.perf_counter()
        res = train(run, init, data, kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {k.__name__: k.launches - before[k.__name__] for k in ct.KERNELS}
        log(f"[train] run {run.name}: loss history {res.history}, rollbacks {res.rollbacks}, "
            f"{wall:.2f} s wall, train kernel launches {delta}")
        for k in run.kernels:
            if delta[k.__name__] < 1:
                fail(f"run {run.name}: {k.__name__} was not launched")
        if not res.history or res.rollbacks or not np.all(np.isfinite(res.history)):
            fail(f"run {run.name}: non-finite loss")
        if run.factor_cfg is not None:
            check_finetune(init, res.params, data, dev)
        histories[run.name] = res.history
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ct.KERNELS}
    log(f"[train] kernel launches during the training path: {launches}")
    return launches, histories


def first_step(run: TrainRun, dev, x, y, kernel: bool):
    """The first train step of a run from its initial model. Returns (loss,
    {parameter: gradient}, step), where step() runs one whole train step
    (forward, backward, Adam) on the same model, for timing."""
    model = run.make(dev)
    cfg = dataclasses.replace(run.cfg, recurrence_kernel=kernel)
    apply_fn, used = resolve_train_apply_fn(cfg, default_apply_fn(model))
    if used != kernel:
        fail(f"run {run.name}: recurrence_kernel={kernel} resolved to the other path")
    if run.factor_cfg is None:
        opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate)
    else:
        opt = make_finetune_optimizer(model, run.factor_cfg, cfg.learning_rate)

    def loss_of():
        loss = mse_last_step(model, x, y, apply_fn)
        if run.factor_cfg is not None:
            loss = loss + regularization_loss(model, run.factor_cfg)
        return loss

    def step():
        with exact_matmul():
            opt.zero_grad(set_to_none=True)
            loss_of().backward()
            opt.step()

    with exact_matmul():
        loss = loss_of()
        loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()}
    return loss.item(), grads, step


def train_comparisons(dev, data, histories: dict) -> None:
    """Phase 7: each run against the same run on the plain autograd scan.
    ``histories`` holds each run's loss history from phase 6."""
    for run in TRAIN_RUNS:
        x, y = first_batch(run, data, dev)
        loss_k, grads_k, step_k = first_step(run, dev, x, y, kernel=True)
        loss_p, grads_p, step_p = first_step(run, dev, x, y, kernel=False)
        tol = FWD_TOL * max(1.0, abs(loss_p))
        log(f"[check] run {run.name} first-step loss: kernel {loss_k:.8f}, plain {loss_p:.8f} "
            f"(tol {tol:g})")
        if not abs(loss_k - loss_p) <= tol:
            fail(f"run {run.name}: first-step loss differs by {abs(loss_k - loss_p):.3e}")
        for name, want in grads_p.items():
            check_grad(f"run {run.name} first-step d{name}", grads_k[name], want)
        hist_k = np.asarray(histories[run.name])
        hist_p = np.asarray(train(run, run.make(dev), data, kernel=False).history)
        rel = float(np.max(np.abs(hist_k - hist_p) / np.abs(hist_p)))
        log(f"[check] run {run.name} loss history: kernel {hist_k.tolist()}, plain "
            f"{hist_p.tolist()}, max rel diff {rel:.3e} (rtol {HIST_RTOL:g})")
        if not (hist_k.shape == hist_p.shape and rel <= HIST_RTOL):
            fail(f"run {run.name}: loss histories of kernel and plain runs disagree")
        ms_k, ms_p = device_time_ms(step_k), device_time_ms(step_p)
        log(f"[time] run {run.name} one train step (forward, backward, Adam; B={run.cfg.batch_size}, "
            f"T={run.cfg.window_len}): kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")


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

    data = train_data()
    with exact_matmul():
        checks.update(train_kernel_checks(dev, data))
    train_launches, histories = train_path(dev, data)
    launches.update(train_launches)
    train_comparisons(dev, data, histories)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": module.SOURCE,
            "replaces": module.REPLACES[name],
            "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": checks[name]["ms"],
            "plain_ms": checks[name]["plain_ms"],
        }
        for module in (ck, ct)
        for name in module.REPLACES
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
