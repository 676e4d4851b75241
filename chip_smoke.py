#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``svd_lstm_tpu_torch``) on one card.

    python3 chip_smoke.py [--parent DIR]

Needs one CUDA card and ``nvcc``; with no card it exits non-zero at once and
prints no result. It imports torch, numpy and the port, never JAX. With
``--parent DIR`` (another checkout of the repo, e.g. the parent commit
unpacked by ``git archive``) phase 5c also times DIR's inference kernels and
paths, narrow and wide train kernels and steps in turns with this
checkout's (see 5c).

Phases, each of which raises on failure (no phase is caught):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``svd_lstm_tpu_torch/ops/csrc`` and print the
   build time and the compiler's resource report;
3. check each batch-1 kernel against its plain PyTorch version on the card
   at the main path's shapes (T = 6656, d = 16, TF32 off; K1's route, the
   weights' home and lanes of ``cuda_lstm.dense_plan``, K3's plan, its
   units a CTA, CTAs and the weights' home of
   ``cuda_lstm.recurrence_plan``, and K2's, its cluster of CTAs, warps a
   CTA, the weights' home and bytes a CTA of ``cuda_lstm.reduced_plan``,
   are printed; K2 on every layer of ``wide_r24_progressive`` and of the
   direct merged and split r = 24 truncations of 3×512): max abs
   difference at most 5e-4 (the layout-exactness bound of ``bench.py``: the
   sum order differs from the plain version and the error grows over 6656
   steps), and time both;
3b. check K5 (the batched fast-mode recurrence) against its plain version on
   every layer of the 3×512 and the 4×30 checkpoints at B = 256, T = 128
   (its tile and launches a call, ``cuda_batched.batched_plan``, printed):
   within 2 bf16 ulps of max |h| (the rounding of the bf16 output) or twice
   the plain version's distance from the same recurrence with float64 state,
   whichever is larger (a float32 sum order that flips the rounding of one
   bf16 h carries on to the next steps, as in ``check_state``); time both;
3c. check the batch-1 fast variants (bf16 operands, float32 sums and
   state) against their plain fast versions at the main path's widths
   (d = 16): K1f on the 4×30 checkpoint and K3f on each 3×512 layer over
   T = 6656, within K5's limit; K2f on each layer of ``wide_r24_progressive``
   (merged r = 24) and of the 4×30 split r = 15 truncation over 64 windows
   of 16 steps spread over T = 6656, each restarted from the plain
   version's (h, c); K4 (the fused reduced stack, its route, cluster, warps
   a CTA and the weights' home of ``cuda_lstm.reduced_stack_plan`` printed)
   exact over T = 6656 on 4×30 split r = 15 and the direct 3×512 merged r =
   24 truncation, within 5e-4 or twice the plain float32 version's distance
   from float64 (ROADMAP fault 3.1; the 4×30 stack's time, cuDNN's on its
   dense reconstruction and its bound logged beside the 3×512 one's), and
   fast over 64 windows of 8 steps of x from zero state on
   4×30 split r = 15 and ``wide_r24_progressive``. A windowed check holds
   the median window to 5e-4 and three quarters of the windows to 2 bf16
   ulps (``check_windows``: over a whole run, flipped bf16 roundings carry
   the two runs apart); time each kernel, its plain version and (K1f, K3f)
   cuDNN's bf16 LSTM;
4. drive the main path through the public entry points — ``load_params`` →
   ``predict(dense)`` → ``make_singular_model`` → ``make_reduced_model`` →
   ``predict(reduced)`` — on the 3×512 checkpoint (merged, r=24) and the 4×30
   one (split, r=15), with ``impl="auto"``; check the outputs (finite, of
   shape (T, 1), and on the first 256 steps within twice the CPU's own
   float32 error of the float64 plain scan), that
   every kernel's launch count rose during this run (K3 once a layer of
   the 3×512 dense ``predict``), and time dense and reduced ``predict``;
4b. drive batched inference through ``predict(model, x (B, T, d),
   precision=...)`` at B = 256, T = 128: ``"fast"`` on the 3×512 checkpoint,
   on ``wide_r24_progressive`` (reconstructed to dense) and on the 4×30
   checkpoint, ``"high"`` on the 3×512 one; check that K5 was launched, and
   each output against ``precision="exact"`` on the card: relative Frobenius
   error within the fast band of the JAX tests (2e-2 for the wide models,
   3e-2 for the narrow one; "high" is held to 2e-2 as well); time fast, high
   and exact;
4c. drive batch-1 ``predict(model, x (T, d), precision="fast")`` on the
   3×512 checkpoint (K3f), ``wide_r24_progressive`` (K2f), and the 4×30
   checkpoint dense and split r = 15 (K1f); check that each launched its
   kernel and its output against ``precision="exact"`` on the card within
   the fast bands of 4b; report (not gate) the direct 3×512 r = 24
   truncation's fast error; time fast and exact; then
   ``bench.timing.time_all_impls`` with impls "auto", "pallas" (K1 for the
   dense model, K4 for the reduced one) and "hybrid", exact and fast, on
   4×30 r = 15 and 3×512 r = 24, and check that K4 ran in both modes;
   then print the reduced/full ratios of phases 4 and 4c (3×512 merged r =
   24 and 4×30 split r = 15, exact and fast) beside the card's name and
   power limit;
5. check the train kernels against their plain versions on the card at the
   training path's shapes (K7 at 4×40, B = 32; K9 on a 512-unit layer and on
   the first layer, d = 16, B = 128; T = 200): h and c within 1e-4 or twice
   the plain float32 version's distance from the float64 one, whichever is
   larger (the cell state is unbounded and drifts by its ulps), every
   gradient within 1e-3 × its largest plain value (a weight gradient sums
   T·B products in another order), and time forward and backward. K7's
   forward is ``narrow_fwd_wave`` (the layers as a wavefront), its backward
   ``narrow_bwd_wave`` (the layers as a reverse wavefront, dx a layer of its
   own, z recomputed from the forward's h) and then ``weight_grad``, which
   reduces every layer's dz into dW, dU and db. K9's backward runs four
   phases (R: ``gemm_f32`` recomputes z over all T·B rows; C: the dh chain,
   ``wide_bwd_chain``, one persistent cooperative launch; X: dx; G: the
   weight gradients): each phase is timed alone beside its bound, and the
   kernels one call launches are listed at T and T/2 (as many either way,
   the chain kernel among them). K9's forward runs two parts (the x-side,
   ``gemm_f32`` over all T·B rows; the recurrence, ``wide_fwd_chain``, one
   persistent cooperative launch): each is timed alone beside its bound,
   and its launches are listed at T and T/2 the same way;
5b. the same for K6 (the recurrence-only train pair, K9's forward without
   the x-side and its backward without X) at run D's shapes (n = 512, B =
   128, T = 200);
6. drive the training path through the public entry points, on windows of
   the package's deterministic DROPBEAR surrogate: run A ``fit`` of a fresh
   4×40 stack (K7), run B ``finetune`` of σ under the Hoyer penalty on the
   factorized 4×30 checkpoint (K7 through the differentiable
   reconstruction), then ``make_reduced_model(cutoff=0.05)`` → ``predict``
   (K1), run C ``fit`` of the 3×512 checkpoint (K9 per layer), run D ``fit``
   of a fresh one-layer 512-unit stack (K6: one 128-aligned layer, not a
   uniform stack); check that each run launched its kernels, that every
   loss is finite, that the fine-tune froze the factors and moved σ, and the
   reduced output;
5c. the same for K8 (K7's two kernels with the weights staged in shared
   memory wherever the stack fits) at the recovery path's batch (B = 128,
   T = 200) on a fresh 4×40 stack and on the dense view of the 4×30 split r = 15
   truncation, timed beside K7 on the same inputs (K8, K7, K7, K8 in turn),
   and in turns with K7 at run A's inputs (B = 32) too; with ``--parent
   DIR``, K7 forward and backward at run A's shapes, K8's at B = 128, K9's
   at run C's (layer 1), K6's at run D's, cuDNN's on each, and one train
   step of runs A, B, E (narrow) and C, D, F (wide): its span, the host's
   time to issue it, the card's busy time from torch.profiler, in all and
   in the pair's forward and backward kernels; each measured in a fresh
   process on DIR's package and on this checkout's, in turns (P C C P C P P
   C: parent, change); in the same processes the inference side: K1 exact
   at 4×30 (the checkpoint) and 4×40 (run A's fresh stack) and K1f at 4×30
   over T = 6656, K5 on 3×512's layer 1 at B = 256, T = 128 alone and with
   its x-side product, K3 on 3×512's layer 0 over T = 6656 alone and with
   its x-side product and K3f alone, cuDNN's LSTM beside each (float32 and
   bf16 beside K3 and K3f), K2 and K2f on layer 0 of the direct merged r =
   24 truncation of 3×512 and of ``wide_r24_progressive``, with cuDNN's
   float32 and bf16 LSTM on the layer's exact dense reconstruction (with
   its x-side) beside them, K4 and K4f on the whole direct r = 24
   truncation, ``wide_r24_progressive`` and 4×30 split r = 15, cuDNN's
   float32 and bf16 LSTM on the stack's dense reconstruction beside them,
   batch-1 ``predict`` of 4×30 dense and split r =
   15 and of 3×512 dense and merged r = 24 (``wide_r24_progressive``;
   full_ms, reduced_ms), exact and fast, with their ratios, and batched
   fast ``predict`` on 3×512;
6. (continued) drive the post-truncation recovery through its public entry
   points, on the same windows: run E ``recover_reduced_gated`` of the 4×30
   split r = 15 truncation at B = 128 (K8 both ways), run F
   ``truncate_recover_progressive`` of the 3×512 checkpoint down ranks
   (32, 24), merged (K9 through the dense view); the launch counts are set
   to 0 just before these two runs and read just after. Each run's gate must
   be monotone (best validation MSE ≤ the raw truncation's), the final
   ranks held, and ``predict`` of the recovered model must launch K1 (E) or
   K2 (F) and agree with the CPU float64 scan as in 4. The gate validates on
   the first 2048 steps of the training half (its default, the whole half,
   runs the plain exact scan, which is launch-bound on the card);
7. hold each run against the same run with ``recurrence_kernel=False`` (the
   plain autograd scan): the first step's loss and gradients under the
   tolerances of 5, the loss histories within rtol 1e-3; time one train
   step of each. For E and F the first step is taken from the (first)
   truncation, every factor, bias and head gradient is held to 1e-3 × its
   largest plain value or twice the plain float32 gradient's distance from
   float64, whichever is larger (the truncations' C factors amplify the
   float32 sum order: ROADMAP fault 3.1), and the history is one epoch of
   ``finetune_reduced``;
8. drive the deployment slice, under exact matmuls, each part counted and
   checked: (8a) ``quantize_params`` on the card of ``wide_r24_progressive``
   (3×512 merged r = 24) and of the 4×30 checkpoint, their ``param_bytes``
   against a count of the tree's leaves and at most 0.35 × the float32
   bytes, ``quantized_apply(predict)`` over T = 6656 exact and fast (K2 and
   K2f, K1 and K1f launched, the launch counts set to 0 just before), exact
   against the CPU float64 scan of the dequantized model as in 4, the int8
   error against float32 reported, both predicts timed, and the tree saved
   and loaded back with ``q`` bit-equal; (8b) those two models and 4×30
   split r = 15 written from the card as CSVs and as the int8 ``.bin``, run
   by the native C++ runtime on the host over 2048 frames against the
   card's ``predict`` (of the float32 model, and of ``dequantized_params``
   for the ``.bin``) within 1e-4 on the first 256 frames
   (tests/test_native.py's limit), the maximum over all frames reported;
   (8c) ``make_stream_fn``'s CUDA-graph step on ``wide_r24_progressive``
   and 4×30 split r = 15 one frame at a time over 2048 frames against
   ``predict`` within 5e-4 (3's limit), against the eager ``stream_step``
   within 1e-6 (the same products in the same order), ``stream_many`` in
   chunks of 512 against the same run, and the per-frame wall clock (a host
   frame in, its host result out) of the graph step, the eager step and
   the native runtime, p50 and p99 over 2048 frames after 64, beside the
   500 µs frame period; (8d) ``python -m svd_lstm_tpu_torch export
   model_saves/wide_r24_progressive.npz DIR --int8`` and ``stream`` of
   ``DIR/model_int8.bin`` and of the checkpoint over 512 frames, each in a
   subprocess, against ``predict`` to the limits of 8b and 8c.

Beside each kernel the script times one PyTorch library call that computes
the same function (cuDNN ``torch.nn.LSTM``, TF32 off for the float32 ones;
for K2, K2f, K4 and K4f on the reduced layer's or stack's exact dense
reconstruction; the port never calls it) as the kernel's yardstick,
``library_ms``, and
computes the kernel's bound: the larger of its operations over the H100's
peak (67 TFLOP/s float32 on the CUDA cores, 989 TFLOP/s bf16) and its bytes
(each input read once, each output written once) over 3.35 TB/s.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if __name__ == "__main__" and sys.argv[1:2] == ["--time-tree"]:
    # tree_times on another checkout's package (see tree_turns): import it first
    sys.path.insert(0, os.path.abspath(sys.argv[2]))

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.api import exact_matmul
from svd_lstm_tpu_torch.bench.devtime import device_time_ms
from svd_lstm_tpu_torch.bench.timing import time_all_impls, time_full_vs_reduced
from svd_lstm_tpu_torch.data import preprocess_raw, split_train_random, synthetic_dropbear_raw
from svd_lstm_tpu_torch.models.lstm import scan_recurrence
from svd_lstm_tpu_torch.models.reduced import bf16_round, folded_projection, reduced_projection
from svd_lstm_tpu_torch.ops import _build
from svd_lstm_tpu_torch.ops import cuda_batched as cb
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.reduced_train import reduced_dense_view
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
COMPACT_B = 128     # K8 and runs E, F: the batch from which the dispatch takes K8
GATE_STEPS = 2048   # runs E, F: the gate validates on this many steps of the training half
BATCH_B, BATCH_T = 256, 128  # batched inference: the JAX package's throughput point
FAST_BAND = {"wide": 2e-2, "narrow": 3e-2}  # rel. Frobenius error vs exact (tests/test_pallas_batched.py)
PLAIN_REPEATS = 2   # timed calls of a slow plain version in 3c (already warm from its check)
WINDOWS = 64        # 3c: windows a fast variant is checked over, spread over T
WINDOW_T = 16       # steps of a K2f window, restarted from the plain version's (h, c)
K4_WINDOW_T = 8     # steps of a K4 fast window, from zero state
WINDOW_SHARE = 0.75  # least share of the windows within 2 bf16 ulps (see check_windows)
IMPL_REPEATS = 3    # timed calls per model and impl in 4c (the JAX harness's default)
EXACT_NAMES = ("fused_dense_stack", "reduced_recurrence", "lstm_recurrence")
FAST_NAMES = ("fused_dense_stack_fast", "reduced_recurrence_fast", "lstm_recurrence_fast")
K4_NAMES = ("fused_reduced_stack", "fused_reduced_stack_fast")
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
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


# ---------------------------------------------------------------------------
# bounds and library yardsticks
# ---------------------------------------------------------------------------

def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested lists and tuples allowed)."""
    total = 0
    for t in tensors:
        total += nbytes(*t) if isinstance(t, (list, tuple)) else t.numel() * t.element_size()
    return total


def bound(flops: float, moved: int, dtype=torch.float32) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes (each input read once, each
    output written once) over the memory rate. The gate nonlinearities are
    left out of the operations: a few per output element against the
    hundreds to thousands of multiply-adds of each step's products."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def lstm_flops(T: int, B: int, layers) -> int:
    """Multiply-adds ×2 of a forward over T steps of B rows through layers
    given as (input width, units): z = x·W + h·U. A backward does three
    times as much (the recomputed z, the products into dh and dx, and the
    weight-gradient sums)."""
    return sum(2 * T * B * (din + n) * 4 * n for din, n in layers)


def stack_shape(model, d: int):
    out, din = [], d
    for l in model.layers:
        out.append((din, l.units))
        din = l.units
    return out


def cudnn_lstm(layers, dev, dtype=torch.float32) -> torch.nn.LSTM:
    """cuDNN's LSTM holding the layers' (W, U, b): weight_ih = Wᵀ, weight_hh =
    Uᵀ, bias_ih = b, bias_hh = 0 (its gate order i, f, g, o is the Keras
    order of the port). Every layer must have the same width."""
    d, n = layers[0][0].shape[0], layers[0][1].shape[0]
    lstm = torch.nn.LSTM(d, n, num_layers=len(layers)).to(dev, dtype)
    with torch.no_grad():
        for i, (W, U, b) in enumerate(layers):
            getattr(lstm, f"weight_ih_l{i}").copy_(W.t())
            getattr(lstm, f"weight_hh_l{i}").copy_(U.t())
            getattr(lstm, f"bias_ih_l{i}").copy_(b)
            getattr(lstm, f"bias_hh_l{i}").zero_()
    lstm.flatten_parameters()
    return lstm


@contextlib.contextmanager
def cudnn_exact():
    """cuDNN's float32 RNNs default to TF32 (not exact mode): off inside."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def library_forward(name: str, layers, x: torch.Tensor, want: torch.Tensor, head=None) -> float:
    """Time of one cuDNN LSTM forward (x time-major) with the layers'
    weights; logs its distance from the port's h (or, with ``head``, from
    its read-out), a check of the weight mapping, for information."""
    lstm = cudnn_lstm(layers, x.device, x.dtype)
    with cudnn_exact(), torch.no_grad():
        out = lstm(x)[0]
        out = out if head is None else head(out)
        log(f"[info] {name}: cuDNN LSTM vs the port, max abs diff {max_err(out.float(), want.float()):.3e}")
        return device_time_ms(lambda: lstm(x))


def library_train(layers, x: torch.Tensor, dh: torch.Tensor) -> tuple:
    """Times of one cuDNN LSTM forward with autograd on, and of its backward
    from dh (every gradient: weights and input), float32 with TF32 off."""
    lstm = cudnn_lstm(layers, x.device)
    x = x.detach().requires_grad_(True)
    with cudnn_exact(), torch.enable_grad():
        fwd_ms = device_time_ms(lambda: lstm(x))
        out = lstm(x)[0]
        bwd_ms = device_time_ms(lambda: torch.autograd.backward(out, dh, retain_graph=True))
    return fwd_ms, bwd_ms


def reduced_library_ms(model, x: torch.Tensor, dtype, layers: int = 1) -> float:
    """cuDNN's LSTM (TF32 off) on the first ``layers`` layers of a reduced
    model's exact dense reconstruction, with the x-side product: one
    PyTorch call computing the function of K2 (one layer from xp) or K4 (the
    stack; its head left out), the yardstick of both."""
    dense = P.reconstruct_dense_model(model)
    lstm = cudnn_lstm([(l.W, l.U, l.b) for l in dense.layers[:layers]], x.device, dtype)
    xs = x[:, None].to(dtype)
    with cudnn_exact():
        return device_time_ms(lambda: lstm(xs))


def report(name: str, r: dict) -> None:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
    log(f"[time] {name} ({r['shape']}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
        f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


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
    """Phase 3: every batch-1 kernel against its plain version at main-path
    shapes, timed beside its bound and its library yardstick."""
    results = {}
    Tx, d = x.shape

    # K1: 4x30 dense, and its split r=15 truncation reconstructed to dense
    m30 = P.load_params(DENSE_30, device=dev)
    for units in ((30,) * 4, (40,) * 4, (512,) * 3):
        log(f"[info] K1 route {'x'.join(map(str, units))}, d={d}: exact "
            f"{ck.dense_plan(units, d, False)}, fast {ck.dense_plan(units, d, True)}")
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    err = 0.0
    for name, m in (("4x30 dense", m30), ("4x30 split r=15 reconstructed", P.reconstruct_dense_model(red30))):
        err = max(err, check_close(f"K1 fused_dense_stack {name}", ck.fused_dense_stack(m, x),
                                   ck.fused_dense_stack_plain(m, x), TOL))
    results["fused_dense_stack"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.fused_dense_stack, m30, x),
        "plain_ms": device_time_ms(ck.fused_dense_stack_plain, m30, x),
        # cuDNN runs the stack without the head (one (T, 30)·(30, 1) product)
        "library_ms": library_forward("K1 4x30", [(l.W, l.U, l.b) for l in m30.layers], x[:, None],
                                      ck.fused_dense_stack(m30, x)[:, None], m30.head),
        **bound(lstm_flops(Tx, 1, stack_shape(m30, d)) + 2 * Tx * 30,
                nbytes(x, [p for p in m30.parameters()]) + 4 * Tx),
        "shape": "4x30, T=6656, d=16",
    }

    # K3: each layer of the 3x512 dense checkpoint
    m512 = P.load_params(DENSE_512, device=dev)
    log(f"[info] K3 plan, n = 512: exact {ck.card_recurrence_plan(dev, 512, False)}, "
        f"fast {ck.card_recurrence_plan(dev, 512, True)}")
    runs = layer_runs(m512, x, lambda l, h: torch.matmul(h, l.W), ck.lstm_recurrence_plain)
    err = max(check_close(f"K3 lstm_recurrence 3x512 layer {i}", ck.lstm_recurrence(xp, l.U), h, TOL)
              for i, (l, xp, h) in enumerate(runs))
    l0, xp0, h0 = runs[0]
    n = l0.units
    with_x = device_time_ms(lambda: ck.lstm_recurrence((torch.matmul(x, l0.W) + l0.b).contiguous(), l0.U))
    log(f"[time] K3 with its x-side product (what cuDNN computes): {with_x:.3f} ms")
    results["lstm_recurrence"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.lstm_recurrence, xp0, l0.U),
        "plain_ms": device_time_ms(ck.lstm_recurrence_plain, xp0, l0.U),
        # cuDNN also computes the x-side product x·W + b (d = 16)
        "library_ms": library_forward("K3 512", [(l0.W, l0.U, l0.b)], x[:, None], h0[:, None]),
        **bound(lstm_flops(Tx, 1, [(0, n)]), nbytes(xp0, l0.U, h0)),
        "shape": "one 512-unit layer, T=6656",
    }

    # K2: merged r=24 checkpoint, the direct merged r=24 truncation of 3x512
    # (|C| ~ 1.1e4, ROADMAP fault 3.1) and its split r=24 truncation
    wide = P.load_params(WIDE_R24, device=dev)
    direct = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=False), rank=24)
    proj = lambda l, h: reduced_projection(l, h, "w")
    err = 0.0
    timed = None
    for name, m in (("merged r=24 (wide_r24_progressive)", wide), ("direct merged r=24 (3x512)", direct),
                    ("split r=24 (3x512)", red512)):
        l0 = m.layers[0]
        for fast in (False, True):
            plan = ck.card_reduced_plan(dev, l0.units, ck.reduced_ranks(recurrence_args(l0)[0]), fast)
            log(f"[info] K2 plan, {name}, {'fast' if fast else 'exact'}: {plan} (a CTA's weights "
                f"{plan.weight_bytes} B)")
        for i, (l, xp, h) in enumerate(layer_runs(m, x, proj, ck.reduced_recurrence_plain)):
            args = (xp, *recurrence_args(l))
            err = max(err, check_close(f"K2 reduced_recurrence {name} layer {i}",
                                       ck.reduced_recurrence(*args), h, TOL))
            timed = timed or (args, h)
    args, h = timed
    r = args[1].shape[1]
    results["reduced_recurrence"] = {
        "max_abs_err": err,
        "ms": device_time_ms(ck.reduced_recurrence, *args),
        "plain_ms": device_time_ms(ck.reduced_recurrence_plain, *args),
        # cuDNN on the layer's exact dense reconstruction, with its x-side product
        "library_ms": reduced_library_ms(wide, x, torch.float32),
        **bound(2 * Tx * (n * r + r * (4 * n - r)), nbytes(*args, h)),
        "shape": "one 512-unit layer, merged r=24, T=6656",
    }
    for name, r in results.items():
        report(name, r)
    return results


def batched_layer_inputs(model, x):
    """Per layer of a batched fast forward: (layer, xp (T, B, 4n) bf16, the
    plain K5 h). Each layer's xp comes from the plain h of the layer below,
    as ops/cuda_batched.batched_forward_fast computes it."""
    out, h = [], x.transpose(0, 1).to(torch.bfloat16)
    for l in model.layers:
        xp = (torch.matmul(h, l.W.to(torch.bfloat16)) + l.b.to(torch.bfloat16)).contiguous()
        h = cb.batched_lstm_recurrence_plain(xp, l.U)
        out.append((l, xp, h))
    return out


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def check_k5(name: str, got, xp, U, plain) -> float:
    """K5's h against the plain version: within 2 bf16 ulps of max |h| (the
    output's own rounding) or twice the plain version's distance from the
    same recurrence run with float64 state, whichever is larger — a float32
    sum order that flips one bf16 rounding of h carries on through the
    later steps, as the float32 drift does in check_state."""
    drift = max_err(plain.double(), cb.batched_lstm_recurrence_plain(xp.double(), U.double()))
    ulps = 2 * bf16_ulp(float(plain.float().abs().max()))
    log(f"[info] {name}: 2 bf16 ulps of max |h| {ulps:.3e}, plain vs float64 state {drift:.3e}")
    return check_close(name, got.float(), plain.float(), max(ulps, 2 * drift))


def batched_kernel_checks(dev) -> dict:
    """Phase 3b: K5 against its plain version on every layer of the 3x512 and
    the 4x30 checkpoints at B = 256, T = 128, timed on a 512-wide layer."""
    xb = torch.tensor(np.random.default_rng(2).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    err, timed = 0.0, None
    for name, path in (("3x512", DENSE_512), ("4x30", DENSE_30)):
        for i, (l, xp, h) in enumerate(batched_layer_inputs(P.load_params(path, device=dev), xb)):
            err = max(err, check_k5(f"K5 batched_lstm_recurrence {name} layer {i}",
                                    cb.batched_lstm_recurrence(xp, l.U), xp, l.U, h))
            if name == "3x512" and i == 1:
                timed = (l, xp, h)
    for n in (512, 30):
        plan = cb._card_plan(dev, BATCH_B, n, True)
        log(f"[info] K5 at n={n}, B={BATCH_B}: {plan}, {plan.chunks(BATCH_B)} launch(es) a call")
    l, xp, h = timed  # layer 1 of 3x512: a 512-wide input, as layers 1 and 2 have
    h_in = batched_layer_inputs(P.load_params(DENSE_512, device=dev), xb)[0][2]  # layer 0's h
    n, W16, b16 = l.units, l.W.to(torch.bfloat16), l.b.to(torch.bfloat16)
    with_x = device_time_ms(lambda: cb.batched_lstm_recurrence(torch.matmul(h_in, W16) + b16, l.U))
    log(f"[time] K5 with its x-side product (what cuDNN computes): {with_x:.3f} ms")
    r = {
        "max_abs_err": err,
        "ms": device_time_ms(cb.batched_lstm_recurrence, xp, l.U),
        "plain_ms": device_time_ms(cb.batched_lstm_recurrence_plain, xp, l.U),
        # cuDNN's bf16 LSTM also computes the x-side product h_in·W + b
        "library_ms": library_forward("K5 512 bf16", [(l.W, l.U, l.b)], h_in, h),
        **bound(lstm_flops(BATCH_T, BATCH_B, [(0, n)]), nbytes(xp, l.U, h), torch.bfloat16),
        "shape": f"one 512-unit layer, B={BATCH_B}, T={BATCH_T}, bf16 xp",
    }
    log(f"[time] batched_lstm_recurrence ({r['shape']}): kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")
    return {"batched_lstm_recurrence": r}


def fast_limit(name: str, plain: torch.Tensor, plain64: torch.Tensor) -> float:
    """K5's limit for a fast variant: 2 bf16 ulps of the plain fast
    version's largest value, or twice its distance from the same arithmetic
    with float64 state, whichever is larger (a float32 sum order that flips
    one bf16 rounding of h carries on through the later steps)."""
    drift = max_err(plain.double(), plain64)
    ulps = 2 * bf16_ulp(float(plain.abs().max()))
    log(f"[info] {name}: 2 bf16 ulps of the largest value {ulps:.3e}, plain vs float64 state "
        f"{drift:.3e}")
    return max(ulps, 2 * drift)


def as_double(model):
    return copy.deepcopy(model).double()


def bf16_bytes(*tensors) -> int:
    """Bytes of the tensors stored as bf16 (the fast variants' weights)."""
    return nbytes(*tensors) // 2


def reduced_flops(T: int, model, d: int) -> int:
    """Multiply-adds ×2 of the folded two-step products of both sides over
    T steps: per side v·B and (v·B)·C, per gate when split (the identity
    part of [I|C] and the zero blocks of a packed split layer are no work)."""
    total, din = 0, d
    for l in model.layers:
        for Bs, Cs, rows in ((l.wB, l.wC, din), (l.uB, l.uC, l.units)):
            pairs = zip(Bs, Cs) if l.split else ((Bs, Cs),)
            total += sum(rows * B.shape[1] + C.numel() for B, C in pairs)
        din = l.units
    return 2 * T * total


def window_starts(T: int, steps: int) -> list:
    """WINDOWS start steps spread evenly over a sequence of T steps."""
    return sorted({int(t) for t in np.linspace(0, T - steps, WINDOWS)})


def plain_states(xp, rec, starts):
    """The plain fast recurrence z_t = xp_t + rec(h) over the whole xp
    (T, 4n), run in segments that end at ``starts`` (the same steps as one
    run): (h_seq (T, n), {t: (h, c) before step t})."""
    h = c = None
    h_seq, states, prev = torch.empty_like(xp[:, : xp.shape[1] // 4]), {}, 0
    for t in [*starts, xp.shape[0]]:
        if t > prev:
            seq, (h, c) = scan_recurrence(xp[None, prev:t], rec, h, c)
            h_seq[prev:t] = seq[0]
            prev = t
        if h is None:
            h = c = torch.zeros((1, h_seq.shape[1]), dtype=xp.dtype, device=xp.device)
        states[t] = (h, c)
    return h_seq, states


def check_windows(name: str, errs, drifts, ulps: float) -> float:
    """A fast variant against its plain fast version over short windows
    (each started from the plain version's state, or from zero state): the
    median window within TOL, a float32 sum order; at least WINDOW_SHARE of
    the windows within 2 bf16 ulps of the largest value. A float32 sum order
    that flips one bf16 rounding of h (or of h·B, x·B) carries on through the
    rest of a window, and on the ill-conditioned factors such a flip can
    reach far more than 2 ulps; ``drifts``, the plain version's distance
    from float64 state over the same windows, shows how often that happens
    without the kernel. Returns the largest window's error."""
    errs, drifts = np.asarray(errs), np.asarray(drifts)
    med, share = float(np.median(errs)), float(np.mean(errs <= ulps))
    log(f"[check] {name}: {len(errs)} windows, median max abs diff {med:.3e} (tol {TOL:g}), "
        f"share within 2 bf16 ulps ({ulps:.3e}) {share:.3f} (at least {WINDOW_SHARE}), largest "
        f"{errs.max():.3e}; plain vs float64 state: median {np.median(drifts):.3e}, share within "
        f"{np.mean(drifts <= ulps):.3f}")
    if not bool(np.isfinite(errs).all()) or not med <= TOL or not share >= WINDOW_SHARE:
        fail(f"{name}: the kernel disagrees with its plain version")
    return float(errs.max())


def check_finite(name: str, got: torch.Tensor, plain: torch.Tensor) -> None:
    """A fast variant's whole run: finite, of the plain version's shape. Its
    distance from the plain run is logged, not gated: over T = 6656 steps
    the flipped bf16 roundings of check_windows carry the two runs apart."""
    if got.shape != plain.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: bad output {tuple(got.shape)}")
    log(f"[info] {name}, whole run: max abs diff from the plain version {max_err(got, plain):.3e}")


def fast_kernel_checks(dev, x) -> dict:
    """Phase 3c: the fast variants K1f–K3f and K4 (exact and fast) against
    their plain versions at main-path widths, timed beside their bounds."""
    results = {}
    Tx, d = x.shape
    fast = "default"
    plain_ms = lambda fn, *a: device_time_ms(fn, *a, warmup=0, repeats=PLAIN_REPEATS)

    # K1f: the 4x30 checkpoint
    m30 = P.load_params(DENSE_30, device=dev)
    plain = ck.fused_dense_stack_plain(m30, x, fast)
    limit = fast_limit("K1f 4x30", plain, ck.fused_dense_stack_plain(as_double(m30), x.double(), fast))
    got = ck.fused_dense_stack(m30, x, dot_precision=fast)
    results["fused_dense_stack_fast"] = {
        "max_abs_err": check_close("K1f fused_dense_stack fast 4x30 dense", got, plain, limit),
        "ms": device_time_ms(lambda: ck.fused_dense_stack(m30, x, dot_precision=fast)),
        "plain_ms": plain_ms(lambda: ck.fused_dense_stack_plain(m30, x, fast)),
        "library_ms": library_forward("K1f 4x30 bf16", [(l.W, l.U, l.b) for l in m30.layers],
                                      x[:, None].bfloat16(), got[:, None],
                                      lambda o: m30.head(o.float())),
        **bound(lstm_flops(Tx, 1, stack_shape(m30, d)) + 2 * Tx * 30,
                nbytes(x, [(l.b,) for l in m30.layers], list(m30.head.parameters())) + 4 * Tx
                + bf16_bytes([(l.W, l.U) for l in m30.layers]), torch.bfloat16),
        "shape": "4x30, T=6656, d=16, bf16 operands",
    }

    # K3f: each layer of 3x512, from the fast x-side of the fast layer below
    m512 = P.load_params(DENSE_512, device=dev)
    proj = lambda l, h: torch.matmul(bf16_round(h), bf16_round(l.W))
    rec = lambda xp, U: ck.lstm_recurrence_plain(xp, U, dot_precision=fast)
    runs = layer_runs(m512, x, proj, rec)
    err = 0.0
    for i, (l, xp, h) in enumerate(runs):
        limit = fast_limit(f"K3f 3x512 layer {i}", h, rec(xp.double(), l.U.double()))
        err = max(err, check_close(f"K3f lstm_recurrence fast 3x512 layer {i}",
                                   ck.lstm_recurrence(xp, l.U, dot_precision=fast), h, limit))
    l0, xp0, h0 = runs[0]
    n = l0.units
    results["lstm_recurrence_fast"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.lstm_recurrence(xp0, l0.U, dot_precision=fast)),
        "plain_ms": plain_ms(rec, xp0, l0.U),
        # cuDNN's bf16 LSTM also computes the x-side product x·W + b (d = 16)
        "library_ms": library_forward("K3f 512 bf16", [(l0.W, l0.U, l0.b)], x[:, None].bfloat16(),
                                      h0[:, None]),
        **bound(lstm_flops(Tx, 1, [(0, n)]), nbytes(xp0, h0) + bf16_bytes(l0.U), torch.bfloat16),
        "shape": "one 512-unit layer, T=6656, bf16 operands",
    }

    # K2f: each layer of wide_r24_progressive (merged r=24) and of 4x30 split
    # r=15, over WINDOWS windows of WINDOW_T steps, each restarted from the
    # plain version's (h, c); each layer's xp from the plain h of the layer below
    wide = P.load_params(WIDE_R24, device=dev)
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    starts = window_starts(Tx, WINDOW_T)
    err, timed = 0.0, None
    for name, m in (("merged r=24 (wide_r24_progressive)", wide), ("4x30 split r=15", red30)):
        h = x
        for i, l in enumerate(m.layers):
            xp = (reduced_projection(l, h, "w", bf16=True) + l.b).contiguous()
            uB, uC = recurrence_args(l)
            uB64, uC64 = double([uB, uC])
            h, states = plain_states(xp, folded_projection(uB, uC, True), starts)
            errs, drifts = [], []
            for t in starts:
                hc, cc = states[t]
                xw = xp[t : t + WINDOW_T]
                plain = ck.reduced_recurrence_plain(xw, uB, uC, hc, cc, fast)
                got = ck.reduced_recurrence(xw, uB, uC, hc, cc, dot_precision=fast)
                plain64 = ck.reduced_recurrence_plain(xw.double(), uB64, uC64, hc.double(),
                                                      cc.double(), fast)
                errs.append(max_err(got, plain))
                drifts.append(max_err(plain.double(), plain64))
            label = f"K2f reduced_recurrence fast {name} layer {i}"
            err = max(err, check_windows(label, errs, drifts, 2 * bf16_ulp(float(h.abs().max()))))
            check_finite(label, ck.reduced_recurrence(xp, uB, uC, dot_precision=fast), h)
            timed = timed or ((xp, uB, uC), h)
    args, h = timed
    r = args[1].shape[1]
    results["reduced_recurrence_fast"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.reduced_recurrence(*args, dot_precision=fast)),
        "plain_ms": plain_ms(lambda: ck.reduced_recurrence_plain(*args, dot_precision=fast)),
        # cuDNN's bf16 LSTM on the layer's exact dense reconstruction, with its x-side
        "library_ms": reduced_library_ms(wide, x, torch.bfloat16),
        **bound(2 * Tx * (n * r + r * (4 * n - r)), nbytes(args[0], h) + bf16_bytes(args[1:]),
                torch.bfloat16),
        "shape": "one 512-unit layer, merged r=24, T=6656, bf16 operands",
    }

    # K4 exact over the whole run: 4x30 split r=15 and the direct 3x512 merged
    # r=24 truncation (|C| ~ 1.1e4, ROADMAP fault 3.1)
    red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    err = 0.0
    for name, m in (("4x30 split r=15", red30), ("3x512 merged r=24", red512)):
        log(f"[info] K4 plan, {name}: exact {ck.card_reduced_stack_plan(dev, m, d, False)}, "
            f"fast {ck.card_reduced_stack_plan(dev, m, d, True)}")
        plain = ck.fused_reduced_stack_plain(m, x)
        drift = max_err(plain.double(), ck.fused_reduced_stack_plain(as_double(m), x.double()))
        log(f"[info] K4 {name} exact: plain float32 vs float64 {drift:.3e}")
        err = max(err, check_close(f"K4 fused_reduced_stack exact {name}",
                                   ck.fused_reduced_stack(m, x), plain, max(TOL, 2 * drift)))
    k4_30 = {
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(red30, x)),
        "library_ms": reduced_library_ms(red30, x, torch.float32, len(red30.layers)),
        **bound(reduced_flops(Tx, red30, d) + 2 * Tx * 30, nbytes(x, list(red30.parameters())) + 4 * Tx),
    }
    log(f"[time] K4 exact 4x30 split r=15: kernel {k4_30['ms']:.3f} ms, library (cuDNN on the dense "
        f"reconstruction) {k4_30['library_ms']:.3f} ms, bound {k4_30['bound_ms']:.4f} ms "
        f"({k4_30['bound_by']})")
    results["fused_reduced_stack"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(red512, x)),
        "plain_ms": plain_ms(lambda: ck.fused_reduced_stack_plain(red512, x)),
        # cuDNN on the stack's exact dense reconstruction (the head left out)
        "library_ms": reduced_library_ms(red512, x, torch.float32, len(red512.layers)),
        **bound(reduced_flops(Tx, red512, d) + 2 * Tx * n,
                nbytes(x, list(red512.parameters())) + 4 * Tx),
        "shape": "3x512 merged r=24 (direct truncation), T=6656, d=16",
    }

    # K4 fast over WINDOWS windows of K4_WINDOW_T steps of x, each from zero
    # state (the kernel takes no initial state): 4x30 split r=15 and
    # wide_r24_progressive (3x512 merged r=24 after recovery, |C| <= 199; the
    # direct truncation's bf16 operands flip apart within a few steps)
    err = 0.0
    for name, m in (("4x30 split r=15", red30), ("3x512 merged r=24 (wide_r24_progressive)", wide)):
        m64 = as_double(m)
        errs, drifts, largest = [], [], 0.0
        for t in window_starts(Tx, K4_WINDOW_T):
            xw = x[t : t + K4_WINDOW_T]
            plain = ck.fused_reduced_stack_plain(m, xw, fast)
            errs.append(max_err(ck.fused_reduced_stack(m, xw, dot_precision=fast), plain))
            drifts.append(max_err(plain.double(), ck.fused_reduced_stack_plain(m64, xw.double(), fast)))
            largest = max(largest, float(plain.abs().max()))
        label = f"K4 fused_reduced_stack fast {name}"
        err = max(err, check_windows(label, errs, drifts, 2 * bf16_ulp(largest)))
        got = ck.fused_reduced_stack(m, x, dot_precision=fast)
        check_finite(label, got, ck.fused_reduced_stack_plain(m, x, fast))
    k4f_30 = {
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(red30, x, dot_precision=fast)),
        "library_ms": reduced_library_ms(red30, x, torch.bfloat16, len(red30.layers)),
        **bound(reduced_flops(Tx, red30, d) + 2 * Tx * 30,
                nbytes(x, [l.b for l in red30.layers], list(red30.head.parameters())) + 4 * Tx
                + bf16_bytes([p for l in red30.layers for p in (*l.wB, *l.wC, *l.uB, *l.uC)]),
                torch.bfloat16),
    }
    log(f"[time] K4 fast 4x30 split r=15: kernel {k4f_30['ms']:.3f} ms, library (cuDNN bf16 on the "
        f"dense reconstruction) {k4f_30['library_ms']:.3f} ms, bound {k4f_30['bound_ms']:.4f} ms "
        f"({k4f_30['bound_by']})")
    results["fused_reduced_stack_fast"] = {
        "max_abs_err": err,
        "ms": device_time_ms(lambda: ck.fused_reduced_stack(wide, x, dot_precision=fast)),
        "plain_ms": plain_ms(lambda: ck.fused_reduced_stack_plain(wide, x, fast)),
        # cuDNN's bf16 LSTM on the stack's exact dense reconstruction (the head left out)
        "library_ms": reduced_library_ms(wide, x, torch.bfloat16, len(wide.layers)),
        **bound(reduced_flops(Tx, wide, d) + 2 * Tx * n,
                nbytes(x, [l.b for l in wide.layers], list(wide.head.parameters())) + 4 * Tx
                + bf16_bytes([p for l in wide.layers for p in (l.wB, l.wC, l.uB, l.uC)]),
                torch.bfloat16),
        "shape": "3x512 merged r=24 (wide_r24_progressive), T=6656, d=16, bf16 operands",
    }
    for name, r in results.items():
        report(name, r)
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
    points, counted, checked and timed. Returns the launches and each
    model's reduced / full time ratio."""
    configs = (
        ("3x512 merged r=24", DENSE_512, True, 24),
        ("4x30 split r=15", DENSE_30, False, 15),
    )
    ck.reset_launch_counts()
    runs = []
    for name, path, merged, rank in configs:
        dense = P.load_params(path, device=dev)
        k3 = ck.LAUNCHES["lstm_recurrence"]
        y_full = P.predict(dense, x)
        if path == DENSE_512 and ck.LAUNCHES["lstm_recurrence"] - k3 != len(dense.layers):
            fail(f"{name}: dense predict launched K3 {ck.LAUNCHES['lstm_recurrence'] - k3} times, "
                 f"not once a layer")
        reduced = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)
        y_red = P.predict(reduced, x)
        runs.append((name, path, merged, rank, dense, reduced, y_full, y_red))
    torch.cuda.synchronize()
    launches = {k: ck.LAUNCHES[k] for k in EXACT_NAMES}
    log(f"[main] kernel launches during the main path: {launches}")
    for k, v in launches.items():
        if v < 1:
            fail(f"kernel {k} was not launched on the main path")

    x_cpu = x[:REF_STEPS].cpu()
    ratios = {}
    for name, path, merged, rank, dense, reduced, y_full, y_red in runs:
        # The same surgery on the CPU. The reference is its float64 plain
        # scan; the tolerance is twice the float32 error of the same impl on
        # the CPU (plain versions), floored at REF_TOL: a reduced model with
        # large C factors is ill-conditioned in float32 whatever the device.
        dense_cpu = P.load_params(path, device="cpu")
        red_cpu = P.make_reduced_model(P.make_singular_model(dense_cpu, merged_kernel=merged), rank=rank)
        for label, y, m in (("dense", y_full, dense_cpu), ("reduced", y_red, red_cpu)):
            check_vs_cpu_reference(f"{name} {label}", y, m, x_cpu)
        timing = time_full_vs_reduced(dense, reduced, x)
        ratios[f"{name} exact"] = timing.ratio
        err = P.rmse(y_full.cpu().numpy(), y_red.cpu().numpy())
        log(f"[main] {name}: full_ms {timing.full_ms:.3f}  reduced_ms {timing.reduced_ms:.3f}  "
            f"ratio {timing.ratio:.4f}  rmse(reduced vs dense) {err:.6f}  "
            f"weights {weights(dense)} -> {weights(reduced)}")
        if merged:
            scan_ms = device_time_ms(lambda: P.predict(dense, x, impl="scan"))
            log(f"[main] {name}: dense impl='scan' {scan_ms:.3f} ms")
    return launches, ratios


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative Frobenius error, in float64."""
    return float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))


def batched_path(dev) -> dict:
    """Phase 4b: batched inference through predict(precision=...) at B = 256,
    T = 128, counted, checked against exact mode on the card, and timed."""
    xb = torch.tensor(np.random.default_rng(3).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    configs = (  # name, checkpoint, precision, band
        ("3x512 dense", DENSE_512, "fast", "wide"),
        ("wide_r24_progressive (reduced, to dense)", WIDE_R24, "fast", "wide"),
        ("4x30 dense", DENSE_30, "fast", "narrow"),
        ("3x512 dense", DENSE_512, "high", "wide"),
    )
    models = {path: P.load_params(path, device=dev) for path in (DENSE_512, WIDE_R24, DENSE_30)}
    for k in cb.KERNELS:
        k.launches = 0
    outs = [P.predict(models[path], xb, precision=prec) for _, path, prec, _ in configs]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in cb.KERNELS}
    log(f"[batched] kernel launches during the batched path: {launches}")
    for k, v in launches.items():
        if v < 1:
            fail(f"kernel {k} was not launched on the batched path")

    for (name, path, prec, band), y in zip(configs, outs):
        m = models[path]
        exact = P.predict(m, xb)
        if tuple(y.shape) != (BATCH_B, BATCH_T, 1) or not bool(torch.isfinite(y).all()):
            fail(f"batched {prec} {name}: bad output {tuple(y.shape)}")
        rel = rel_err(y, exact)
        log(f"[check] batched {prec} {name} vs exact: rel Frobenius {rel:.3e}, max abs "
            f"{max_err(y, exact):.3e} (band {FAST_BAND[band]:g})")
        if not rel <= FAST_BAND[band]:
            fail(f"batched {prec} {name}: rel error {rel:.3e} above {FAST_BAND[band]:g}")
        times = {p: device_time_ms(lambda p=p: P.predict(m, xb, precision=p))
                 for p in dict.fromkeys((prec, "exact"))}
        log(f"[batched] {name} B={BATCH_B} T={BATCH_T}: "
            + ", ".join(f"{p} {t:.3f} ms" for p, t in times.items()))
    return launches


def fast_path(dev, x) -> tuple:
    """Phase 4c: batch-1 predict(precision="fast") through the public entry
    points, counted, checked against exact mode on the card and timed; then
    the timing harness over its impls, which reaches K4 through "pallas".
    Returns the launches and the fast reduced / full time ratios."""
    m512, m30 = P.load_params(DENSE_512, device=dev), P.load_params(DENSE_30, device=dev)
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    red512 = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    configs = (  # name, model, band (None: reported, not gated), the kernel it must launch
        ("3x512 dense", m512, "wide", "lstm_recurrence_fast"),
        ("wide_r24_progressive", P.load_params(WIDE_R24, device=dev), "wide", "reduced_recurrence_fast"),
        ("4x30 dense", m30, "narrow", "fused_dense_stack_fast"),
        ("4x30 split r=15", red30, "narrow", "fused_dense_stack_fast"),
        ("3x512 direct merged r=24", red512, None, "reduced_recurrence_fast"),
    )
    ck.reset_launch_counts()
    outs = []
    for name, m, _, kernel in configs:
        before = ck.LAUNCHES[kernel]
        outs.append(P.predict(m, x, precision="fast"))
        torch.cuda.synchronize()
        if ck.LAUNCHES[kernel] == before:
            fail(f"batch-1 fast {name}: {kernel} was not launched")
    launches = {k: ck.LAUNCHES[k] for k in FAST_NAMES}
    log(f"[fast] kernel launches during the batch-1 fast path: {launches}")

    times = {}
    for (name, m, band, _), y in zip(configs, outs):
        if tuple(y.shape) != (T, 1) or not bool(torch.isfinite(y).all()):
            fail(f"batch-1 fast {name}: bad output {tuple(y.shape)}")
        exact = P.predict(m, x)
        rel = rel_err(y, exact)
        limit = "reported, not gated (ROADMAP fault 3.1)" if band is None else f"band {FAST_BAND[band]:g}"
        log(f"[check] batch-1 fast {name} vs exact: rel Frobenius {rel:.3e}, max abs "
            f"{max_err(y, exact):.3e} ({limit})")
        if band is not None and not rel <= FAST_BAND[band]:
            fail(f"batch-1 fast {name}: rel error {rel:.3e} above {FAST_BAND[band]:g}")
        times[name] = {p: device_time_ms(lambda p=p: P.predict(m, x, precision=p))
                       for p in ("fast", "exact")}
        log(f"[fast] {name} T={T}: fast {times[name]['fast']:.3f} ms, exact "
            f"{times[name]['exact']:.3f} ms")
    ratios = {}
    for full, red, key in (("3x512 dense", "3x512 direct merged r=24", "3x512 merged r=24"),
                           ("4x30 dense", "4x30 split r=15", "4x30 split r=15")):
        ratios[f"{key} fast"] = times[red]["fast"] / times[full]["fast"]
        log(f"[fast] reduced/full fast ratio, {red}: {ratios[key + ' fast']:.4f}")

    for name, dense, reduced in (("4x30 split r=15", m30, red30), ("3x512 merged r=24", m512, red512)):
        for precision in ("exact", "fast"):
            for impl, r in time_all_impls(dense, reduced, x, impls=("auto", "pallas", "hybrid"),
                                          repeats=IMPL_REPEATS, precision=precision).items():
                log(f"[timing] {name} {precision} impl={impl!r}: full {r.full_ms:.3f} ms "
                    f"({r.full_us_per_step:.3f} us/step), reduced {r.reduced_ms:.3f} ms "
                    f"({r.reduced_us_per_step:.3f} us/step), ratio {r.ratio:.4f}")
    torch.cuda.synchronize()
    launches.update({k: ck.LAUNCHES[k] for k in K4_NAMES})
    log(f"[timing] K4 launches through impl='pallas': {launches}")
    for k in K4_NAMES:
        if launches[k] < 1:
            fail(f"kernel {k} was not launched by the timing harness")
    return launches, ratios


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
    TrainRun("D 1x512 fit",
             lambda dev: P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=D,
                                             units=(512,), device=dev),
             P.TrainConfig(batch_size=128, window_len=TRAIN_T, recurrence_kernel=True,
                           num_windows=256, epochs=1),
             (ct.lstm_recurrence_train_fwd, ct.lstm_recurrence_train_bwd)),
)


def truncation(path: str, merged: bool, rank: int, dev):
    """A checkpoint factorized and truncated to ``rank``."""
    dense = P.load_params(path, device=dev)
    return P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)


@dataclasses.dataclass(frozen=True)
class RecoveryRun(TrainRun):
    """A post-truncation recovery: ``make`` gives the first stage's
    truncation of ``path``; one rank runs ``recover_reduced_gated`` on it,
    several run ``truncate_recover_progressive`` from the checkpoint."""

    path: str = ""
    merged: bool = False
    ranks: tuple = ()
    max_epochs: int = 1
    predict_kernel: str = ""  # the batch-1 kernel that predict runs the recovered model through


def recovery_run(name, path, merged, ranks, max_epochs, kernels, predict_kernel) -> RecoveryRun:
    return RecoveryRun(
        name, lambda dev: truncation(path, merged, ranks[0], dev),
        P.TrainConfig(batch_size=COMPACT_B, window_len=TRAIN_T, recurrence_kernel=True,
                      num_windows=256, epochs=1),
        kernels, path=path, merged=merged, ranks=ranks, max_epochs=max_epochs,
        predict_kernel=predict_kernel,
    )


RECOVERY_RUNS = (
    recovery_run("E 4x30 split r=15 gated recovery", DENSE_30, False, (15,), 2,
                 (ct.fused_narrow_train_compact_fwd, ct.fused_narrow_train_compact_bwd),
                 "fused_dense_stack"),
    recovery_run("F 3x512 merged progressive r=32 -> 24", DENSE_512, True, (32, 24), 1,
                 (ct.wide_layer_fwd, ct.wide_layer_bwd), "reduced_recurrence"),
)


def train_data():
    """The package's deterministic DROPBEAR surrogate, preprocessed."""
    return preprocess_raw(synthetic_dropbear_raw(duration=12.0), P.DataConfig(split_time=8.0))


def train(run: TrainRun, model, data, kernel: bool):
    """Runs A–D as phase 6 trains them; for E and F one epoch of
    ``finetune_reduced`` from the truncation (their loss history in 7)."""
    cfg = dataclasses.replace(run.cfg, recurrence_kernel=kernel)
    if isinstance(run, RecoveryRun):
        return P.finetune_reduced(model, data.X_train, data.y_train, cfg)
    if run.factor_cfg is None:
        return P.fit(model, data.X_train, data.y_train, cfg)
    return P.finetune(model, data.X_train, data.y_train, run.factor_cfg, cfg)


def recover(run: RecoveryRun, data, dev):
    """Run E or F through its public entry point. Returns (model, infos)."""
    X, y = data.X_train, data.y_train
    gate = dict(max_epochs=run.max_epochs, validation=(X[:, :GATE_STEPS], y[:GATE_STEPS]))
    if len(run.ranks) == 1:
        model, info = P.recover_reduced_gated(run.make(dev), X, y, train_cfg=run.cfg, **gate)
        return model, [info]
    return P.truncate_recover_progressive(P.load_params(run.path, device=dev), X, y, ranks=run.ranks,
                                          train_cfg=run.cfg, merged_kernel=run.merged, **gate)


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


def time_pair(name: str, shape: str, kernel, plain, *args, library_ms=None, **bounds) -> dict:
    r = {"ms": device_time_ms(kernel, *args), "plain_ms": device_time_ms(plain, *args),
         "library_ms": library_ms, **bounds, "shape": shape}
    extra = ""
    if bounds:
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        extra = f", library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
    log(f"[time] {name} ({shape}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{extra}")
    return r


def entry_launches(fn) -> list:
    """The C entry points one call of ``fn`` launched through the train
    wrappers (``cuda_train._launch``), in order; each of the wide backward's
    (wide_gemm, wide_bwd_chain, sum_splits) launches one kernel, and its
    launcher reports a launch the card refused. Counted on the host, since
    torch.profiler's device trace can drop kernels (a call once listed 1 of
    its 5)."""
    names = []
    launch = ct._launch

    def counted(name, device, *args):
        names.append(name)
        launch(name, device, *args)

    ct._launch = counted
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        ct._launch = launch
    return names


def wide_bwd_phases(name: str, x, W, U, b, h, c, dh) -> None:
    """K9's backward (W given) or K6's (W None, x the projection xp) by
    phase, each alone beside its bound: R (z), C (the dh chain), X (dx, K9),
    G (the weight gradients); then the kernels one wrapper call launches at
    T and at T/2: as many either way, the chain kernel among them."""
    T, B, n = h.shape
    G, M = 4 * n, T * B
    din = 0 if W is None else x.shape[2]
    sms = ct.sm_count(x.device)
    plan = ct.chain_plan(B, n, sms)
    z = ct.phase_r(x, W, U, b, h)
    dz = torch.empty_like(z)
    Ut = U.t().contiguous()
    ct.phase_c(z, Ut, c, dh, dz, plan)
    phases = [("R", lambda: ct.phase_r(x, W, U, b, h), 2 * M * (din + n) * G,
               nbytes(x, h, U, z) + (0 if W is None else nbytes(W, b))),
              ("C", lambda: ct.phase_c(z, Ut, c, dh, dz, plan), 2 * (T - 1) * B * G * n,
               nbytes(z, U, c, dh, dz))]
    if W is None:
        phases.append(("G", lambda: ct.phase_g(None, h, dz, sms), 2 * M * G * n, nbytes(dz, h, U)))
    else:
        phases += [("X", lambda: ct.phase_x(dz, W), 2 * M * G * din, nbytes(dz, W, x)),
                   ("G", lambda: ct.phase_g(x, h, dz, sms), 2 * M * G * (din + n + 1),
                    nbytes(dz, x, h, W, U, b))]
    for phase, fn, flops, moved in phases:
        ms = device_time_ms(fn)
        r = bound(flops, moved)
        log(f"[phase] {name} {phase}: {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"[phase] {name} chain: {plan}")
    del z, dz

    def call(steps):
        part = [t[:steps].contiguous() for t in (x, h, c, dh)]
        if W is None:
            return ct.lstm_recurrence_train_bwd(part[0], U, *part[1:])
        return ct.wide_layer_bwd(part[0], W, U, b, *part[1:])

    launches_at_two_lengths(name, call, T, "wide_bwd_chain", "one copy of U's transpose")


def launches_at_two_lengths(name: str, call, T: int, chain: str, extra: str) -> None:
    """The kernels one wrapper call launches at T and at T/2 steps
    (``call(steps)``): as many either way, the chain kernel among them."""
    counts = {}
    for steps in (T, T // 2):
        names = entry_launches(lambda: call(steps))
        counts[steps] = len(names)
        log(f"[launches] {name} at T={steps}: {len(names)} kernels and {extra}: " + ", ".join(names))
        if chain not in names:
            fail(f"{name}: the chain kernel did not run")
    if counts[T] != counts[T // 2]:
        fail(f"{name}: launches grow with T: {counts}")


def wide_fwd_phases(name: str, x, W, U, b) -> None:
    """K9's forward (W given) or K6's (W None, x the projection xp) by part,
    each alone beside its bound: the x-side GEMM (K9) and the chain; then
    the kernels one wrapper call launches at T and at T/2: as many either
    way, the chain kernel among them."""
    T, B, din = x.shape
    n = U.shape[0]
    G, M = 4 * n, T * B
    plan = ct.fwd_chain_plan(B, n, ct.sm_count(x.device))
    xz = x if W is None else ct.phase_x_side(x, W, b)
    Ui = ct.pack_gates_interleaved(U)
    h = torch.empty((T, B, n), dtype=torch.float32, device=x.device)
    c = torch.empty_like(h)
    parts = [] if W is None else [("x-side", lambda: ct.phase_x_side(x, W, b), 2 * M * din * G,
                                   nbytes(x, W, b, xz))]
    parts.append(("chain", lambda: ct.phase_chain_fwd(xz, Ui, h, c, plan), 2 * (T - 1) * B * n * G,
                  nbytes(xz, U, h, c)))
    for part, fn, flops, moved in parts:
        ms = device_time_ms(fn)
        r = bound(flops, moved)
        log(f"[phase] {name} {part}: {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"[phase] {name} chain: {plan}")

    def call(steps):
        part = x[:steps].contiguous()
        if W is None:
            return ct.lstm_recurrence_train_fwd(part, U)
        return ct.wide_layer_fwd(part, W, U, b)

    launches_at_two_lengths(name, call, T, "wide_fwd_chain", "one packing of U")


@torch.no_grad()
def train_kernel_checks(dev, data) -> dict:
    """Phases 5 and 5b: K7, K9 and K6 against their plain versions at the
    training path's shapes, timed beside their bounds and cuDNN's LSTM
    forward and backward (which also compute the x-side products where the
    kernel does not: K6)."""
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
    T7, B7, d7 = x.shape
    flops = lstm_flops(T7, B7, [(W.shape[0], U.shape[0]) for W, U, _ in layers])
    lib_fwd, lib_bwd = library_train(layers, x, dh)
    results["fused_narrow_train_fwd"] = {
        "max_abs_err": err,
        **time_pair("K7 fwd", shape, ct.fused_narrow_train_fwd, ct.fused_narrow_train_fwd_plain, layers, x,
                    library_ms=lib_fwd, **bound(flops, nbytes(layers, x, hs, cs))),
    }
    args = (layers, x, hs_p, cs_p, dh)
    got, want = ct.fused_narrow_train_bwd(*args), ct.fused_narrow_train_bwd_plain(*args)
    err = max(check_grad(f"K7 bwd 4x40 {k}{i}", a, r)
              for k, gs, ws in zip(("dW", "dU", "db"), got[:3], want[:3])
              for i, (a, r) in enumerate(zip(gs, ws)))
    err = max(err, check_grad("K7 bwd 4x40 dx", got[3], want[3]))
    results["fused_narrow_train_bwd"] = {
        "max_abs_err": err,
        **time_pair("K7 bwd", shape, ct.fused_narrow_train_bwd, ct.fused_narrow_train_bwd_plain, *args,
                    library_ms=lib_bwd, **bound(3 * flops, nbytes(args, got))),
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
    T9, B9, d9 = args[0].shape
    flops = lstm_flops(T9, B9, [(d9, args[2].shape[0])])
    lib_fwd, lib_bwd = library_train([args[1:4]], args[0], dh)
    results["wide_layer_fwd"] = {
        "max_abs_err": fwd_err,
        **time_pair("K9 fwd", shape, ct.wide_layer_fwd, ct.wide_layer_fwd_plain, *args[:4],
                    library_ms=lib_fwd, **bound(flops, nbytes(args[:6]))),
    }
    results["wide_layer_bwd"] = {
        "max_abs_err": bwd_err,
        **time_pair("K9 bwd", shape, ct.wide_layer_bwd, ct.wide_layer_bwd_plain, *args,
                    library_ms=lib_bwd, **bound(3 * flops, nbytes(args, got))),
    }
    wide_fwd_phases("K9 fwd", *args[:4])
    wide_bwd_phases("K9 bwd", *args)
    time_pair("K9 fwd+bwd", shape,
              lambda: ct.wide_layer_bwd(*args[:4], *ct.wide_layer_fwd(*args[:4]), dh),
              lambda: ct.wide_layer_bwd_plain(*args[:4], *ct.wide_layer_fwd_plain(*args[:4]), dh))
    results.update(recurrence_train_checks(dev, data, rng))
    results.update(compact_kernel_checks(dev, data, rng))
    return results


def recurrence_train_checks(dev, data, rng) -> dict:
    """Phase 5b: K6 at run D's shapes (one 512-unit layer, d = 16, B = 128,
    T = 200), from the xp its fresh model gives its first batch."""
    run = TRAIN_RUNS[3]
    l = run.make(dev).layers[0]
    W, U, b = (p.detach() for p in (l.W, l.U, l.b))
    x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()  # (T, B, d)
    xp = (torch.matmul(x, W) + b).contiguous()
    h_p, c_p = ct.lstm_recurrence_train_fwd_plain(xp, U)
    h64, c64 = ct.lstm_recurrence_train_fwd_plain(xp.double(), U.double())
    h, c = ct.lstm_recurrence_train_fwd(xp, U)
    fwd_err = max(check_state("K6 fwd h", h, h_p, h64), check_state("K6 fwd c", c, c_p, c64))
    dh = torch.tensor(rng.normal(size=h_p.shape), dtype=torch.float32, device=dev)
    args = (xp, U, h_p, c_p, dh)
    got, want = ct.lstm_recurrence_train_bwd(*args), ct.lstm_recurrence_train_bwd_plain(*args)
    bwd_err = max(check_grad(f"K6 bwd {k}", a, r) for k, a, r in zip(("dxp", "dU"), got, want))
    shape = "one 512-unit layer, B=128, T=200, xp from d=16"
    T6, B6, _ = xp.shape
    flops = lstm_flops(T6, B6, [(0, U.shape[0])])
    lib_fwd, lib_bwd = library_train([(W, U, b)], x, dh)
    results = {
        "lstm_recurrence_train_fwd": {
            "max_abs_err": fwd_err,
            **time_pair("K6 fwd", shape, ct.lstm_recurrence_train_fwd, ct.lstm_recurrence_train_fwd_plain,
                        xp, U, library_ms=lib_fwd, **bound(flops, nbytes(xp, U, h, c))),
        },
        "lstm_recurrence_train_bwd": {
            "max_abs_err": bwd_err,
            **time_pair("K6 bwd", shape, ct.lstm_recurrence_train_bwd, ct.lstm_recurrence_train_bwd_plain,
                        *args, library_ms=lib_bwd, **bound(3 * flops, nbytes(args, got))),
        },
    }
    wide_fwd_phases("K6 fwd", xp, None, U, None)
    wide_bwd_phases("K6 bwd", xp, None, U, None, h_p, c_p, dh)
    time_pair("K6 fwd+bwd", shape,
              lambda: ct.lstm_recurrence_train_bwd(xp, U, *ct.lstm_recurrence_train_fwd(xp, U), dh),
              lambda: ct.lstm_recurrence_train_bwd_plain(xp, U, *ct.lstm_recurrence_train_fwd_plain(xp, U), dh))

    def fwd_with_x():
        return ct.lstm_recurrence_train_fwd((torch.matmul(x, W) + b).contiguous(), U)

    def bwd_with_x():
        dxp, dU = ct.lstm_recurrence_train_bwd(*args)
        return torch.matmul(dxp, W.t()), torch.einsum("tbd,tbg->dg", x, dxp), dxp.sum(dim=(0, 1)), dU

    log(f"[time] K6 with its x-side products (what cuDNN computes): forward "
        f"{device_time_ms(fwd_with_x):.3f} ms, backward {device_time_ms(bwd_with_x):.3f} ms")
    return results


def in_turns(name: str, shape: str, a, b, *args) -> None:
    """Two kernels on the same inputs timed in turns (a, b, b, a) in one
    call: the card and its neighbours change between calls."""
    ms = [device_time_ms(f, *args) for f in (a, b, b, a)]
    log(f"[time] {name} ({shape}), in turns: {ms[0]:.3f}, {ms[1]:.3f}, {ms[2]:.3f}, {ms[3]:.3f} ms")


def compact_kernel_checks(dev, data, rng) -> dict:
    """Phase 5c: K8 against its plain version at the recovery path's batch
    (B = 128, T = 200, d = 16) on a fresh 4x40 stack (run A's) and on the
    dense view of run E's 4x30 split r=15 truncation; timed on 4x40 beside
    its plain version, cuDNN's LSTM and, in turns, K7 on the same inputs."""
    x = first_batch(RECOVERY_RUNS[0], data, dev)[0].transpose(0, 1).contiguous()  # (T, B, d)
    cases = (
        ("4x40", [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in TRAIN_RUNS[0].make(dev).layers]),
        ("4x30 split r=15 dense view",
         [tuple(p.detach() for p in l) for l in reduced_dense_view(RECOVERY_RUNS[0].make(dev)).layers]),
    )
    fwd_err = bwd_err = 0.0
    for name, layers in cases:
        hs_p, cs_p = ct.fused_narrow_train_compact_fwd_plain(layers, x)
        hs64, cs64 = ct.fused_narrow_train_compact_fwd_plain(double(layers), x.double())
        hs, cs = ct.fused_narrow_train_compact_fwd(layers, x)
        fwd_err = max(fwd_err, *(check_state(f"K8 fwd {name} {k}{i}", a, r, r64)
                                 for k, got, want, want64 in (("h", hs, hs_p, hs64), ("c", cs, cs_p, cs64))
                                 for i, (a, r, r64) in enumerate(zip(got, want, want64))))
        dh = torch.tensor(rng.normal(size=hs_p[-1].shape), dtype=torch.float32, device=dev)
        args = (layers, x, hs_p, cs_p, dh)
        got, want = ct.fused_narrow_train_compact_bwd(*args), ct.fused_narrow_train_compact_bwd_plain(*args)
        bwd_err = max(bwd_err, *(check_grad(f"K8 bwd {name} {k}{i}", a, r)
                                 for k, gs, ws in zip(("dW", "dU", "db"), got[:3], want[:3])
                                 for i, (a, r) in enumerate(zip(gs, ws))),
                      check_grad(f"K8 bwd {name} dx", got[3], want[3]))
        shape = f"{name}, B={x.shape[1]}, T={x.shape[0]}, d={x.shape[2]}"
        in_turns("K8 fwd, K7 fwd", shape, ct.fused_narrow_train_compact_fwd, ct.fused_narrow_train_fwd,
                 layers, x)
        in_turns("K8 bwd, K7 bwd", shape, ct.fused_narrow_train_compact_bwd, ct.fused_narrow_train_bwd,
                 *args)
        if name == "4x40":
            timed = (shape, layers, hs, cs, args, got)
    # below the dispatch's B = 128: K8 and K7 on run A's inputs (B = 32)
    xa = first_batch(TRAIN_RUNS[0], data, dev)[0].transpose(0, 1).contiguous()
    layers = timed[1]
    hs_a, cs_a = ct.fused_narrow_train_fwd_plain(layers, xa)
    dh_a = torch.tensor(rng.normal(size=hs_a[-1].shape), dtype=torch.float32, device=dev)
    shape_a = f"4x40, B={xa.shape[1]}, T={xa.shape[0]}, d={xa.shape[2]}"
    in_turns("K8 fwd, K7 fwd", shape_a, ct.fused_narrow_train_compact_fwd, ct.fused_narrow_train_fwd,
             layers, xa)
    in_turns("K8 bwd, K7 bwd", shape_a, ct.fused_narrow_train_compact_bwd, ct.fused_narrow_train_bwd,
             layers, xa, hs_a, cs_a, dh_a)
    shape, layers, hs, cs, args, got = timed
    T8, B8, _ = x.shape
    flops = lstm_flops(T8, B8, [(W.shape[0], U.shape[0]) for W, U, _ in layers])
    lib_fwd, lib_bwd = library_train(layers, x, args[-1])
    results = {
        "fused_narrow_train_compact_fwd": {
            "max_abs_err": fwd_err,
            **time_pair("K8 fwd", shape, ct.fused_narrow_train_compact_fwd,
                        ct.fused_narrow_train_compact_fwd_plain, layers, x,
                        library_ms=lib_fwd, **bound(flops, nbytes(layers, x, hs, cs))),
        },
        "fused_narrow_train_compact_bwd": {
            "max_abs_err": bwd_err,
            **time_pair("K8 bwd", shape, ct.fused_narrow_train_compact_bwd,
                        ct.fused_narrow_train_compact_bwd_plain, *args,
                        library_ms=lib_bwd, **bound(3 * flops, nbytes(args, got))),
        },
    }
    dh = args[-1]
    time_pair("K8 fwd+bwd", shape,
              lambda: ct.fused_narrow_train_compact_bwd(layers, x, *ct.fused_narrow_train_compact_fwd(layers, x), dh),
              lambda: ct.fused_narrow_train_compact_bwd_plain(
                  layers, x, *ct.fused_narrow_train_compact_fwd_plain(layers, x), dh))
    return results


@torch.no_grad()
def narrow_times(dev, data) -> dict:
    """K7's pair at run A's shapes, K8's at B = 128 (4x40), cuDNN's LSTM on
    both: ms of each, in the package this process imported."""
    rng = np.random.default_rng(1)
    layers = [tuple(p.detach() for p in (l.W, l.U, l.b)) for l in TRAIN_RUNS[0].make(dev).layers]
    out = {}
    for tag, run, fwd, bwd in (("K7", TRAIN_RUNS[0], ct.fused_narrow_train_fwd, ct.fused_narrow_train_bwd),
                               ("K8", RECOVERY_RUNS[0], ct.fused_narrow_train_compact_fwd,
                                ct.fused_narrow_train_compact_bwd)):
        x = first_batch(run, data, dev)[0].transpose(0, 1).contiguous()
        hs, cs = fwd(layers, x)
        dh = torch.tensor(rng.normal(size=hs[-1].shape), dtype=torch.float32, device=dev)
        shape = f"B={x.shape[1]}"
        out[f"{tag} fwd ({shape})"] = device_time_ms(fwd, layers, x)
        out[f"{tag} bwd ({shape})"] = device_time_ms(bwd, layers, x, hs, cs, dh)
        out[f"cuDNN fwd ({shape})"], out[f"cuDNN bwd ({shape})"] = library_train(layers, x, dh)
    return out


NARROW_PARTS = {"narrow fwd": ("narrow_fwd",), "narrow bwd": ("narrow_bwd",)}
# the wide pair's kernels in this checkout and in the parent's (the parent's
# forward: a wide_fwd_step a step; this checkout's forward chain, its x-side
# GEMM counted with the backward's gemm_f32)
WIDE_PARTS = {"wide fwd": ("wide_fwd_step", "wide_fwd_chain"),
              "wide bwd": ("gemm_f32", "wide_bwd_chain", "wide_bwd_gates", "matmul_nt",
                           "weight_grad", "sum_splits")}


def step_split(step, parts: dict) -> dict:
    """A train step's host time to issue it (the card idle at its start;
    median of 5) and what it ran on the card (torch.profiler, mean of 3
    steps): the summed duration of its kernels and copies, and of the
    kernels whose names hold one of ``parts``' strings; ms each."""
    issue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        issue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    def busy(names=("",)) -> float:
        return sum(e.time_range.elapsed_us() for e in on_card if any(nm in e.name for nm in names)) / 3e3

    return {"host issue": sorted(issue)[2], "card busy": busy(),
            **{f"card busy in the {part}": busy(names) for part, names in parts.items()}}


@torch.no_grad()
def wide_times(dev, data) -> dict:
    """K9's pair at run C's shapes (the 3x512 checkpoint's layer 1, x its
    layer 0's h) and K6's at run D's (a fresh 512-unit layer's xp), cuDNN's
    LSTM on both: ms of each, in the package this process imported."""
    rng = np.random.default_rng(1)
    out = {}
    model = TRAIN_RUNS[2].make(dev)
    x = first_batch(TRAIN_RUNS[2], data, dev)[0].transpose(0, 1).contiguous()
    l0, l1 = ([p.detach() for p in (l.W, l.U, l.b)] for l in model.layers[:2])
    x = ct.wide_layer_fwd(x, *l0)[0]
    W, U, b = l1
    h, c = ct.wide_layer_fwd(x, W, U, b)
    dh = torch.tensor(rng.normal(size=h.shape), dtype=torch.float32, device=dev)
    out["K9 fwd (run C layer 1)"] = device_time_ms(ct.wide_layer_fwd, x, W, U, b)
    out["K9 bwd (run C layer 1)"] = device_time_ms(ct.wide_layer_bwd, x, W, U, b, h, c, dh)
    out["cuDNN fwd (run C layer 1)"], out["cuDNN bwd (run C layer 1)"] = library_train([(W, U, b)], x, dh)
    l = TRAIN_RUNS[3].make(dev).layers[0]
    W, U, b = (p.detach() for p in (l.W, l.U, l.b))
    x = first_batch(TRAIN_RUNS[3], data, dev)[0].transpose(0, 1).contiguous()
    xp = (torch.matmul(x, W) + b).contiguous()
    h, c = ct.lstm_recurrence_train_fwd(xp, U)
    dh = torch.tensor(rng.normal(size=h.shape), dtype=torch.float32, device=dev)
    out["K6 fwd (run D)"] = device_time_ms(ct.lstm_recurrence_train_fwd, xp, U)
    out["K6 bwd (run D)"] = device_time_ms(ct.lstm_recurrence_train_bwd, xp, U, h, c, dh)
    out["cuDNN fwd (run D)"], out["cuDNN bwd (run D)"] = library_train([(W, U, b)], x, dh)
    return out


@torch.no_grad()
def inference_times(dev) -> dict:
    """K1 exact at 4x30 (the checkpoint) and 4x40 (run A's fresh stack) and
    K1f at 4x30 over T = 6656; K5 on 3x512's layer 1 at B = 256, T = 128,
    alone and with its x-side product; cuDNN's LSTM beside each (the whole
    stack, or the layer with its x-side, as in phases 3, 3b, 3c); batch-1
    predict of 4x30 dense and split r = 15; batched fast predict on 3x512;
    K3 on 3x512's layer 0 over T = 6656 alone and with its x-side product,
    K3f alone, cuDNN's float32 and bf16 LSTM (with the x-side) beside them;
    K2 and K2f on layer 0 of the direct r = 24 truncation and of
    ``wide_r24_progressive``, cuDNN beside them; K4 and K4f on the whole
    direct r = 24 truncation, ``wide_r24_progressive`` and 4x30 split r = 15,
    cuDNN's float32 and bf16 LSTM on the stack's dense reconstruction beside
    them; batch-1 predict of 3x512 dense (full_ms) and of merged r = 24
    (``wide_r24_progressive``, reduced_ms), exact and fast, with their
    ratio: ms of each, in the package this process imported."""
    out = {}
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    m30 = P.load_params(DENSE_30, device=dev)
    m40 = TRAIN_RUNS[0].make(dev)
    for name, m, dp in (("K1 4x30", m30, None), ("K1 4x40", m40, None), ("K1f 4x30", m30, "default")):
        out[name] = device_time_ms(lambda: ck.fused_dense_stack(m, x, dot_precision=dp))
        xs = x[:, None] if dp is None else x[:, None].bfloat16()
        lstm = cudnn_lstm([(l.W, l.U, l.b) for l in m.layers], dev, xs.dtype)
        with cudnn_exact():
            out[f"cuDNN beside {name}"] = device_time_ms(lambda: lstm(xs))
    m512 = P.load_params(DENSE_512, device=dev)
    xb = torch.tensor(np.random.default_rng(2).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    (_, _, h_in), (l, xp, _) = batched_layer_inputs(m512, xb)[:2]
    W16, b16 = l.W.to(torch.bfloat16), l.b.to(torch.bfloat16)
    out["K5 3x512 layer 1"] = device_time_ms(cb.batched_lstm_recurrence, xp, l.U)
    out["K5 3x512 layer 1 with its x-side"] = device_time_ms(
        lambda: cb.batched_lstm_recurrence(torch.matmul(h_in, W16) + b16, l.U))
    lstm = cudnn_lstm([(l.W, l.U, l.b)], dev, torch.bfloat16)
    out["cuDNN bf16 beside K5 (with its x-side)"] = device_time_ms(lambda: lstm(h_in))
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    for precision in ("exact", "fast"):
        timing = time_full_vs_reduced(m30, red30, x, precision=precision)
        tag = "" if precision == "exact" else " fast"
        out[f"predict 4x30 dense{tag} (full_ms)"] = timing.full_ms
        out[f"predict 4x30 split r=15{tag} (reduced_ms)"] = timing.reduced_ms
        out[f"ratio 4x30 split r=15 {precision} (reduced / full)"] = timing.ratio
    l0 = m512.layers[0]
    xp = (torch.matmul(x, l0.W) + l0.b).contiguous()
    out["K3 3x512 layer 0"] = device_time_ms(ck.lstm_recurrence, xp, l0.U)
    out["K3 3x512 layer 0 with its x-side"] = device_time_ms(
        lambda: ck.lstm_recurrence((torch.matmul(x, l0.W) + l0.b).contiguous(), l0.U))
    xpf = (torch.matmul(bf16_round(x), bf16_round(l0.W)) + l0.b).contiguous()
    out["K3f 3x512 layer 0"] = device_time_ms(
        lambda: ck.lstm_recurrence(xpf, l0.U, dot_precision="default"))
    for name, dtype in (("cuDNN beside K3 (with its x-side)", torch.float32),
                        ("cuDNN bf16 beside K3f (with its x-side)", torch.bfloat16)):
        lstm = cudnn_lstm([(l0.W, l0.U, l0.b)], dev, dtype)
        xs = x[:, None].to(dtype)
        with cudnn_exact():
            out[name] = device_time_ms(lambda: lstm(xs))
    wide = P.load_params(WIDE_R24, device=dev)
    direct = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    for mname, model in (("direct r=24", direct), ("wide_r24_progressive", wide)):
        l = model.layers[0]
        for kname, fast in (("K2", False), ("K2f", True)):
            xpr = (reduced_projection(l, x, "w", bf16=fast) + l.b).contiguous()
            dp = "default" if fast else None
            out[f"{kname} 3x512 {mname} layer 0"] = device_time_ms(
                lambda: ck.reduced_recurrence(xpr, l.uB, l.uC, dot_precision=dp))
    for name, dtype in (("cuDNN beside K2 (dense reconstruction, with its x-side)", torch.float32),
                        ("cuDNN bf16 beside K2f (dense reconstruction, with its x-side)", torch.bfloat16)):
        out[name] = reduced_library_ms(wide, x, dtype)
    for kname, dp in (("K4", None), ("K4f", "default")):
        for mname, model in (("3x512 direct r=24", direct), ("3x512 wide_r24_progressive", wide),
                             ("4x30 split r=15", red30)):
            out[f"{kname} {mname}"] = device_time_ms(
                lambda: ck.fused_reduced_stack(model, x, dot_precision=dp))
    for mname, model in (("3x512 direct r=24", direct), ("4x30 split r=15", red30)):
        for name, dtype in (("cuDNN beside K4", torch.float32), ("cuDNN bf16 beside K4f", torch.bfloat16)):
            out[f"{name} {mname} (dense reconstruction)"] = reduced_library_ms(
                model, x, dtype, len(model.layers))
    for precision in ("exact", "fast"):
        timing = time_full_vs_reduced(m512, wide, x, precision=precision)
        out[f"predict 3x512 dense {precision} (full_ms)"] = timing.full_ms
        out[f"predict 3x512 merged r=24 {precision} (reduced_ms)"] = timing.reduced_ms
        out[f"ratio 3x512 merged r=24 {precision} (reduced / full)"] = timing.ratio
    xb3 = torch.tensor(np.random.default_rng(3).normal(size=(BATCH_B, BATCH_T, D)),
                       dtype=torch.float32, device=dev)
    out["batched fast predict 3x512"] = device_time_ms(lambda: P.predict(m512, xb3, precision="fast"))
    return out


def tree_times(dev) -> dict:
    """``--time-tree DIR``: inference_times, narrow_times, wide_times and
    one train step (forward, backward, Adam) of runs A, B, E (narrow) and C,
    D, F (wide), on DIR's package: the step's span on the card, the host's
    time to issue it and the card's busy time in it, in all and in the
    pair's kernels (step_split)."""
    data = train_data()
    with exact_matmul():
        out = inference_times(dev)
        out.update(narrow_times(dev, data))
        out.update(wide_times(dev, data))
    for run, parts in ((TRAIN_RUNS[0], NARROW_PARTS), (TRAIN_RUNS[1], NARROW_PARTS),
                       (RECOVERY_RUNS[0], NARROW_PARTS), (TRAIN_RUNS[2], WIDE_PARTS),
                       (TRAIN_RUNS[3], WIDE_PARTS), (RECOVERY_RUNS[1], WIDE_PARTS)):
        x, y = first_batch(run, data, dev)
        step = first_step(run, dev, x, y, kernel=True)[2]
        name = f"run {run.name.split()[0]} step"
        out[name] = device_time_ms(step)
        out.update({f"{name}, {k}": v for k, v in step_split(step, parts).items()})
    return out


def tree_turns(parent: str) -> None:
    """``--parent DIR``: tree_times on DIR's package and on this checkout's,
    each in a fresh process (their kernels built from their own sources),
    in turns, each side first in one pair of two: parent, change, change,
    parent, change, parent, parent, change."""
    here = os.path.dirname(os.path.abspath(__file__))
    order = (parent, here, here, parent, here, parent, parent, here)
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            fail(f"--time-tree {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    sides = "/".join("P" if tree == parent else "C" for tree in order)
    for key in runs[0]:
        ms = [r[key] for r in runs]
        p = np.median([m for m, tree in zip(ms, order) if tree == parent])
        c = np.median([m for m, tree in zip(ms, order) if tree != parent])
        unit = "" if key.startswith("ratio") else " (ms)"
        log(f"[turns] {key}{unit}, {sides} (P parent, C change): "
            + ", ".join(f"{m:.3f}" for m in ms) + f"; medians P {p:.3f}, C {c:.3f}")


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
    k1 = ck.LAUNCHES["fused_dense_stack"]
    y_red = P.predict(reduced, x)
    torch.cuda.synchronize()
    if ck.LAUNCHES["fused_dense_stack"] == k1:
        fail("run B: the reduced predict did not launch K1 (fused_dense_stack)")
    y_tuned = P.predict(tuned, x)
    check_vs_cpu_reference("run B reduced predict", y_red, copy.deepcopy(reduced).cpu(),
                           x[:REF_STEPS].cpu())
    y_true = data.y_test
    log(f"[train] run B: weights {weights(tuned)} -> {weights(reduced)} (cutoff 0.05); "
        f"RMSE vs the test targets: fine-tuned {P.rmse(y_tuned[:, 0].cpu().numpy(), y_true):.6f}, "
        f"reduced {P.rmse(y_red[:, 0].cpu().numpy(), y_true):.6f}")


def train_path(dev, data) -> tuple:
    """Phase 6: runs A to D through the public entry points, counted.
    Returns (launches, {run name: loss history})."""
    ck.reset_launch_counts()
    for k in ct.KERNELS:
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


def final_ranks(model) -> set:
    """Every recurrent-side rank of a reduced model (every gate); the input
    side of the first layer holds at most d = 16."""
    return {r for l in model.layers for r in l.ranks[1]}


def recovery_path(dev, data) -> dict:
    """Phase 6, runs E and F: the recovery through its public entry points,
    counted from zero just before and read just after. Returns the train
    kernels' launch counts of these runs."""
    ck.reset_launch_counts()
    for k in ct.KERNELS:
        k.launches = 0
    x = torch.tensor(data.X_test[0], device=dev)
    for run in RECOVERY_RUNS:
        before = {k.__name__: k.launches for k in ct.KERNELS}
        t0 = time.perf_counter()
        model, infos = recover(run, data, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {k.__name__: k.launches - before[k.__name__] for k in ct.KERNELS}
        log(f"[recover] run {run.name}: {wall:.2f} s wall, train kernel launches {delta}")
        for k in run.kernels:
            if delta[k.__name__] < 1:
                fail(f"run {run.name}: {k.__name__} was not launched")
        for r, info in zip(run.ranks, infos):
            log(f"[recover] run {run.name} rank {r}: raw val MSE {info['raw_val_mse']:.6e}, best "
                f"{info['best_val_mse']:.6e}, trace {info['trace']}")
            if not (np.isfinite(info["best_val_mse"]) and info["best_val_mse"] <= info["raw_val_mse"]):
                fail(f"run {run.name} rank {r}: the gate returned a model worse than the truncation")
        if final_ranks(model) != {run.ranks[-1]}:
            fail(f"run {run.name}: ranks {final_ranks(model)} after recovery, not {run.ranks[-1]}")
        k = ck.LAUNCHES[run.predict_kernel]
        y_pred = P.predict(model, x)
        torch.cuda.synchronize()
        if ck.LAUNCHES[run.predict_kernel] == k:
            fail(f"run {run.name}: predict did not launch {run.predict_kernel}")
        check_vs_cpu_reference(f"run {run.name} predict", y_pred, copy.deepcopy(model).cpu(),
                               x[:REF_STEPS].cpu())
        log(f"[recover] run {run.name}: RMSE of the recovered model vs the test targets "
            f"{P.rmse(y_pred[:, 0].cpu().numpy(), data.y_test):.6f}")
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ct.KERNELS}
    log(f"[recover] kernel launches during the recovery path: {launches}")
    return launches


def first_step(run: TrainRun, dev, x, y, kernel: bool, dtype=torch.float32):
    """The first train step of a run from its initial model (in ``dtype``:
    float64 for a plain reference). Returns (loss, {parameter: gradient},
    step), where step() runs one whole train step (forward, backward, Adam)
    on the same model, for timing."""
    model = run.make(dev).to(dtype)
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
    ``histories`` holds runs A–D's loss histories from phase 6; E's and F's
    are one epoch of ``finetune_reduced``, taken here."""
    for run in TRAIN_RUNS + RECOVERY_RUNS:
        x, y = first_batch(run, data, dev)
        loss_k, grads_k, step_k = first_step(run, dev, x, y, kernel=True)
        loss_p, grads_p, step_p = first_step(run, dev, x, y, kernel=False)
        tol = FWD_TOL * max(1.0, abs(loss_p))
        drifts = {}
        if isinstance(run, RecoveryRun):  # the drift of the plain float32 step from float64
            loss64, grads64, _ = first_step(run, dev, x.double(), y.double(), False, torch.float64)
            tol = max(tol, 2 * abs(loss_p - loss64))
            drifts = {name: 2 * max_err(g.double(), grads64[name]) for name, g in grads_p.items()}
        log(f"[check] run {run.name} first-step loss: kernel {loss_k:.8f}, plain {loss_p:.8f} "
            f"(tol {tol:g})")
        if not abs(loss_k - loss_p) <= tol:
            fail(f"run {run.name}: first-step loss differs by {abs(loss_k - loss_p):.3e}")
        for name, want in grads_p.items():
            check_close(f"run {run.name} first-step d{name}", grads_k[name], want,
                        max(GRAD_RTOL * float(want.abs().max()), drifts.get(name, 0.0)))
        if run.name not in histories:
            histories[run.name] = train(run, run.make(dev), data, kernel=True).history
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


# ---------------------------------------------------------------------------
# deployment (phase 8)
# ---------------------------------------------------------------------------

STREAM_FRAMES = 2048   # 8b, 8c: frames streamed one at a time
STREAM_CHUNK = 512     # 8c: stream_many's chunk; 8d: frames of the commands' input
STREAM_WARMUP = 64     # 8c: frames before the latency is taken
NATIVE_TOL = 1e-4      # native runtime vs the card's predict (tests/test_native.py)
GRAPH_TOL = 1e-6       # graph step vs the eager step: the same products in the same order
INT8_BYTES_MAX = 0.35  # int8 tree bytes / float32 bytes
FRAME_PERIOD_US = 16 * 500 / 16  # 16 samples a frame, one every 500/16 µs (config.py)


def int8_bytes(tree) -> int:
    """The int8 tree's bytes counted leaf by leaf: one a q entry, four a
    per-column scale, four a float32 entry (the 1-D leaves)."""
    # imported here: --time-tree runs this script on trees without the module
    from svd_lstm_tpu_torch.io.checkpoint import map_tree

    total = []
    map_tree(lambda t: total.append(t.q.numel() + 4 * t.scale.numel()
                                    if isinstance(t, P.QuantizedTensor) else 4 * t.numel()), tree)
    return sum(total)


def require_launched(name: str, before: dict, kernels) -> None:
    """Fail unless each wrapper in ``kernels`` launched since ``before``."""
    torch.cuda.synchronize()
    for k in kernels:
        if ck.LAUNCHES[k] == before[k]:
            fail(f"{name}: {k} was not launched")


def int8_path(dev, x) -> dict:
    """Phase 8a: the int8 trees of 3x512 merged r = 24 (wide_r24_progressive)
    and 4x30 dense, quantized on the card, through quantized_apply(predict),
    exact and fast, counted from zero; their bytes, error and time."""
    configs = (  # name, checkpoint, the exact and fast wrappers predict must launch
        ("3x512 merged r=24 (wide_r24_progressive)", WIDE_R24,
         ("reduced_recurrence", "reduced_recurrence_fast")),
        ("4x30 dense", DENSE_30, ("fused_dense_stack", "fused_dense_stack_fast")),
    )
    from svd_lstm_tpu_torch.io.checkpoint import map_tree

    qpredict = P.quantized_apply(P.predict)
    ck.reset_launch_counts()
    runs = []
    for name, path, kernels in configs:
        model = P.load_params(path, device=dev)
        q = P.quantize_params(model)
        before = dict(ck.LAUNCHES)
        y8 = qpredict(q, x)
        require_launched(f"int8 {name} exact", before, kernels[:1])
        before = dict(ck.LAUNCHES)
        y8_fast = qpredict(q, x, precision="fast")
        require_launched(f"int8 {name} fast", before, kernels[1:])
        runs.append((name, path, model, q, y8, y8_fast))
    torch.cuda.synchronize()
    launches = {k: ck.LAUNCHES[k] for k in (*EXACT_NAMES[:2], *FAST_NAMES[:2])}
    log(f"[int8] kernel launches during the int8 path: {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        for name, path, model, q, y8, y8_fast in runs:
            f32, i8, counted = P.param_bytes(model), P.param_bytes(q), int8_bytes(q)
            log(f"[int8] {name}: param_bytes float32 {f32}, int8 {i8} (counted {counted}), "
                f"ratio {i8 / f32:.4f} (limit {INT8_BYTES_MAX})")
            if i8 != counted or not i8 <= INT8_BYTES_MAX * f32:
                fail(f"int8 {name}: {i8} bytes, counted {counted}, float32 {f32}")
            if tuple(y8.shape) != (T, 1) or not bool(torch.isfinite(y8_fast).all()):
                fail(f"int8 {name}: bad output {tuple(y8.shape)}")
            dq_cpu = P.from_numpy_tree(P.to_numpy_tree(P.dequantize_params(q)), device="cpu")
            check_vs_cpu_reference(f"int8 {name} exact", y8, dq_cpu, x[:REF_STEPS].cpu())
            y32 = P.predict(model, x)
            log(f"[int8] {name}: int8 vs float32 predict: rel Frobenius {rel_err(y8, y32):.4e}, "
                f"RMSE {P.rmse(y32.cpu().numpy(), y8.cpu().numpy()):.4e}; fast vs exact int8 "
                f"rel Frobenius {rel_err(y8_fast, y8):.4e} (reported, not gated)")
            ms32 = device_time_ms(lambda: P.predict(model, x))
            ms8 = device_time_ms(lambda: qpredict(q, x))
            log(f"[int8] {name} T={T}: predict float32 {ms32:.3f} ms, int8 (dequantization "
                f"included) {ms8:.3f} ms on {card_line()}")
            qpath = os.path.join(tmp, "q.npz")
            P.save_params(qpath, q)
            back = P.load_params(qpath, device=dev)
            pairs, loaded = [], []
            map_tree(pairs.append, q)
            map_tree(loaded.append, back)
            for a, b in zip(pairs, loaded):
                a, b = (a.q, b.q) if isinstance(a, P.QuantizedTensor) else (a, b)
                if b.device.type != dev.type or not torch.equal(a, b):
                    fail(f"int8 {name}: the saved tree does not load back bit-equal on the card")
            log(f"[check] int8 {name}: saved and loaded back, q bit-equal ({len(pairs)} leaves)")
    return launches


def deploy_models(dev) -> dict:
    m30 = P.load_params(DENSE_30, device=dev)
    return {
        "3x512 merged r=24 (wide_r24_progressive)": P.load_params(WIDE_R24, device=dev),
        "4x30 split r=15": P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15),
        "4x30 dense": m30,
    }


def check_prefix(name: str, got: np.ndarray, want: torch.Tensor, tol: float) -> None:
    """got (N,) against want (N, 1) on the first REF_STEPS frames within tol;
    the max over all N reported."""
    want = want[:, 0].cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{name}: bad output {got.shape}")
    log(f"[check] {name}: max abs diff over {len(got)} frames {np.abs(got - want).max():.3e}")
    check_close(f"{name} first {REF_STEPS} frames", torch.tensor(got[:REF_STEPS]),
                torch.tensor(want[:REF_STEPS]), tol)


def export_path(dev, x, models: dict) -> None:
    """Phase 8b: each model written from the card as CSVs (per-gate for dense,
    two-step for reduced) and as the int8 .bin, run by the native runtime on
    the host over STREAM_FRAMES frames, against the card's predict."""
    from svd_lstm_tpu_torch.io import csv_weights, int8_export, native

    frames = x[:STREAM_FRAMES]
    frames_np = frames.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, model) in enumerate(models.items()):
            d = os.path.join(tmp, f"model{i}")
            if isinstance(model, P.ReducedLSTM):
                native.save_reduced_weights_as_csv(model, d)
            else:
                csv_weights.save_model_weights_as_csv(model, d)
            binpath = d + ".bin"
            nbytes = int8_export.save_model_int8_bin(model, binpath)
            t0 = time.perf_counter()
            y_csv = native.NativeModel.from_export_dir(d).run(frames_np)
            y_bin = native.NativeModel.from_int8(binpath).run(frames_np)
            host_s = time.perf_counter() - t0
            log(f"[native] {name}: int8 .bin {nbytes} bytes; both runs of {STREAM_FRAMES} "
                f"frames (load included) {host_s:.3f} s on the host")
            check_prefix(f"native CSV {name} vs card predict", y_csv, P.predict(model, frames),
                         NATIVE_TOL)
            dq = int8_export.dequantized_params(model)
            check_prefix(f"native int8 .bin {name} vs card predict of the artifact's model",
                         y_bin, P.predict(dq, frames), NATIVE_TOL)


def percentiles(name: str, lat_s: list) -> str:
    us = np.asarray(lat_s) * 1e6
    return f"{name} p50 {np.percentile(us, 50):.1f} us, p99 {np.percentile(us, 99):.1f} us"


def stream_latency(step, state, frames_np, dev) -> list:
    """Per-frame wall clock of ``step`` from a host frame to its host result,
    STREAM_WARMUP frames first, then STREAM_FRAMES."""
    lat = []
    for t in range(STREAM_WARMUP + len(frames_np)):
        frame = frames_np[t % len(frames_np)][None]
        t0 = time.perf_counter()
        y, state = step(state, torch.as_tensor(frame, device=dev))
        y = float(y[0, 0])
        if t >= STREAM_WARMUP:
            lat.append(time.perf_counter() - t0)
    return lat


def stream_path(dev, x, models: dict) -> None:
    """Phase 8c: make_stream_fn's graph step one frame at a time against
    predict, the eager stream_step and stream_many in chunks; then the
    per-frame latency of the graph step, the eager step and the native
    runtime."""
    from svd_lstm_tpu_torch.io import int8_export, native

    frames = x[:STREAM_FRAMES]
    frames_np = frames.cpu().numpy()
    for name in ("3x512 merged r=24 (wide_r24_progressive)", "4x30 split r=15"):
        model = models[name]
        fn, state0 = P.make_stream_fn(model)
        state, ys = state0, []
        for t in range(len(frames)):
            y, state = fn(state, frames[t : t + 1])
            ys.append(y)
        graph = torch.cat(ys)
        check_close(f"stream graph step {name} vs predict, {len(frames)} frames", graph,
                    P.predict(model, frames), TOL)
        state, ys = P.init_stream(model), []
        for t in range(len(frames)):
            y, state = P.stream_step(model, state, frames[t : t + 1])
            ys.append(y)
        eager = torch.cat(ys)
        check_close(f"stream graph step {name} vs eager stream_step", graph, eager, GRAPH_TOL)
        state, ys = P.init_stream(model), []
        for k in range(0, len(frames), STREAM_CHUNK):
            y, state = P.stream_many(model, state, frames[None, k : k + STREAM_CHUNK])
            ys.append(y[0])
        check_close(f"stream_many {name}, chunks of {STREAM_CHUNK}, vs eager stream_step",
                    torch.cat(ys), eager, GRAPH_TOL)

        lat_graph = stream_latency(fn, state0, frames_np, dev)
        lat_eager = stream_latency(lambda s, f: P.stream_step(model, s, f), P.init_stream(model),
                                   frames_np, dev)
        with tempfile.TemporaryDirectory() as tmp:
            binpath = os.path.join(tmp, "model_int8.bin")
            int8_export.save_model_int8_bin(model, binpath)
            nm = native.NativeModel.from_int8(binpath)
            for f in frames_np[:STREAM_WARMUP]:
                nm.step(f)
            lat_native = []
            for f in frames_np:
                t0 = time.perf_counter()
                nm.step(f)
                lat_native.append(time.perf_counter() - t0)
        log(f"[stream] {name}, per-frame wall clock over {len(frames_np)} frames after "
            f"{STREAM_WARMUP}: {percentiles('graph step', lat_graph)}; "
            f"{percentiles('eager stream_step', lat_eager)}; "
            f"{percentiles('native int8 (host)', lat_native)}; frame period "
            f"{FRAME_PERIOD_US:.0f} us; {card_line()}")


def command(*args) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch", *args], capture_output=True,
                         text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        fail(f"command {' '.join(args)} exited {out.returncode}: {out.stderr[-2000:]}")
    return out


def command_path(dev, x, models: dict) -> None:
    """Phase 8d: ``export ... --int8`` of wide_r24_progressive, then ``stream``
    of its .bin (native) and of the checkpoint (the card's graph step) over
    STREAM_CHUNK frames, each in a subprocess, against predict."""
    from svd_lstm_tpu_torch.io import int8_export

    name = "3x512 merged r=24 (wide_r24_progressive)"
    model = models[name]
    frames = x[:STREAM_CHUNK]
    device_args = [] if dev.type == "cuda" else ["--device", dev.type]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "deploy")
        log("[command] " + command("export", WIDE_R24, out, "--int8", *device_args).stdout.strip()
            .replace("\n", "; "))
        fin = os.path.join(tmp, "frames.csv")
        np.savetxt(fin, frames.cpu().numpy(), delimiter=",")
        for artifact, want, tol in (
            (os.path.join(out, "model_int8.bin"), int8_export.dequantized_params(model), NATIVE_TOL),
            (WIDE_R24, model, TOL),
        ):
            run = command("stream", artifact, "--input", fin, "--stats", *device_args)
            got = np.array([float(v) for v in run.stdout.split()], dtype=np.float32)
            stats = run.stderr.strip().splitlines()[-1]  # --stats' line comes last
            log(f"[command] stream {os.path.basename(artifact)}: {stats}")
            check_prefix(f"stream command, {os.path.basename(artifact)}", got,
                         P.predict(want, frames), tol)


def deployment_path(dev, x) -> dict:
    """Phase 8: the deployment slice (8a-8d). Returns 8a's launches."""
    launches = int8_path(dev, x)
    models = deploy_models(dev)
    export_path(dev, x, models)
    stream_path(dev, x, models)
    command_path(dev, x, models)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs only "
              "on a CUDA card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--time-tree"]:
        print(json.dumps(tree_times(torch.device("cuda", 0))))
        return 0
    if args and (args[0] != "--parent" or len(args) != 2 or not os.path.isdir(args[1])):
        print(f"usage: {sys.argv[0]} [--parent DIR]", file=sys.stderr)
        return 2
    log(card_line())  # the card's name and power limit, as nvidia-smi prints them
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    build_kernels()

    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    with exact_matmul(), torch.no_grad():
        checks = kernel_checks(dev, x)
        checks.update(batched_kernel_checks(dev))
        checks.update(fast_kernel_checks(dev, x))
        launches, ratios = main_path(dev, x)
        launches.update(batched_path(dev))
        fast_launches, fast_ratios = fast_path(dev, x)
        launches.update(fast_launches)
    log(f"[ratio] reduced / full batch-1 predict on {card_line()}: "
        + ", ".join(f"{k} {v:.4f}" for k, v in {**ratios, **fast_ratios}.items()))

    data = train_data()
    with exact_matmul():
        checks.update(train_kernel_checks(dev, data))
    if args:
        tree_turns(args[1])
    train_launches, histories = train_path(dev, data)
    recovery_launches = recovery_path(dev, data)
    # a train kernel's launches: phase 6's runs A-D and E-F, each counted from zero
    launches.update({k: train_launches[k] + recovery_launches[k] for k in train_launches})
    train_comparisons(dev, data, histories)
    with exact_matmul(), torch.no_grad():
        deployment_path(dev, x)

    print(json.dumps({"kernels": kernel_entries(checks, launches)}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


def kernel_entries(checks: dict, launches: dict) -> list:
    """One entry of the ``kernels`` line per kernel wrapper."""
    return [
        {
            "name": name,
            "route": "cuda",
            "source": module.SOURCE,
            "replaces": module.REPLACES[name],
            "launches": launches[name],
            "max_abs_err": checks[name]["max_abs_err"],
            "ms": checks[name]["ms"],
            "plain_ms": checks[name]["plain_ms"],
            "bound_ms": checks[name]["bound_ms"],
            "bound_by": checks[name]["bound_by"],
            "library_ms": checks[name]["library_ms"],
        }
        for module in (ck, cb, ct)
        for name in module.REPLACES
    ]


if __name__ == "__main__":
    sys.exit(main())
