#!/usr/bin/env python3
"""Design trials of the batch-1 dense recurrence of the PyTorch port (K3,
K3f: ``recurrence_chain``) on one CUDA card.

    python3 scripts/probe_torch_recurrence.py

Layer 0 of the 3x512 checkpoint (``pretrained_3x512_n1.5.npz``) over
T = 6656, x from seed 0 (d = 16): xp = x·W + b, and in fast mode the
x-side product of bf16-rounded operands (as ``chip_smoke.py`` 3 and 3c).
Each variant is launched with settings the wrapper's rule would not pick
(units J a CTA, the weights in registers, staged in shared memory or read
from the global copy), checked against the plain version (exact: 5e-4;
fast: 2 bf16 ulps of the largest h or twice the plain version's distance
from float64 state) and timed in turns in one process (a, b, ..., ..., b,
a: the card and its neighbours change between calls), cuDNN's LSTM beside
them (TF32 off; with its x-side product, in float32 and in bf16).

    python3 scripts/probe_torch_recurrence.py --tree DIR [DIR ...]

times K3 and K3f (each as its wrapper's rule launches it) on each DIR's
copy of the package, a fresh process a tree (its kernels built from its own
sources), in turns (a, b, ..., ..., b, a), and prints each run's max abs
difference from the plain version beside it: for the parent commit
unpacked with ``git archive``, and for trial trees, copies of the package
with the kernel edited (a part of the step taken out, to see what it
costs, whose results are then wrong; or another design, such as a cluster
of CTAs, whose results must hold).

Prints the card's name and power limit first. Imports torch and the port,
never JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --time-tree DIR: import DIR's package (see tree_turns)
sys.path.insert(0, os.path.abspath(sys.argv[2]) if sys.argv[1:2] == ["--time-tree"] else ROOT)

import svd_lstm_tpu_torch as P  # noqa: E402
from svd_lstm_tpu_torch.api import exact_matmul  # noqa: E402
from svd_lstm_tpu_torch.bench.devtime import device_time_ms  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_lstm as ck  # noqa: E402

DENSE_512 = os.path.join(ROOT, "model_saves", "pretrained_3x512_n1.5.npz")
T, D = 6656, 16
TOL = 5e-4
MODES = (("K3", None), ("K3f", "default"))


def ulp2(v: float) -> float:
    """Two bf16 ulps at |v|."""
    return 2 * 2.0 ** (np.floor(np.log2(v)) - 7)


def layer0(dev):
    """(layer, x, {mode: xp}) of the 3x512 checkpoint's layer 0."""
    m512 = P.load_params(DENSE_512, device=dev)
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    l0 = m512.layers[0]
    b16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    return l0, x, {"K3": (torch.matmul(x, l0.W) + l0.b).contiguous(),
                   "K3f": (torch.matmul(b16(x), b16(l0.W)) + l0.b).contiguous()}


def tolerance(xp, U, dp, want) -> float:
    if dp is None:
        return TOL
    drift = float((want.double() - ck.lstm_recurrence_plain(xp.double(), U.double(), dot_precision=dp))
                  .abs().max())
    return max(ulp2(float(want.abs().max())), 2 * drift)


def forced(xp, U, fast: bool, units: int, home: str):
    """K3's kernel launched at ``units`` a CTA with the weights at ``home``,
    past the wrapper's rule (the packing outside the timed call)."""
    n = U.shape[0]
    packed = ck.pack_recurrence(U, fast)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)

    def f():
        ck._launch("lstm_recurrence", xp.device, xp.data_ptr(), packed.data_ptr(), None, None,
                   out.data_ptr(), T, n, units, ck.WAVE_HOMES.index(home), int(fast))
        return out
    return f


def in_turns(name, variants, want, tol):
    """Checks each variant, then times them in turns; prints each ms."""
    for label, fn in variants:
        err = float((fn() - want).abs().max())
        print(f"[check] {name} {label}: max abs err {err:.3g} (tol {tol:.3g})", flush=True)
        if not err <= tol:
            raise SystemExit(f"{name} {label}: over its tolerance")
    order = variants + variants[::-1]
    ms = [device_time_ms(fn) for _, fn in order]
    print(f"[time] {name}, in turns: " + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms))
          + " ms", flush=True)


def cudnn_ms(l0, x, dtype) -> float:
    """cuDNN's one-layer LSTM with its x-side product, TF32 off."""
    from chip_smoke import cudnn_exact, cudnn_lstm

    lstm = cudnn_lstm([(l0.W, l0.U, l0.b)], x.device, dtype)
    xs = x[:, None].to(dtype)
    with cudnn_exact():
        return device_time_ms(lambda: lstm(xs))


@torch.no_grad()
def time_tree(dev) -> dict:
    """``--time-tree DIR``: K3 and K3f as the wrapper's rule launches them in
    DIR's package: ms of each, and each one's max abs difference from the
    plain version."""
    l0, _, xps = layer0(dev)
    out = {}
    with exact_matmul():
        for name, dp in MODES:
            xp = xps[name]
            want = ck.lstm_recurrence_plain(xp, l0.U, dot_precision=dp)
            out[f"{name} err"] = float((ck.lstm_recurrence(xp, l0.U, dot_precision=dp) - want).abs().max())
            out[f"{name} 3x512 layer 0"] = device_time_ms(
                lambda: ck.lstm_recurrence(xp, l0.U, dot_precision=dp))
    return out


def tree_turns(trees) -> None:
    """time_tree on each tree in a fresh process, in turns (a, b, ...,
    ..., b, a); prints each key in the order of the runs."""
    order = list(trees) + list(trees)[::-1]
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"--time-tree {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for key in runs[0]:
        unit = "" if key.endswith("err") else " ms"
        print(f"[tree] {key}, in turns: " + ", ".join(
            f"{os.path.basename(os.path.normpath(tree))} {r[key]:.4g}" for tree, r in zip(order, runs))
              + unit, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_recurrence: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--time-tree"]:
        print(json.dumps(time_tree(dev)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if sys.argv[1:2] == ["--tree"]:
        tree_turns(sys.argv[2:])
        return 0
    l0, x, xps = layer0(dev)
    n = l0.units
    with exact_matmul(), torch.no_grad():
        for name, dp in MODES:
            fast = dp is not None
            xp = xps[name]
            plan = ck.card_recurrence_plan(dev, n, fast)
            print(f"[plan] {name} n={n}: {plan}", flush=True)
            want = ck.lstm_recurrence_plain(xp, l0.U, dot_precision=dp)
            variants = [(f"wrapper ({plan.home} J={plan.units})",
                         lambda xp=xp, dp=dp: ck.lstm_recurrence(xp, l0.U, dot_precision=dp))]
            for home, units in (("registers", 2), ("registers", 4), ("registers", 8), ("staged", 4),
                                ("staged", 8), ("staged", 16), ("global", 4), ("global", 8)):
                variants.append((f"{home} J={units}", forced(xp, l0.U, fast, units, home)))
            in_turns(f"{name} 3x512 layer 0", variants, want, tolerance(xp, l0.U, dp, want))
        print(f"[time] cuDNN float32 (with its x-side): {cudnn_ms(l0, x, torch.float32):.3f} ms; "
              f"bf16: {cudnn_ms(l0, x, torch.bfloat16):.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
