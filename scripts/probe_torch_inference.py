#!/usr/bin/env python3
"""Design trials of the inference kernels of the PyTorch port on one CUDA
card: K1's wavefront (``dense_stack_wave``) and K5's persistent chain
(``batched_chain``).

    python3 scripts/probe_torch_inference.py

Each variant is launched with settings the wrappers' rules would not pick,
checked against the plain version and timed in turns in one process (a, b,
..., ..., b, a: the card and its neighbours change between calls):

* K1 exact at 4x30 (the checkpoint ``pretrained_30units_v4_n1.5.npz``) and
  at 4x40 (a fresh stack from seed 0), T = 6656, d = 16, x from seed 0:
  the weights in registers, staged in shared memory or read from the
  global copy, at each lane count S the block admits, and the layer loop
  (``fused_dense_stack_kernel``, the parent's K1 body); K1f at 4x30 the same;
* K5 on the 3x512 checkpoint's layer 1 at B = 256, T = 128 (bf16 xp, its
  input the plain K5 h of layer 0): each CTA tile rows x units.

    python3 scripts/probe_torch_inference.py --tree DIR [DIR ...]

times K1 at 4x30 and 4x40 and K5 (each as its wrapper's rule launches it,
unchecked) on each DIR's copy of the package, a fresh process a tree (its
kernels built from its own sources), in turns (a, b, ..., ..., b, a): for
trial trees, copies of the package with a kernel edited (e.g. a phase of
its step taken out, to see what that phase costs).

Prints the card's name and power limit first. Imports torch and the port,
never JAX.
"""

import copy
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
from svd_lstm_tpu_torch.ops import cuda_batched as cb  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_lstm as ck  # noqa: E402

DENSE_30 = os.path.join(ROOT, "model_saves", "pretrained_30units_v4_n1.5.npz")
DENSE_512 = os.path.join(ROOT, "model_saves", "pretrained_3x512_n1.5.npz")
T, D, BATCH_B, BATCH_T = 6656, 16, 256, 128


def ulp2(v: float) -> float:
    """Two bf16 ulps at |v|."""
    return 2 * 2.0 ** (np.floor(np.log2(v)) - 7)


def in_turns(name, variants, check):
    """Checks each variant, then times them in turns; prints each ms."""
    for label, fn in variants:
        err, tol = check(fn())
        print(f"[check] {name} {label}: max abs err {err:.3g} (tol {tol:.3g})")
        if not err <= tol:
            raise SystemExit(f"{name} {label}: over its tolerance")
    order = variants + variants[::-1]
    ms = [device_time_ms(fn) for _, fn in order]
    print(f"[time] {name}, in turns: " + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms))
          + " ms", flush=True)


def k1_variants(model, x, fast):
    units = [l.units for l in model.layers]
    plan = ck.dense_plan(units, D, fast)
    out = torch.empty((T, units[-1]), dtype=torch.float32, device=x.device)

    def run(p):
        def f():
            ck._launch_dense(model, x, fast, p, out)
            return model.head(out)
        return f

    variants = [(f"rule: {plan.route} S={plan.lanes}", run(plan))]
    for route in ("registers", "staged", "global"):
        for lanes in ck.WAVE_LANES:
            threads = ck.wave_threads(units, D, lanes)
            limit = ck.WAVE_REG_THREADS if route == "registers" else ck.MAX_THREADS
            if (route, lanes) == (plan.route, plan.lanes) or threads > limit:
                continue
            if route == "registers" and ck._wave_kb(units, D, lanes) > ck.WAVE_REG_KB:
                continue
            if route == "staged" and 2 * 4 * (D + sum(units)) + ck.wave_entries(units, D) * (
                    8 if fast else 16) > ck._SMEM_LIMIT:
                continue
            variants.append((f"{route} S={lanes}", run(ck.DensePlan(route, lanes, threads, 0))))
    layers = ck.DensePlan("layers", 1, min(1024, 4 * max(units) + 31 & ~31),
                          4 * (2 * sum(units) + 4 * max(units) + D))
    variants.append(("layer loop", run(layers)))
    return variants


def k5_inputs(dev):
    """Layer 1 of the 3x512 checkpoint at B = 256, T = 128: (xp, U, the
    plain K5 h)."""
    m512 = P.load_params(DENSE_512, device=dev)
    xb = torch.tensor(np.random.default_rng(2).normal(size=(BATCH_B, BATCH_T, D)),
                      dtype=torch.float32, device=dev)
    h = xb.transpose(0, 1).to(torch.bfloat16)
    for l in m512.layers[:2]:
        xp = (torch.matmul(h, l.W.to(torch.bfloat16)) + l.b.to(torch.bfloat16)).contiguous()
        h = cb.batched_lstm_recurrence_plain(xp, l.U)
    return xp, l.U, h


@torch.no_grad()
def time_tree(dev) -> dict:
    """``--time-tree DIR``: K1 at 4x30 and 4x40 and K5 as the wrappers'
    rules launch them, in DIR's package, unchecked (a trial tree's edit may
    change the results): ms of each."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    m30 = P.load_params(DENSE_30, device=dev)
    m40 = P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=D, units=(40,) * 4, device=dev)
    xp, U, _ = k5_inputs(dev)
    with exact_matmul():
        return {"K1 4x30": device_time_ms(ck.fused_dense_stack, m30, x),
                "K1 4x40": device_time_ms(ck.fused_dense_stack, m40, x),
                "K5 3x512 layer 1": device_time_ms(cb.batched_lstm_recurrence, xp, U)}


def tree_turns(trees) -> None:
    """time_tree on each tree in a fresh process, in turns (a, b, ...,
    ..., b, a); prints each key's ms in the order of the runs."""
    order = list(trees) + list(trees)[::-1]
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"--time-tree {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for key in runs[0]:
        print(f"[tree] {key}, in turns: " + ", ".join(
            f"{os.path.basename(os.path.normpath(tree))} {r[key]:.3f}" for tree, r in zip(order, runs))
              + " ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_inference: needs a CUDA card", file=sys.stderr)
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
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    m30 = P.load_params(DENSE_30, device=dev)
    m40 = P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=D, units=(40,) * 4, device=dev)
    with exact_matmul(), torch.no_grad():
        for name, m, fast in (("K1 4x30", m30, False), ("K1 4x40", m40, False), ("K1f 4x30", m30, True)):
            dp = "default" if fast else None
            want = ck.fused_dense_stack_plain(m, x, dp)
            if fast:
                drift = float((want.double() - ck.fused_dense_stack_plain(
                    copy.deepcopy(m).double(), x.double(), dp)).abs().max())
                tol = max(ulp2(float(want.abs().max())), 2 * drift)
            else:
                tol = 5e-4
            in_turns(name, k1_variants(m, x, fast),
                     lambda got: (float((got - want).abs().max()), tol))

        xp, U, want = k5_inputs(dev)
        drift = float((want.double() - cb.batched_lstm_recurrence_plain(xp.double(), U.double()))
                      .abs().max())
        tol = max(ulp2(float(want.float().abs().max())), 2 * drift)
        tiles = cb.BATCHED_TILES

        def tile(rt):
            def f():
                cb.BATCHED_TILES = (rt,)
                try:
                    return cb.batched_lstm_recurrence(xp, U)
                finally:
                    cb.BATCHED_TILES = tiles
            return f

        in_turns("K5 3x512 layer 1", [(f"tile {r}x{u}", tile((r, u))) for r, u in
                                      cb.BATCHED_TILES],
                 lambda got: (float((got.float() - want.float()).abs().max()), tol))
    return 0


if __name__ == "__main__":
    sys.exit(main())
