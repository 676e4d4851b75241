#!/usr/bin/env python3
"""Design trials of the batch-1 low-rank recurrence of the PyTorch port (K2,
K2f: ``reduced_chain``) on one CUDA card.

    python3 scripts/probe_torch_reduced.py

Layer 0 of two 3x512 merged r = 24 models over T = 6656, x from seed 0
(d = 16): the direct truncation of ``pretrained_3x512_n1.5.npz`` (|C| up to
~1.1e4, ROADMAP fault 3.1) and ``wide_r24_progressive.npz``; xp is the
layer's factored x-side (in fast mode with bf16-rounded operands, as
``chip_smoke.py`` 3 and 3c). Each variant is launched at a cluster size and
weight home the wrapper's rule would not pick, checked against the plain
version (exact: 5e-4 over the whole run; fast: 64 windows of 16 steps, each
restarted from the plain version's state, as ``chip_smoke.py`` 3c holds
K2f) and timed in turns in one process (a, b, ..., ..., b, a), cuDNN's LSTM
beside them on the layer's exact dense reconstruction with its x-side
product (TF32 off; bf16 beside K2f).

    python3 scripts/probe_torch_reduced.py --tree DIR [DIR ...]

times K2 and K2f as the wrapper's rule launches them on each DIR's copy of
the package (the parent commit unpacked with ``git archive``, or a trial
tree with the kernel edited), a fresh process a tree, in turns, each run's
max abs difference from the plain version beside it.

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
sys.path.insert(1, ROOT)  # chip_smoke's helpers

import svd_lstm_tpu_torch as P  # noqa: E402
from svd_lstm_tpu_torch.api import exact_matmul  # noqa: E402
from svd_lstm_tpu_torch.bench.devtime import device_time_ms  # noqa: E402
from svd_lstm_tpu_torch.models.reduced import folded_projection, reduced_projection  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_lstm as ck  # noqa: E402

DENSE_512 = os.path.join(ROOT, "model_saves", "pretrained_3x512_n1.5.npz")
WIDE_R24 = os.path.join(ROOT, "model_saves", "wide_r24_progressive.npz")
T, D = 6656, 16
TOL = 5e-4
MODES = (("K2", None), ("K2f", "default"))
# (cluster, home) of the trials, past the wrapper's rule
TRIALS = ((2, "staged"), (4, "registers"), (4, "staged"), (8, "registers"), (8, "staged"),
          (16, "registers"), (16, "staged"))


def models(dev) -> dict:
    m512 = P.load_params(DENSE_512, device=dev)
    direct = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    return {"direct r=24": direct, "wide_r24_progressive": P.load_params(WIDE_R24, device=dev)}


def layer0_inputs(model, x, fast: bool):
    l = model.layers[0]
    return l, (reduced_projection(l, x, "w", bf16=fast) + l.b).contiguous()


def forced(xp, l, fast: bool, cluster: int, home: str):
    """K2's kernel launched as one cluster of ``cluster`` CTAs with the
    weights at ``home``, past the wrapper's rule (the packing outside the
    timed call)."""
    n = l.units
    ranks = ck.reduced_ranks(l.uB)
    warps = -(-(-(-n // cluster)) // ck.RED_UNITS)
    plan = ck.ReducedPlan(cluster, warps, home, 32 * warps,
                          ck.reduced_smem_bytes(ranks, cluster, warps, home, fast), 0)
    uB, uC = (tuple(l.uB), tuple(l.uC)) if l.split else (l.uB, l.uC)
    packed = ck.pack_reduced_chain(uB, uC, n, cluster * warps, fast)
    ranks_arr = np.array(ranks, dtype=np.int32)
    out = torch.empty((T, n), dtype=torch.float32, device=xp.device)

    def f():
        ck._launch("reduced_recurrence", xp.device, xp.data_ptr(), packed.data_ptr(),
                   ranks_arr.ctypes.data, len(ranks), None, None, out.data_ptr(), T, n, cluster,
                   warps, ck.RED_HOMES.index(home), int(fast))
        return out
    return plan, f


def check(name, fn, xp, l, dp) -> str:
    """The variant against the plain version: exact over the whole run,
    fast over chip_smoke's 64 windows (restarted from the plain state)."""
    from chip_smoke import WINDOW_T, bf16_ulp, check_windows, plain_states, window_starts

    uB, uC = (tuple(l.uB), tuple(l.uC)) if l.split else (l.uB, l.uC)
    if dp is None:
        err = float((fn() - ck.reduced_recurrence_plain(xp, uB, uC)).abs().max())
        if not err <= TOL:
            raise SystemExit(f"{name}: max abs err {err:.3g} over {TOL:g}")
        return f"max abs err {err:.3g} (tol {TOL:g})"
    # the windows through the wrapper's own route at the forced plan
    starts = window_starts(T, WINDOW_T)
    h, states = plain_states(xp, folded_projection(uB, uC, True), starts)
    errs, drifts = [], []
    for t in starts:
        hc, cc = states[t]
        xw = xp[t: t + WINDOW_T]
        plain = ck.reduced_recurrence_plain(xw, uB, uC, hc, cc, dp)
        got = ck._launch_reduced(xw, uB, uC, hc.reshape(-1), cc.reshape(-1), True, fn.plan)
        errs.append(float((got - plain).abs().max()))
        drifts.append(0.0)
    worst = check_windows(name, errs, drifts, 2 * bf16_ulp(float(h.abs().max())))
    return f"windows: largest {worst:.3g}"


def cudnn_ms(model, x, dtype) -> float:
    """cuDNN's one-layer LSTM on layer 0's exact dense reconstruction with
    its x-side product, TF32 off."""
    from chip_smoke import cudnn_exact, cudnn_lstm

    l = P.reconstruct_dense_model(model).layers[0]
    lstm = cudnn_lstm([(l.W, l.U, l.b)], x.device, dtype)
    xs = x[:, None].to(dtype)
    with cudnn_exact():
        return device_time_ms(lambda: lstm(xs))


# the clusters a trial tree is timed at, where its package has K2's cluster
TREE_TRIALS = ((4, "registers"), (8, "registers"), (8, "staged"), (16, "registers"), (16, "staged"))


@torch.no_grad()
def time_tree(dev) -> dict:
    """``--time-tree DIR``: K2 and K2f as the wrapper's rule launches them in
    DIR's package, and (where the package has K2's cluster) at each of
    TREE_TRIALS on the direct truncation: ms of each, and each one's max
    abs difference from the plain version over the whole run."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    out = {}
    with exact_matmul():
        for mname, model in models(dev).items():
            for name, dp in MODES:
                l, xp = layer0_inputs(model, x, dp is not None)
                uB, uC = (tuple(l.uB), tuple(l.uC)) if l.split else (l.uB, l.uC)
                want = ck.reduced_recurrence_plain(xp, uB, uC, dot_precision=dp)
                got = ck.reduced_recurrence(xp, uB, uC, dot_precision=dp)
                out[f"{name} {mname} err"] = float((got - want).abs().max())
                out[f"{name} {mname} layer 0"] = device_time_ms(
                    lambda: ck.reduced_recurrence(xp, uB, uC, dot_precision=dp))
                if mname != "direct r=24" or not hasattr(ck, "pack_reduced_chain"):
                    continue
                for cluster, home in TREE_TRIALS:
                    _, fn = forced(xp, l, dp is not None, cluster, home)
                    out[f"{name} CL={cluster} {home} err"] = float((fn() - want).abs().max())
                    out[f"{name} CL={cluster} {home}"] = device_time_ms(fn)
    return out


def tree_turns(trees) -> None:
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
        print("probe_torch_reduced: needs a CUDA card", file=sys.stderr)
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
    from svd_lstm_tpu_torch.ops import _build

    info = _build.build()
    ours = False
    for line in info["log"].splitlines():  # the resource report of each reduced_chain
        if "Compiling entry" in line:
            ours = "reduced_chain" in line
        if ours:
            print(f"[build] {line.strip()}")
    print(f"[build] nvcc {info['seconds']:.1f} s", flush=True)
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    with exact_matmul(), torch.no_grad():
        for mname, model in models(dev).items():
            for name, dp in MODES:
                fast = dp is not None
                l, xp = layer0_inputs(model, x, fast)
                uB, uC = (tuple(l.uB), tuple(l.uC)) if l.split else (l.uB, l.uC)
                plan = ck.card_reduced_plan(dev, l.units, ck.reduced_ranks(l.uB), fast)
                print(f"[plan] {name} {mname}: {plan}", flush=True)
                variants = [(f"wrapper (CL={plan.cluster} {plan.home})",
                             lambda xp=xp, uB=uB, uC=uC, dp=dp: ck.reduced_recurrence(xp, uB, uC, dot_precision=dp))]
                for cluster, home in TRIALS:
                    fplan, fn = forced(xp, l, fast, cluster, home)
                    fn.plan = fplan
                    print(f"[check] {name} {mname} CL={cluster} {home}: "
                          f"{check(f'{name} {mname} CL={cluster} {home}', fn, xp, l, dp)}", flush=True)
                    variants.append((f"CL={cluster} {home}", fn))
                order = variants + variants[::-1]
                ms = [device_time_ms(fn) for _, fn in order]
                print(f"[time] {name} {mname} layer 0, in turns: "
                      + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms)) + " ms",
                      flush=True)
            print(f"[time] cuDNN on {mname} layer 0's dense reconstruction (with its x-side): "
                  f"float32 {cudnn_ms(model, x, torch.float32):.3f} ms, bf16 "
                  f"{cudnn_ms(model, x, torch.bfloat16):.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
