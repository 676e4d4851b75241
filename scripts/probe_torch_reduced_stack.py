#!/usr/bin/env python3
"""Design trials of the batch-1 reduced stack of the PyTorch port (K4, K4f:
``reduced_stack_wave``, and the layer loop) on one CUDA card.

    python3 scripts/probe_torch_reduced_stack.py

Over T = 6656, x from seed 0 (d = 16): K4 on the direct merged r = 24
truncation of ``pretrained_3x512_n1.5.npz`` (|C| up to ~1.1e4, ROADMAP fault
3.1) and on the split r = 15 truncation of ``pretrained_30units_v4_n1.5.npz``;
K4f on ``wide_r24_progressive.npz`` and on the same 4x30 truncation. Each
variant (a cluster size and weight home the wrapper's rule would not pick,
or the layer loop) is checked against the plain version (exact: within
max(5e-4, twice the plain float32 version's distance from float64) over the
whole run; fast: 64 windows of 8 steps from zero state, as ``chip_smoke.py``
3c holds K4f) and timed in turns in one process (a, b, ..., ..., b, a),
cuDNN's LSTM beside them on the stack's exact dense reconstruction (TF32
off; bf16 beside K4f).

    python3 scripts/probe_torch_reduced_stack.py --tree DIR [DIR ...] [--parts DIR ...]

times K4 and K4f as the wrapper's rule launches them on each DIR's copy of
the package (the parent commit unpacked with ``git archive``, or a trial
tree with the kernel edited), a fresh process a tree, in turns, each run's
max abs difference from the plain version beside it; the trees after
``--parts`` (a part of the wave step taken out, so their output is wrong)
are timed without the check.

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
from svd_lstm_tpu_torch.ops import cuda_lstm as ck  # noqa: E402

SAVES = os.path.join(ROOT, "model_saves")
T, D = 6656, 16
TOL = 5e-4
# (cluster, home) of the trials past the rule, per stack; (1, "layers"): the layer loop
TRIALS = {
    "3x512 direct r=24": ((8, "staged"), (16, "registers"), (16, "staged")),
    "wide_r24_progressive": ((8, "staged"), (16, "registers"), (16, "staged")),
    "4x30 split r=15": ((1, "registers"), (1, "staged"), (2, "registers"), (4, "registers"),
                        (1, "layers")),
}


def models(dev) -> dict:
    """name -> (model, dot_precision) of each timed stack."""
    m512 = P.load_params(os.path.join(SAVES, "pretrained_3x512_n1.5.npz"), device=dev)
    m30 = P.load_params(os.path.join(SAVES, "pretrained_30units_v4_n1.5.npz"), device=dev)
    direct = P.make_reduced_model(P.make_singular_model(m512, merged_kernel=True), rank=24)
    red30 = P.make_reduced_model(P.make_singular_model(m30, merged_kernel=False), rank=15)
    wide = P.load_params(os.path.join(SAVES, "wide_r24_progressive.npz"), device=dev)
    return {("K4", "3x512 direct r=24"): (direct, None),
            ("K4f", "wide_r24_progressive"): (wide, "default"),
            ("K4", "4x30 split r=15"): (red30, None),
            ("K4f", "4x30 split r=15"): (red30, "default")}


def forced(model, x, fast: bool, cluster: int, home: str):
    """K4 launched as ``cluster`` CTAs with the weights at ``home`` (or the
    layer loop), past the wrapper's rule; the head outside, as the wrapper
    applies it. Returns (plan, fn)."""
    units, w_ranks, u_ranks = ck._stack_ranks(model)
    geom = ck.stack_geometry(units, w_ranks, u_ranks)
    if home == "layers":
        plan = ck.layers_stack_plan(units, x.shape[1], geom)
    else:
        warps = -(-geom.warps // cluster)
        plan = ck.ReducedStackPlan("wave", cluster, warps, home, 32 * warps,
                                   ck.reduced_stack_smem_bytes(geom, x.shape[1], cluster, warps,
                                                               home, fast))
    h = torch.empty((x.shape[0], units[-1]), dtype=torch.float32, device=x.device)

    def f(xs=x):
        out = h[: xs.shape[0]]
        ck._launch_reduced_stack(model, xs, fast, plan, out)
        return model.head(out)
    return plan, f


def check(name, fn, model, x, dp) -> str:
    """The variant against the plain version: exact over the whole run,
    fast over chip_smoke's 64 windows of 8 steps from zero state."""
    import copy

    from chip_smoke import K4_WINDOW_T, bf16_ulp, check_windows, window_starts

    if dp is None:
        plain = ck.fused_reduced_stack_plain(model, x)
        drift = float((plain.double() - ck.fused_reduced_stack_plain(
            copy.deepcopy(model).double(), x.double())).abs().max())
        err = float((fn() - plain).abs().max())
        tol = max(TOL, 2 * drift)
        if not err <= tol:
            raise SystemExit(f"{name}: max abs err {err:.3g} over {tol:.3g}")
        return f"max abs err {err:.3g} (tol {tol:.3g})"
    errs, largest = [], 0.0
    for t in window_starts(T, K4_WINDOW_T):
        xw = x[t : t + K4_WINDOW_T]
        plain = ck.fused_reduced_stack_plain(model, xw, dp)
        errs.append(float((fn(xw) - plain).abs().max()))
        largest = max(largest, float(plain.abs().max()))
    worst = check_windows(name, errs, [0.0] * len(errs), 2 * bf16_ulp(largest))
    return f"windows: largest {worst:.3g}"


def cudnn_ms(model, x, dtype) -> float:
    """cuDNN's LSTM on the stack's exact dense reconstruction (the head left
    out), TF32 off."""
    from chip_smoke import reduced_library_ms

    return reduced_library_ms(model, x, dtype, len(model.layers))


@torch.no_grad()
def time_tree(dev, check_it: bool) -> dict:
    """``--time-tree DIR [--time-only]``: K4 and K4f as the wrapper's rule
    launches them in DIR's package on each stack of ``models``: ms of each,
    and (unless ``--time-only``) each one's max abs difference from the
    plain version over the whole run."""
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    out = {}
    with exact_matmul():
        for (kname, mname), (model, dp) in models(dev).items():
            got = ck.fused_reduced_stack(model, x, dot_precision=dp)
            if check_it:
                want = ck.fused_reduced_stack_plain(model, x, dot_precision=dp)
                out[f"{kname} {mname} err"] = float((got - want).abs().max())
            out[f"{kname} {mname}"] = device_time_ms(
                lambda: ck.fused_reduced_stack(model, x, dot_precision=dp))
    return out


def tree_turns(trees, parts) -> None:
    order = list(trees) + list(parts) + list(parts)[::-1] + list(trees)[::-1]
    runs = []
    for tree in order:
        flag = ["--time-only"] if tree in parts else []
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree, *flag],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"--time-tree {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for key in runs[0]:
        unit = "" if key.endswith("err") else " ms"
        print(f"[tree] {key}, in turns: " + ", ".join(
            f"{os.path.basename(os.path.normpath(tree))} {r[key]:.4g}"
            for tree, r in zip(order, runs) if key in r) + unit, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_reduced_stack: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--time-tree"]:
        print(json.dumps(time_tree(dev, "--time-only" not in sys.argv[3:])))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if sys.argv[1:2] == ["--tree"]:
        args = sys.argv[2:]
        cut = args.index("--parts") if "--parts" in args else len(args)
        tree_turns(args[:cut], args[cut + 1:])
        return 0
    from svd_lstm_tpu_torch.ops import _build

    info = _build.build()
    ours = False
    for line in info["log"].splitlines():  # the resource report of each reduced_stack_wave
        if "Compiling entry" in line:
            ours = "reduced_stack_wave" in line
        if ours:
            print(f"[build] {line.strip()}")
    print(f"[build] nvcc {info['seconds']:.1f} s", flush=True)
    x = torch.tensor(np.random.default_rng(0).normal(size=(T, D)), dtype=torch.float32, device=dev)
    with exact_matmul(), torch.no_grad():
        for (kname, mname), (model, dp) in models(dev).items():
            fast = dp is not None
            plan = ck.card_reduced_stack_plan(dev, model, D, fast)
            print(f"[plan] {kname} {mname}: {plan}", flush=True)
            variants = [(f"wrapper (CL={plan.cluster} {plan.home})",
                         lambda model=model, dp=dp: ck.fused_reduced_stack(model, x, dot_precision=dp))]
            for cluster, home in TRIALS[mname]:
                if (cluster, home) == (plan.cluster, plan.home):
                    continue
                _, fn = forced(model, x, fast, cluster, home)
                label = f"CL={cluster} {home}"
                print(f"[check] {kname} {mname} {label}: "
                      f"{check(f'{kname} {mname} {label}', fn, model, x, dp)}", flush=True)
                variants.append((label, fn))
            order = variants + variants[::-1]
            ms = [device_time_ms(fn) for _, fn in order]
            print(f"[time] {kname} {mname}, in turns: "
                  + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms)) + " ms",
                  flush=True)
            print(f"[time] cuDNN on {mname}'s dense reconstruction: "
                  f"{cudnn_ms(model, x, torch.bfloat16 if fast else torch.float32):.3f} ms "
                  f"({'bf16' if fast else 'float32'})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
