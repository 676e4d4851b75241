"""Per-step latency of the native C++ runtime: the real-time deployment path
(the rebuilt LabVIEW consumer, reference load_preprocess.py:128).

Counterpart of ``scripts/bench_native.py``. The reference's compressed model
stepped 1.31-1.39x slower than its dense one in its Python consumer; the
native runtime (``io/native.py``, g++-built into ``build/native/``) runs the
exact two-step form, whose FLOPs per gate pair, r(m + 3n - 2r) against
m·n, are what a CPU step pays for. Timed per step (wall clock of the host's
native loop, best of ``repeats`` over T frames after 200 warm-up frames):
the seeded dense 4x40, its split truncations r = 25, 16, 8 and merged ones r
= 64, 40, 20, each with the two-step forced ('R' / 'M') and with the
load-time dispatch ('r' / 'm'), and the published 4x30 configuration (cells
2-3 at r = 15). The models are made on ``--device`` and exported as CSVs;
each native model's outputs over the first frames are held to ``predict``
of the same model on that device (1e-4, tests/test_native.py's limit).

    python -m svd_lstm_tpu_torch native-bench [--T 10000] [--repeats 9] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from svd_lstm_tpu_torch import examples as ex

UNITS = (40, 40, 40, 40)
D = 16
BUDGET_US = 500.0   # the DROPBEAR real-time frame period (16 samples at 500/16 µs)
WARMUP = 200
CHECK_STEPS = 256   # frames held to predict
NATIVE_TOL = 1e-4


def best_us_per_step(nm, frames: np.ndarray, repeats: int) -> float:
    nm.reset()
    nm.run(frames[:WARMUP])  # warm the caches
    best = float("inf")
    for _ in range(repeats):
        nm.reset()
        t0 = time.perf_counter()
        nm.run(frames)
        best = min(best, (time.perf_counter() - t0) / len(frames) * 1e6)
    return best


def run(T: int = 10_000, repeats: int = 9, units=UNITS, ranks=(25, 16, 8), merged_ranks=(64, 40, 20),
        published_units=(30, 30, 30, 30), published_rank: int = 15, device: str = "cuda") -> dict:
    """Every configuration's µs per step, and the largest native-vs-predict
    error over the first CHECK_STEPS frames (``max_err``)."""
    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.io.csv_weights import save_model_weights_as_csv
    from svd_lstm_tpu_torch.io.native import NativeModel, save_reduced_weights_as_csv

    dev = ex.device_of(device)
    frames = np.random.default_rng(0).normal(size=(T, D)).astype(np.float32)
    head = torch.as_tensor(frames[:CHECK_STEPS], device=dev)
    errs = {}

    def check(name, nm, model):
        nm.reset()
        got = nm.run(frames[:CHECK_STEPS])
        want = P.predict(model, head)[:, 0].cpu().numpy()
        errs[name] = float(np.abs(got - want).max())
        if not errs[name] <= NATIVE_TOL:
            raise RuntimeError(f"native {name}: {errs[name]:.3e} from predict (limit {NATIVE_TOL:g})")

    dense = P.init_stacked_lstm(torch.Generator().manual_seed(0), D, units, device=dev)
    label = "x".join(map(str, units))
    layer_dirs = [f"lstm_{i}" for i in range(len(units))]
    us = {}
    with tempfile.TemporaryDirectory() as td:
        save_model_weights_as_csv(dense, td)
        nm = NativeModel(td, layer_dirs, "d" * len(units))
        check("dense", nm, dense)
        us["dense"] = t_dense = best_us_per_step(nm, frames, repeats)
    print(f"native dense {label}:      {t_dense:7.2f} us/step "
          f"({BUDGET_US / t_dense:.0f}x inside the {BUDGET_US:.0f} us budget)")

    for merged, rs, raw_kind, kind in ((False, ranks, "R", "r"), (True, merged_ranks, "M", "m")):
        smodel = P.make_singular_model(dense, merged_kernel=merged)
        for r in rs:
            rmodel = P.make_reduced_model(smodel, rank=r)
            name = f"{'merged' if merged else 'split'} r={r}"
            with tempfile.TemporaryDirectory() as td:
                save_reduced_weights_as_csv(rmodel, td)
                times = []
                for k in (raw_kind, kind):
                    nm = NativeModel(td, layer_dirs, k * len(units))
                    check(f"{name} {k}", nm, rmodel)
                    times.append(best_us_per_step(nm, frames, repeats))
            us[f"{name} raw"], us[f"{name} dispatched"] = times
            print(f"native {'merged' if merged else 'reduced'} r={r:3d}:    raw {times[0]:6.2f} "
                  f"(ratio {times[0] / t_dense:.3f}) | dispatched {times[1]:6.2f} "
                  f"(ratio {times[1] / t_dense:.3f})" + ("" if merged else "  [reference python: 1.31-1.39]"))

    # the published timing configuration (slide 15): 4x30, cells 2-3 reduced
    pub = P.init_stacked_lstm(torch.Generator().manual_seed(1), D, published_units, device=dev)
    pub_red = P.make_reduced_model(P.make_singular_model(pub, merged_kernel=False), rank=published_rank)
    rec = P.reconstruct_dense_model(pub_red)
    inner = range(1, len(published_units) - 1)
    mixed = P.StackedLSTM([rec.layers[i] if i in inner else pub.layers[i]
                           for i in range(len(published_units))], pub.head)
    with tempfile.TemporaryDirectory() as td:
        save_model_weights_as_csv(pub, os.path.join(td, "dense"))
        save_reduced_weights_as_csv(pub_red, os.path.join(td, "red"))
        os.rename(os.path.join(td, "dense", "dense_top"), os.path.join(td, "dense_top"))
        n = len(published_units)
        dirs_dense = [f"dense/lstm_{i}" for i in range(n)]
        dirs_mixed = [f"red/lstm_{i}" if i in inner else f"dense/lstm_{i}" for i in range(n)]
        kinds = lambda k: "".join(k if i in inner else "d" for i in range(n))  # noqa: E731
        pub_times = []
        for name, dirs, kind, model in (("published dense", dirs_dense, "d" * n, pub),
                                        ("published raw", dirs_mixed, kinds("R"), mixed),
                                        ("published dispatched", dirs_mixed, kinds("r"), mixed)):
            nm = NativeModel(td, dirs, kind)
            check(name, nm, model)
            us[name] = best_us_per_step(nm, frames, repeats)
            pub_times.append(us[name])
    t_pd, t_pr, t_pm = pub_times
    print(f"published config {'x'.join(map(str, published_units))}:  {t_pd:7.2f} us/step dense | "
          f"raw two-step {t_pr:6.2f} (ratio {t_pr / t_pd:.3f}) | dispatched {t_pm:6.2f} "
          f"(ratio {t_pm / t_pd:.3f}) (reference: 1.31-1.39)")
    max_err = max(errs.values())
    print(f"native vs predict ({dev.type}) over the first {CHECK_STEPS} frames: largest error "
          f"{max_err:.3e} (limit {NATIVE_TOL:g}) over {len(errs)} models")
    return {"us_per_step": us, "errors": errs, "max_err": max_err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch native-bench",
                                 description="Per-step latency of the native C++ runtime.")
    ap.add_argument("--T", type=int, default=10_000, help="frames a timed run")
    ap.add_argument("--repeats", type=int, default=9, help="timed runs a model (the best is kept)")
    ex.add_device(ap)
    args = ap.parse_args(argv)
    return run(T=args.T, repeats=args.repeats, device=args.device)


if __name__ == "__main__":
    main()
