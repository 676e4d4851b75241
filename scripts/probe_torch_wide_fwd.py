#!/usr/bin/env python3
"""The wide-layer train forward of the PyTorch port (K9, K6: ``gemm_f32``
x-side and ``wide_fwd_chain``) by part, on one CUDA card.

    python3 scripts/probe_torch_wide_fwd.py

K9 at run C's layer shape (n = 512, d = 512, B = 128, T = 200; a fresh
layer from seed 0 on a fresh input) and K6 at run D's (n = 512, xp from d =
16): each checked against its plain version (h and c within 1e-4 or twice
the plain float32 version's distance from float64, as ``chip_smoke.py``
holds them), then timed in turns in one process (a, b, ..., ..., b, a): the
wrapper, the x-side GEMM alone, the chain alone with U staged and from the
global copy, cuDNN's LSTM forward (TF32 off) beside them. Each part beside
its bound (its operations over 67 TFLOP/s float32).

Prints the card's name and power limit first. Imports torch and the port,
never JAX.
"""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from svd_lstm_tpu_torch.api import exact_matmul  # noqa: E402
from svd_lstm_tpu_torch.bench.devtime import device_time_ms  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_train as ct  # noqa: E402

T, B, N = 200, 128, 512
PEAK = 67e12


def case(dev, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda shape, s: torch.tensor(rng.normal(scale=s, size=shape), dtype=torch.float32, device=dev)  # noqa: E731
    return f((T, B, d), 1.0), f((d, 4 * N), d ** -0.5), f((N, 4 * N), N ** -0.5), f((4 * N,), 0.1)


def check(name, got, want, want64):
    for part, a, r, r64 in zip("hc", got, want, want64):
        drift = float((r.double() - r64).abs().max())
        err = float((a - r).abs().max())
        tol = max(1e-4, 2 * drift)
        print(f"[check] {name} {part}: max abs err {err:.3g} (tol {tol:.3g})", flush=True)
        if not err <= tol:
            raise SystemExit(f"{name} {part}: over its tolerance")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_wide_fwd: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    from chip_smoke import library_train

    sms = ct.sm_count(dev)
    with exact_matmul(), torch.no_grad():
        for name, d in (("K9 (run C's layer 1)", 512), ("K6 (run D)", 16)):
            x, W, U, b = case(dev, d, 0 if d == 512 else 1)
            rec = d == 16
            inp = (torch.matmul(x, W) + b).contiguous() if rec else x
            Wk, bk = (None, None) if rec else (W, b)
            want = (ct.lstm_recurrence_train_fwd_plain(inp, U) if rec
                    else ct.wide_layer_fwd_plain(x, W, U, b))
            want64 = (ct.lstm_recurrence_train_fwd_plain(inp.double(), U.double()) if rec
                      else ct.wide_layer_fwd_plain(x.double(), W.double(), U.double(), b.double()))
            plan = ct.fwd_chain_plan(B, N, sms)
            print(f"[plan] {name}: {plan}", flush=True)
            check(f"{name} wrapper", ct.wide_fwd(inp, Wk, U, bk), want, want64)
            xz = inp if rec else ct.phase_x_side(x, W, b)
            Ui = ct.pack_gates_interleaved(U)
            h, c = torch.empty((T, B, N), device=dev), torch.empty((T, B, N), device=dev)
            variants = [("wrapper", lambda: ct.wide_fwd(inp, Wk, U, bk))]
            if not rec:
                variants.append(("x-side GEMM", lambda: ct.phase_x_side(x, W, b)))
            for staged in (True, False):
                p = plan._replace(staged=staged)

                def chain(p=p):
                    ct.phase_chain_fwd(xz, Ui, h, c, p)
                    return h, c
                check(f"{name} chain staged={staged}", chain(), want, want64)
                variants.append((f"chain staged={staged}", chain))
            order = variants + variants[::-1]
            ms = [device_time_ms(fn) for _, fn in order]
            print(f"[time] {name}, in turns: "
                  + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms)) + " ms", flush=True)
            fl_chain = 2 * (T - 1) * B * N * 4 * N
            fl_x = 2 * T * B * d * 4 * N
            print(f"[bound] {name}: chain {fl_chain / PEAK * 1e3:.4f} ms, x-side "
                  f"{0 if rec else fl_x / PEAK * 1e3:.4f} ms (operations over 67 TFLOP/s)", flush=True)
            fwd_ms, _ = library_train([(W, U, b)], x, torch.zeros((T, B, N), device=dev))
            print(f"[time] {name}: cuDNN LSTM forward (with its x-side) {fwd_ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
