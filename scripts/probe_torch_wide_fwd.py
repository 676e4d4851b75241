#!/usr/bin/env python3
"""The wide-layer train forward of the PyTorch port by part, on one CUDA
card: K9 and K6 (``gemm_f32`` x-side and ``wide_fwd_chain``), or with
``--bf16`` K9f and K6f (the ``bf16_copy`` copies, the ``gemm_bf16`` x-side
and ``batched_chain`` with c stored).

    python3 scripts/probe_torch_wide_fwd.py
    python3 scripts/probe_torch_wide_fwd.py --bf16
    python3 scripts/probe_torch_wide_fwd.py --bf16 --tree DIR [DIR ...]
    python3 scripts/probe_torch_wide_fwd.py --bf16 --wide

K9 (K9f) at run C's layer shape (n = 512, d = 512, B = 128, T = 200; a
fresh layer from seed 0 on a fresh input) and K6 (K6f) at run D's (n = 512,
xp from d = 16): each checked against its plain version, then timed in
turns in one process (a, b, ..., ..., b, a), each part beside its bound.

* float32: h and c within 1e-4 or twice the plain float32 version's
  distance from float64 (as ``chip_smoke.py`` holds them); the wrapper, the
  x-side GEMM alone, the chain alone with U staged and from the global copy,
  cuDNN's LSTM forward (TF32 off); bounds at 67 TFLOP/s float32.
* ``--bf16``: h and c within ``chip_smoke.py``'s ``fast_limit`` of the plain
  bf16 version; the wrapper, the copies of x and W, the x-side
  ``gemm_bf16`` alone on them, the chain alone at each tile of K5's
  ``BATCHED_TILES`` (each checked), cuDNN's bf16 LSTM forward (with its
  x-side); bounds at 989 TFLOP/s bf16 or the bytes at 3.35 TB/s.
* ``--bf16 --tree DIR ...``: K9f's and K6f's forward at the plan's tile and
  the chain alone at each tile on each tree's package (a copy of the
  package under a gitignored directory with the kernel edited: a trial),
  each tree in a fresh process, in turns (the trees, then reversed), each
  result checked.
* ``--bf16 --wide``: K9f's and K6f's forward at n = 1024 (32 x 16, the
  widest staged tile) and past the staged tiles (1280 and 2176: U read from
  its fragment-ordered global copy), d = 16, B = 128, T = 200, each
  checked: the wrapper at the plan's tile, the chain alone at each
  unstaged tile (K5's chunks at the card's occupancy), the float32 K9 / K6
  forward beside them and cuDNN's bf16 LSTM forward.

Prints the card's name and power limit first. Imports torch and the port,
never JAX.
"""

import os
import subprocess
import sys

if __name__ == "__main__" and sys.argv[1:2] == ["--time-tree"]:
    sys.path.insert(0, os.path.abspath(sys.argv[2]))  # a trial tree's package before this one

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(ROOT)

from svd_lstm_tpu_torch.api import exact_matmul  # noqa: E402
from svd_lstm_tpu_torch.bench import roofline  # noqa: E402
from svd_lstm_tpu_torch.bench.devtime import device_time_ms  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_batched as cb  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_train as ct  # noqa: E402

T, B, N = 200, 128, 512
PEAK = 67e12
SHAPES = (("K9 (run C's layer 1)", 512), ("K6 (run D)", 16))


def case(dev, d, seed, n=N):
    rng = np.random.default_rng(seed)
    f = lambda shape, s: torch.tensor(rng.normal(scale=s, size=shape), dtype=torch.float32, device=dev)  # noqa: E731
    return f((T, B, d), 1.0), f((d, 4 * n), d ** -0.5), f((n, 4 * n), n ** -0.5), f((4 * n,), 0.1)


def inputs(dev, d):
    """(x, W, U, b) of the shape and, for K6 (d = 16), its projection xp
    with W and b None: the forward's arguments."""
    x, W, U, b = case(dev, d, 0 if d == 512 else 1)
    if d == 16:
        return (torch.matmul(x, W) + b).contiguous(), None, U, None, (x, W, b)
    return x, W, U, b, (x, W, b)


def plain(inp, W, U, b, bf16=False):
    if W is None:
        return ct.lstm_recurrence_train_fwd_plain(inp, U, bf16)
    return ct.wide_layer_fwd_plain(inp, W, U, b, bf16)


def check(name, got, want, want64, bf16=False):
    for part, a, r, r64 in zip("hc", got, want, want64):
        drift = float((r.double() - r64).abs().max())
        err = float((a.double() - r.double()).abs().max())
        if bf16:  # chip_smoke.py fast_limit
            ulp = 2.0 ** (np.floor(np.log2(float(r.abs().max()))) - 7)
            tol = max(2 * ulp, 2 * drift)
        else:
            tol = max(1e-4, 2 * drift)
        print(f"[check] {name} {part}: max abs err {err:.3g} (tol {tol:.3g})", flush=True)
        if not err <= tol:
            raise SystemExit(f"{name} {part}: over its tolerance")


def in_turns(name, variants, bounds=None):
    order = variants + variants[::-1]
    ms = [device_time_ms(fn) for _, fn in order]
    print(f"[time] {name}, in turns: "
          + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms)) + " ms", flush=True)
    for label, _ in variants:
        mine = sorted(t for (lab, _), t in zip(order, ms) if lab == label)
        extra = ""
        if bounds and label in bounds:
            r = bounds[label]
            extra = f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / mine[0]:.3f} of it"
        print(f"[time] {name} {label}: best {mine[0]:.3f} ms{extra}", flush=True)


def float32_parts(dev):
    from chip_smoke import library_train

    sms = ct.sm_count(dev)
    for name, d in SHAPES:
        inp, Wk, U, bk, (x, W, b) = inputs(dev, d)
        rec = Wk is None
        want = plain(inp, Wk, U, bk)
        want64 = plain(*(None if a is None else a.double() for a in (inp, Wk, U, bk)))
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
        in_turns(name, variants)
        fl_chain = 2 * (T - 1) * B * N * 4 * N
        fl_x = 2 * T * B * d * 4 * N
        print(f"[bound] {name}: chain {fl_chain / PEAK * 1e3:.4f} ms, x-side "
              f"{0 if rec else fl_x / PEAK * 1e3:.4f} ms (operations over 67 TFLOP/s)", flush=True)
        fwd_ms, _ = library_train([(W, U, b)], x, torch.zeros((T, B, N), device=dev))
        print(f"[time] {name}: cuDNN LSTM forward (with its x-side) {fwd_ms:.3f} ms", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def forced(tile):
    """The bf16 chain's plan at ``tile``, the batch in one launch (the
    launcher refuses a grid that cannot be co-resident)."""
    rows, units = tile
    return cb.BatchedPlan(rows, units, -(-N // units), B, cb.batched_smem_bytes(N, rows, units))


def bf16_wide(dev):
    """``--bf16 --wide``: the bf16 forward at widths no staged tile holds."""
    from chip_smoke import library_train

    sms = ct.sm_count(dev)
    for n in (1024, 1280, 2176):
        x, W, U, b = case(dev, 16, 2, n)
        xp = (torch.matmul(x, W) + b).contiguous()
        for name, args in ((f"K9f n={n}", (x, W, U, b)), (f"K6f n={n}", (xp, None, U, None))):
            inp, Wk, _, bk = args
            want = plain(*args, True)
            want64 = plain(*(None if a is None else a.double() for a in args), True)
            print(f"[plan] {name}: {ct.fwd_plan_bf16(dev, B, n)}", flush=True)
            check(f"{name} wrapper", ct.wide_fwd_bf16(*args), want, want64, True)
            variants = [("wrapper", lambda args=args: ct.wide_fwd_bf16(*args)),
                        ("float32 wrapper", lambda args=args: ct.wide_fwd(*args))]
            xz = inp if Wk is None else ct.phase_x_side_bf16(x, W, b)
            Utp = cb.fragment_order(U.t().to(torch.bfloat16).contiguous())
            h, c = torch.empty((T, B, n), device=dev), torch.empty((T, B, n), device=dev)
            for rows, units in cb.UNSTAGED_TILES:
                def per_sm(r, u, staged, tile=(rows, units)):
                    return cb._per_sm(dev.index, n, False, r, u, True, staged) \
                        if (r, u) == tile and not staged else 0
                try:
                    plan = cb.batched_plan(B, n, sms, per_sm, unstaged=True)
                except ValueError as e:
                    print(f"[plan] {name} {rows}x{units}: {e}", flush=True)
                    continue

                def chain(plan=plan, xz=xz):
                    ct.phase_chain_fwd_bf16(xz, Utp, h, c, plan)
                    return h, c
                label = f"chain {rows}x{units} ({plan.chunks(B)} launches)"
                check(f"{name} {label}", chain(), want, want64, True)
                variants.append((label, chain))
            in_turns(name, variants)
        fwd_ms, _ = library_train([(W, U, b)], x, torch.zeros((T, B, n), device=dev), torch.bfloat16)
        print(f"[time] n={n}: cuDNN bf16 LSTM forward (with its x-side) {fwd_ms:.3f} ms", flush=True)


def bf16_parts(dev):
    from chip_smoke import library_train

    for name, d in SHAPES:
        name = name.replace("K9", "K9f").replace("K6", "K6f")
        inp, Wk, U, bk, (x, W, b) = inputs(dev, d)
        rec = Wk is None
        want = plain(inp, Wk, U, bk, True)
        want64 = plain(*(None if a is None else a.double() for a in (inp, Wk, U, bk)), True)
        print(f"[plan] {name}: {ct.fwd_plan_bf16(dev, B, N)}", flush=True)
        check(f"{name} wrapper", ct.wide_fwd_bf16(inp, Wk, U, bk), want, want64, True)
        variants = [("wrapper", lambda: ct.wide_fwd_bf16(inp, Wk, U, bk))]
        G, M = 4 * N, T * B
        xz = inp if rec else ct.phase_x_side_bf16(x, W, b)
        hc_bytes = 2 * T * B * N * 4  # h and c out, float32
        bounds = {"wrapper": roofline.bound(roofline.lstm_macs(T, B, [(0 if rec else d, N)]),
                                            nbytes(inp, U) + (0 if rec else nbytes(W, b)) + hc_bytes,
                                            "bfloat16")}
        if not rec:
            xb, Wb = ct.bf16_xw(x, W)

            def copies():
                return ct.bf16_xw(x, W)

            def x_side():
                out = torch.empty((T, B, G), dtype=torch.float32, device=dev)
                ct._gemm_bf16(out, M, G, "NN", [ct._seg_bf16(xb, Wb, xb.shape[1])], bias=b)
                return out
            variants += [("copies", copies), ("x-side gemm_bf16", x_side)]
            bounds["copies"] = roofline.bound(0, nbytes(x, W, xb, Wb), "bfloat16")
            bounds["x-side gemm_bf16"] = roofline.bound(M * d * G, nbytes(xb, Wb, b, xz), "bfloat16")
        Ut = U.t().to(torch.bfloat16).contiguous()
        h, c = torch.empty((T, B, N), device=dev), torch.empty((T, B, N), device=dev)
        for tile in cb.BATCHED_TILES:
            plan = forced(tile)

            def chain(plan=plan):
                ct.phase_chain_fwd_bf16(xz, Ut, h, c, plan)
                return h, c
            label = f"chain {tile[0]}x{tile[1]} ({plan.unit_groups * -(-B // plan.rows)} CTAs)"
            check(f"{name} {label}", chain(), want, want64, True)
            variants.append((label, chain))
            bounds[label] = roofline.bound((T - 1) * B * N * G, nbytes(xz, Ut) + hc_bytes, "bfloat16")
        in_turns(name, variants, bounds)
        fwd_ms, _ = library_train([(W, U, b)], x, torch.zeros((T, B, N), device=dev), torch.bfloat16)
        print(f"[time] {name}: cuDNN bf16 LSTM forward (with its x-side) {fwd_ms:.3f} ms", flush=True)


def time_tree(dev):
    """``--time-tree DIR``: on the package this process imported first, K9f's
    and K6f's forward at the plan's tile and the chain alone at each tile,
    each checked against the plain bf16 version."""
    import svd_lstm_tpu_torch

    tree = os.path.dirname(os.path.dirname(svd_lstm_tpu_torch.__file__))
    for name, d in SHAPES:
        name = name.replace("K9", "K9f").replace("K6", "K6f")
        inp, Wk, U, bk, _ = inputs(dev, d)
        want = plain(inp, Wk, U, bk, True)
        want64 = plain(*(None if a is None else a.double() for a in (inp, Wk, U, bk)), True)
        check(f"{tree} {name}", ct.wide_fwd_bf16(inp, Wk, U, bk), want, want64, True)
        out = [f"wrapper {device_time_ms(ct.wide_fwd_bf16, inp, Wk, U, bk, repeats=9):.3f}"]
        if Wk is None:
            for tile in cb.BATCHED_TILES:
                plan = forced(tile)

                def chain(plan=plan):
                    h = torch.empty((T, B, N), device=dev)
                    c = torch.empty_like(h)
                    ct.phase_chain_fwd_bf16(inp, U.t().to(torch.bfloat16).contiguous(), h, c, plan)
                    return h, c
                check(f"{tree} {name} chain {tile}", chain(), want, want64, True)
                out.append(f"chain {tile[0]}x{tile[1]} {device_time_ms(chain, repeats=9):.3f}")
        print(f"[tree] {tree} {name}: " + ", ".join(out) + " ms", flush=True)


def trees(dirs):
    """Each tree's times in a fresh process, in turns."""
    for tree in dirs + dirs[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"--time-tree {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_wide_fwd: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--time-tree"]:
        with torch.no_grad():
            time_tree(dev)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if sys.argv[1:3] == ["--bf16", "--tree"]:
        trees([os.path.abspath(t) for t in sys.argv[3:]])
        return 0
    with exact_matmul(), torch.no_grad():
        if sys.argv[1:3] == ["--bf16", "--wide"]:
            bf16_wide(dev)
        elif sys.argv[1:2] == ["--bf16"]:
            bf16_parts(dev)
        else:
            float32_parts(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
