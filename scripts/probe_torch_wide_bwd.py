#!/usr/bin/env python3
"""Design trials of the wide-layer train backward of the PyTorch port (K9's
and K6's four phases: R, the GEMM that recomputes z; C, the dh chain; X, dx;
G, the weight gradients) on one CUDA card.

    python3 scripts/probe_torch_wide_bwd.py

At run C's shapes (one 512-unit layer, d = 512, B = 128, T = 200; random
weights and cotangent from seed 0, h and c from the plain forward) it
prints the phase split of the rule's backward (K9 at run C's shapes, K6 at
run D's), each phase beside its bound and beside cuBLAS computing the same
products (float32, TF32 off; a yardstick the port never calls), then times
in turns in one process (a, b, b, a: the card and its neighbours change
between calls), each variant checked against the plain gradients (within
1e-3 × each gradient's largest value, chip_smoke.py's limit):

* phase C's weight home: U staged (the rule at n = 512) against the global
  copy (the rule from n = 896 on);
* phase G: the GEMM (TN form, dW and db in one product, dU in another, one
  ordered sum of the splits; the rule) against ``weight_grad`` (the 64×64
  tile K7 and K8 use) for dW, dU and db.

Then the bf16 backward (K9f at run C's shapes, K6f at run D's): each phase
of ``wide_bwd_bf16`` alone (the operands' bf16 copies; R, X and G on
``gemm_bf16``; C, the bf16 chain) beside its bf16 bound (989 TFLOP/s, or
the bytes at 3.35 TB/s) and cuBLAS in bf16 on the same products, and the
whole backward beside cuDNN's bf16 LSTM backward, each checked against the
plain bf16 gradients (within chip_smoke.py's ``fast_limit``).

    python3 scripts/probe_torch_wide_bwd.py --tree DIR [DIR ...]

times K9's backward at run C's shapes, each phase alone and whole (phase C
also at B = 32), on the package of each checkout DIR, each in a fresh
process, in turns (DIR1, DIR2, ..., ..., DIR2, DIR1), after checking its
gradients: trial trees, copies of the package with a kernel edited (phase
C's tile R × J, its grid barrier, its product or its reads of the partial
sums taken out; the GEMM's tile), for the variants the rule does not take.
On a tree with the bf16 backward (``wide_bwd_bf16``) it also times its
chain at B = 128 and 32 and K9f's and K6f's whole backward, unchecked: a
trial tree may take a part of the bf16 chain out.

Prints the card's name and power limit first. Imports torch and the port,
never JAX.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if __name__ == "__main__" and sys.argv[1:2] == ["--time-tree"]:
    sys.path.insert(0, os.path.abspath(sys.argv[2]))  # a trial tree's package before this one

from svd_lstm_tpu_torch.api import exact_matmul  # noqa: E402
from svd_lstm_tpu_torch.bench.devtime import device_time_ms  # noqa: E402
from svd_lstm_tpu_torch.ops import cuda_train as ct  # noqa: E402

N, B, T = 512, 128, 200
GRAD_RTOL = 1e-3  # chip_smoke.py's limit: 1e-3 × the largest plain value
PEAK_FLOPS, HBM_BYTES_PER_S = 67e12, 3.35e12  # H100 SXM: float32 on the CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM: dense bf16 on the tensor cores


def layer(din, dev, seed):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(rng.normal(scale=scale, size=shape), dtype=torch.float32, device=dev)

    W, U, b = t((din, 4 * N), din ** -0.5), t((N, 4 * N), N ** -0.5), t((4 * N,), 0.1)
    x = t((T, B, din))
    h, c = ct.wide_layer_fwd_plain(x, W, U, b)
    return x, W, U, b, h, c, t((T, B, N))


def check(name, got, want):
    for i, (a, r) in enumerate(zip(got, want)):
        err, lim = float((a - r).abs().max()), GRAD_RTOL * float(r.abs().max())
        if not err <= lim:
            raise SystemExit(f"{name}: gradient {i}: max abs err {err:.3g} over {lim:.3g}")
    print(f"[check] {name}: within {GRAD_RTOL} of each gradient's largest value")


def in_turns(name, variants, *args):
    """Times the variants in turns: each label's ms in the order of the runs."""
    order = variants + variants[::-1]
    ms = [device_time_ms(fn, *args) for _, fn in order]
    print(f"[time] {name}, in turns: "
          + ", ".join(f"{label} {t:.3f}" for (label, _), t in zip(order, ms)) + " ms")


def bound_ms(flops, nbytes, peak=PEAK_FLOPS):
    ops, moved = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return f"bound {max(ops, moved):.4f} ms ({'operations' if ops >= moved else 'bytes'})"


def bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(max(v, 1e-30))) - 7)


def check_fast(name, got, want, want64):
    """chip_smoke.py's fast_limit: within max(2 bf16 ulps of the plain
    output's largest value, 2 x the plain version's distance from float64)."""
    for i, (a, r, r64) in enumerate(zip(got, want, want64)):
        lim = max(2 * bf16_ulp(float(r.abs().max())), 2 * float((r.double() - r64).abs().max()))
        err = float((a.double() - r.double()).abs().max())
        if not err <= lim:
            raise SystemExit(f"{name}: gradient {i}: max abs err {err:.3g} over {lim:.3g}")
    print(f"[check] {name}: within fast_limit of each plain bf16 gradient")


def phase_split_bf16(name, x, W, U, b, h, c, dh, sms):
    """Each phase of the bf16 backward alone (``wide_bwd_bf16``), beside its
    bf16 bound and cuBLAS in bf16 on the same products."""
    M, G, n = T * B, 4 * N, N
    din = 0 if W is None else x.shape[2]
    plan = ct.chain_plan(B, n, sms, ct.chain_smem_bytes_bf16)
    ops = ct.bf16_operands(x, W, U, h)
    xp = x if W is None else None
    z = ct.phase_r_bf16(ops, b, xp, B)
    dz = torch.empty((T, B, G), dtype=torch.float32, device=x.device)
    dzb = torch.empty((M, G), dtype=torch.bfloat16, device=x.device)
    ct.phase_c_bf16(z, ops.U, c, dh, dz, dzb, plan)
    f4, b2 = 4, 2  # bytes a float, a bf16
    copied = h.numel() + U.numel() + (0 if W is None else x.numel() + W.numel())
    rows = [("copies", lambda: ct.bf16_operands(x, W, U, h), 0, (f4 + b2) * copied),
            ("R", lambda: ct.phase_r_bf16(ops, b, xp, B), 2 * M * (din + n) * G,
             b2 * copied + f4 * z.numel() * (2 if W is None else 1)),
            ("C", lambda: ct.phase_c_bf16(z, ops.U, c, dh, dz, dzb, plan), 2 * (T - 1) * B * G * n,
             f4 * (z.numel() + c.numel() + dh.numel() + dz.numel()) + b2 * (U.numel() + dzb.numel()))]
    if W is not None:
        rows.append(("X", lambda: ct.phase_x_bf16(dzb, ops.W, din), 2 * M * G * din,
                     b2 * (dzb.numel() + W.numel()) + f4 * x.numel()))
        rows.append(("G", lambda: ct.phase_g_bf16(ops, dzb, dz, din, B, sms), 2 * M * G * (din + n),
                     b2 * (dzb.numel() + x.numel() + h.numel()) + f4 * (dz.numel() + (din + n + 1) * G)))
    else:
        rows.append(("G", lambda: ct.phase_g_bf16(ops, dzb, dz, 0, B, sms), 2 * M * G * n,
                     b2 * (dzb.numel() + h.numel()) + f4 * n * G))
    hb, Ub, x2 = ops.h, ops.U, x.reshape(M, -1).bfloat16()
    hp = torch.cat([torch.zeros((B, n), dtype=torch.bfloat16, device=h.device), hb[:-B]])
    cublas = {"copies": lambda: (h.bfloat16(), U.bfloat16()) if W is None else
              (h.bfloat16(), U.bfloat16(), x.bfloat16(), W.bfloat16()),
              "C": lambda: [torch.mm(dzb[t * B:(t + 1) * B], Ub.t()) for t in range(T)]}
    if W is None:
        cublas["R"] = lambda: torch.mm(hp, Ub)
        cublas["G"] = lambda: torch.mm(hp.t(), dzb)
    else:
        Wb = W.bfloat16()
        cublas["R"] = lambda: torch.addmm(torch.mm(x2, Wb), hp, Ub)
        cublas["X"] = lambda: torch.mm(dzb, Wb.t())
        cublas["G"] = lambda: (torch.mm(x2.t(), dzb), torch.mm(hp.t(), dzb), dz.sum((0, 1)))
    total = 0.0
    for phase, fn, flops, nbytes in rows:
        ms = device_time_ms(fn)
        total += ms
        rate = f", {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""
        print(f"[phase] {name} {phase}: {ms:.3f} ms{rate}, {bound_ms(flops, nbytes, PEAK_BF16_FLOPS)}; "
              f"cuBLAS bf16 {device_time_ms(cublas[phase]):.3f} ms")
    print(f"[phase] {name}: phases sum {total:.3f} ms; plan {plan}")


def cudnn_bwd_bf16(din, W, U, b, x, dh):
    """cuDNN's bf16 LSTM backward from dh (every gradient) at the layer's
    shapes: ms (TF32 off; a yardstick the port never calls)."""
    lstm = torch.nn.LSTM(din, N).to(x.device, torch.bfloat16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(W.t())
        lstm.weight_hh_l0.copy_(U.t())
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    xs = x.detach().bfloat16().requires_grad_(True)
    with torch.enable_grad():
        out = lstm(xs)[0]
        return device_time_ms(lambda: torch.autograd.backward(out, dh.bfloat16(), retain_graph=True))


def phase_split(name, x, W, U, b, h, c, dh, sms):
    """Each phase of the rule's backward alone, beside its bound."""
    M, G, n = T * B, 4 * N, N
    din = 0 if W is None else x.shape[2]
    plan = ct.chain_plan(B, n, sms)
    z = ct.phase_r(x, W, U, b, h)
    dz = torch.empty_like(z)
    Ut = U.t().contiguous()
    ct.phase_c(z, Ut, c, dh, dz, plan)
    f4 = 4  # bytes a float
    rows = [("R", lambda: ct.phase_r(x, W, U, b, h), 2 * M * (din + n) * G,
             f4 * (x.numel() + h.numel() + U.numel() + (0 if W is None else W.numel()) + z.numel())),
            ("C", lambda: ct.phase_c(z, Ut, c, dh, dz, plan), 2 * (T - 1) * B * G * n,
             f4 * (z.numel() + U.numel() + c.numel() + dh.numel() + dz.numel()))]
    if W is not None:
        rows.append(("X", lambda: ct.phase_x(dz, W), 2 * M * G * din, f4 * (dz.numel() + W.numel() + x.numel())))
        rows.append(("G", lambda: ct.phase_g(x, h, dz, sms), 2 * M * G * (din + n + 1),
                     f4 * (dz.numel() + x.numel() + h.numel() + (din + n + 1) * G)))
    else:
        rows.append(("G", lambda: ct.phase_g(None, h, dz, sms), 2 * M * G * n,
                     f4 * (dz.numel() + h.numel() + n * G)))
    # cuBLAS on the same products (the phase's yardstick; C has none: its
    # product is one (B, 4n)·(4n, n) per step)
    Mr = T * B
    x2, h2, dz2 = x.reshape(Mr, -1), h.reshape(Mr, n), dz.reshape(Mr, G)
    hp = torch.cat([torch.zeros((B, n), device=h.device), h2[:-B]])
    cublas = {"C": lambda: [torch.mm(dz[t], U.t()) for t in range(T)]}
    if W is None:
        cublas["R"] = lambda: torch.addmm(x2, hp, U)
        cublas["G"] = lambda: torch.mm(hp.t(), dz2)
    else:
        cublas["R"] = lambda: torch.addmm(torch.addmm(b, x2, W), hp, U)
        cublas["X"] = lambda: torch.mm(dz2, W.t())
        cublas["G"] = lambda: (torch.mm(x2.t(), dz2), torch.mm(hp.t(), dz2), dz2.sum(0))
    total = 0.0
    for phase, fn, flops, nbytes in rows:
        ms = device_time_ms(fn)
        total += ms
        print(f"[phase] {name} {phase}: {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms(flops, nbytes)}; cuBLAS {device_time_ms(cublas[phase]):.3f} ms")
    print(f"[phase] {name}: phases sum {total:.3f} ms; plan {plan}")


def time_tree(dev):
    """``--time-tree DIR``: on the package this process imported first, K9's
    backward at run C's shapes checked against the plain gradients, then
    timed by phase and whole, and phase C alone at B = 32."""
    import svd_lstm_tpu_torch

    tree = os.path.dirname(os.path.dirname(svd_lstm_tpu_torch.__file__))
    sms = ct.sm_count(dev)
    with exact_matmul(), torch.no_grad():
        x, W, U, b, h, c, dh = args = layer(N, dev, 0)
        check(f"{tree} K9 bwd", ct.wide_bwd(*args), ct.wide_layer_bwd_plain(*args))
        plan = ct.chain_plan(B, N, sms)
        z = ct.phase_r(x, W, U, b, h)
        dz = torch.empty_like(z)
        Ut = U.t().contiguous()
        ct.phase_c(z, Ut, c, dh, dz, plan)
        parts = {"R": lambda: ct.phase_r(x, W, U, b, h),
                 "C": lambda: ct.phase_c(z, Ut, c, dh, dz, plan),
                 "X": lambda: ct.phase_x(dz, W),
                 "G": lambda: ct.phase_g(x, h, dz, sms),
                 "whole": lambda: ct.wide_bwd(*args)}
        print(f"[tree] {tree} B={B}: " + ", ".join(f"{k} {device_time_ms(fn, repeats=9):.3f}"
                                                  for k, fn in parts.items()) + " ms", flush=True)
        b32 = [t[:, :32].contiguous() for t in (z, c, dh, dz)]
        plan32 = ct.chain_plan(32, N, sms)
        ms = device_time_ms(lambda: ct.phase_c(b32[0], Ut, *b32[1:], plan32), repeats=9)
        print(f"[tree] {tree} B=32: C {ms:.3f} ms, {ms / T * 1e3:.2f} us a step", flush=True)
        if not hasattr(ct, "wide_bwd_bf16"):
            return
        out = []
        for rows in (B, 32):
            xr, hr, cr, dhr = (a[:, :rows].contiguous() for a in (x, h, c, dh))
            plan16 = ct.chain_plan(rows, N, sms, ct.chain_smem_bytes_bf16)
            ops = ct.bf16_operands(xr, W, U, hr)
            z16 = ct.phase_r_bf16(ops, b, None, rows)
            dz16 = torch.empty((T, rows, 4 * N), device=dev)
            dzb16 = torch.empty((T * rows, 4 * N), dtype=torch.bfloat16, device=dev)
            ms = device_time_ms(lambda: ct.phase_c_bf16(z16, ops.U, cr, dhr, dz16, dzb16, plan16), repeats=9)
            out.append(f"bf16 C B={rows} {ms:.3f} ms ({ms / T * 1e3:.2f} us a step)")
        xp = (torch.matmul(x, W) + b).contiguous()
        out.append(f"K9f {device_time_ms(lambda: ct.wide_bwd(*args, True), repeats=9):.3f}")
        out.append(f"K6f {device_time_ms(lambda: ct.wide_bwd(xp, None, U, None, h, c, dh, True), repeats=9):.3f}")
        print(f"[tree] {tree} (unchecked): " + ", ".join(out) + " ms", flush=True)


def trees(dirs):
    """Each tree's times in a fresh process, in turns."""
    for tree in dirs + dirs[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree", tree],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"--time-tree {tree} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        print(proc.stdout.strip(), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_wide_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--time-tree"]:
        time_tree(dev)
        return 0
    if sys.argv[1:2] == ["--tree"]:
        trees([os.path.abspath(t) for t in sys.argv[2:]])
        return 0
    sms = ct.sm_count(dev)
    shape = f"n={N}, d={N}, B={B}, T={T}"
    with exact_matmul(), torch.no_grad():
        x, W, U, b, h, c, dh = args = layer(N, dev, 0)
        want = ct.wide_layer_bwd_plain(*args)
        phase_split(f"K9 ({shape})", *args, sms)
        xp = (torch.matmul(x[:, :, :16], W[:16]) + b).contiguous()  # run D's xp: d = 16
        hr, cr = ct.lstm_recurrence_train_fwd_plain(xp, U)
        phase_split(f"K6 (n={N}, B={B}, T={T})", xp, None, U, None, hr, cr, dh, sms)

        # phase C: the weight home (each variant's whole backward checked)
        z = ct.phase_r(x, W, U, b, h)
        Ut = U.t().contiguous()
        homes = []
        for staged in (True, False):
            plan = ct.chain_plan(B, N, sms)
            plan = plan._replace(staged=staged,
                                 smem_bytes=ct.chain_smem_bytes(N, plan.rows, plan.units, staged))
            dz = torch.empty_like(z)
            ct.phase_c(z, Ut, c, dh, dz, plan)
            label = "staged" if staged else "global copy"
            check(f"K9 bwd, chain {label}", (ct.phase_x(dz, W), *ct.phase_g(x, h, dz, sms)), want)
            homes.append((label, lambda plan=plan, dz=dz: ct.phase_c(z, Ut, c, dh, dz, plan)))
        in_turns(f"phase C weight home ({shape})", homes)

        # phase G: the GEMM against weight_grad
        dW, dU, db = ct._layer_weight_grads(x, h, dz)
        check("K9 bwd, weight_grad for dW, dU, db", (ct.phase_x(dz, W), dW, dU, db), want)
        in_turns(f"phase G dW, dU, db ({shape})",
                 [("gemm_f32", lambda: ct.phase_g(x, h, dz, sms)),
                  ("weight_grad", lambda: ct._layer_weight_grads(x, h, dz))])

        # the bf16 backward (K9f, K6f): phases, whole, cuDNN bf16
        hf, cf = ct.wide_layer_fwd_plain(x, W, U, b, True)
        f_args = (x, W, U, b, hf, cf, dh)
        x64 = [t.double() for t in f_args]
        check_fast("K9f bwd", ct.wide_bwd(*f_args, True), ct.wide_layer_bwd_plain(*f_args, True),
                   ct.wide_layer_bwd_plain(*x64, True))
        phase_split_bf16(f"K9f ({shape})", *f_args, sms)
        print(f"[time] K9f bwd ({shape}): {device_time_ms(lambda: ct.wide_bwd(*f_args, True)):.3f} ms, "
              f"cuDNN bf16 {cudnn_bwd_bf16(N, W, U, b, x, dh):.3f} ms")
        hr, cr = ct.lstm_recurrence_train_fwd_plain(xp, U, True)
        r_args = (xp, None, U, None, hr, cr, dh)
        rp_args = (xp, U, hr, cr, dh)
        check_fast("K6f bwd", ct.wide_bwd(*r_args, True), ct.lstm_recurrence_train_bwd_plain(*rp_args, True),
                   ct.lstm_recurrence_train_bwd_plain(*(t.double() for t in rp_args), True))
        phase_split_bf16(f"K6f (n={N}, B={B}, T={T})", *r_args, sms)
        print(f"[time] K6f bwd (n={N}, B={B}, T={T}): "
              f"{device_time_ms(lambda: ct.wide_bwd(*r_args, True)):.3f} ms, cuDNN bf16 "
              f"{cudnn_bwd_bf16(16, W[:16], U, b, x[:, :, :16], dh):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
