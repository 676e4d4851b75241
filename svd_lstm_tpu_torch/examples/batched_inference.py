"""Batched multi-sequence inference: B independent sequences in one
``predict``.

Counterpart of ``examples/batched_inference.py``, which shards the
sequences over a dp mesh of devices. The command runs on one card, so the
whole batch is one shard (B = ``--batch``); over several ranks the same
split is ``parallel.train.make_batched_inference`` (and
``make_batched_fast_inference``). ``--precision fast``
runs the batched fast path (bf16 x-side products, K5 a layer on the card);
``exact`` and ``high`` run the plain scan. In exact mode the batch's output
is compared with each sequence run alone through the plain scan, as the
JAX script compares its sharded output with the unsharded one. ``--rank R``
also runs the split rank-R truncation through the same path.

    python -m svd_lstm_tpu_torch batched [--wide] [--batch 64] [--steps 256] [--quick] [--precision exact] [--rank R] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np

from svd_lstm_tpu_torch import examples as ex

D = 16


def run(units=(40, 40, 40, 40), batch: int = 64, steps: int = 256, precision: str = "exact",
        rank: int = 0, device: str = "cuda", repeats: int = 2) -> dict:
    """One batched ``predict`` of a seeded stack on (batch, steps, 16)
    standard normal sequences (numpy's seed 0), timed; the exact mode's
    batch-vs-sequence error; with ``rank`` the reduced model's too."""
    import torch

    import svd_lstm_tpu_torch as P

    dev = ex.device_of(device)
    print(f"devices: 1 x {dev.type}")
    params = P.init_stacked_lstm(torch.Generator().manual_seed(0), D, units, device=dev)
    X = torch.tensor(np.random.default_rng(0).normal(size=(batch, steps, D)), dtype=torch.float32,
                     device=dev)
    out = P.predict(params, X, precision=precision)
    dt_ms = ex.time_ms(lambda: P.predict(params, X, precision=precision), dev=dev, repeats=repeats)
    res = {"out": out, "ms": dt_ms, "err": None}
    if precision == "exact":
        with P.exact_matmul(), torch.no_grad():
            ref = torch.cat([P.stacked_lstm_apply(params, X[i : i + 1]) for i in range(batch)])
        res["err"] = float((out - ref).abs().max())
        note = f"shard-vs-local err {res['err']:.2e} (one shard: the batch against each sequence alone)"
    else:
        # a reduced-precision forward against exact float32 would show its
        # roundoff, not a batching error
        note = f"precision={precision} (roundoff vs f32 expected)"
    print(f"batched {batch} sequences x {steps} steps on 1 device: {dt_ms:.1f} ms ({ex.clock(dev)}), "
          f"{batch * steps / (dt_ms / 1e3) / 1e6:.2f} M steps/s, {note}")

    if rank:
        rmodel = P.make_reduced_model(P.make_singular_model(params, merged_kernel=False), rank=rank)
        out_r = P.predict(rmodel, X, precision=precision)
        dt_r = ex.time_ms(lambda: P.predict(rmodel, X, precision=precision), dev=dev, repeats=repeats)
        res.update(out_reduced=out_r, reduced_ms=dt_r, reduced_err=float((out_r - out).abs().max()))
        if precision != "exact":
            why = (f"compared against the precision={precision!r} full output — dominated by its "
                   "reduced-precision roundoff")
        elif rank >= min(units):
            why = "exact two-step reconstruction — should be ~1e-6"
        else:
            why = f"genuine truncation (r={rank} < n={min(units)}) — error reflects discarded sigmas"
        print(f"reduced (r={rank}) batched: {dt_r:.1f} ms, {batch * steps / (dt_r / 1e3) / 1e6:.2f} "
              f"M steps/s, reduced-vs-full err {res['reduced_err']:.2e} ({why})")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch batched",
                                 description="Batched multi-sequence inference on one device.")
    ap.add_argument("--wide", action="store_true", help="the 3x512 model")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--quick", action="store_true", help="tiny shapes (B = 4, 32 steps)")
    ap.add_argument("--precision", default="exact", choices=["exact", "high", "fast"],
                    help="predict's precision: fast = bf16 products, K5 on the card")
    ap.add_argument("--rank", type=int, default=0,
                    help="also run the split rank-R truncation through the same path")
    ex.add_device(ap)
    args = ap.parse_args(argv)
    if args.quick:
        args.batch, args.steps = 4, 32
    units = (512, 512, 512) if args.wide else (40, 40, 40, 40)
    return run(units, args.batch, args.steps, args.precision, args.rank, device=args.device)


if __name__ == "__main__":
    main()
