"""Accuracy against rank at the wide scale the timing wins are measured at:
a 3x512 stack, the merged truncation across ranks, the RMSE beside the
reduced/full time of batch-1 ``predict`` at every rank.

Counterpart of ``examples/wide_rank_accuracy.py``. It loads ``--ckpt``
(default the committed ``model_saves/pretrained_3x512_n1.5.npz``, read
only) or, where that is absent (``--quick``: a 2x64 stack, ranks 32 and 8),
trains one and saves it under ``torch_runs/model_saves/``; on the card the
training runs through the train kernels, as the JAX script's does on the
TPU. The surrogate DROPBEAR run (42 s, ``--noise``; 12 s split at 8 s with
``--quick``) is evaluated whole: the dense model, then for each rank its
merged truncation, each by a whole-run ``predict``, exact and
``precision="fast"`` (on the card K3 and K3f, K2 and K2f; the JAX script's
exact RMSE is ``predict_full_run``'s XLA scan, which the port's plain
Python scan would take minutes a model to match on the card, at the same
values), with the validation-gated recovery
(``recover_reduced_gated``, ``--recover-epochs`` at most) at ranks ≤ 64,
and on the card the batch-1 ``predict`` of each model timed at T = 6656
(CUDA events; K3 for the dense stack, K2 for the reduced). ``--progressive``
adds the progressive truncate-recover pipeline to r = 24.

The JSON goes to ``--out`` and the figure to ``--plot`` (defaults under
``torch_runs/``; ``--plot ""`` draws none), never to the committed
``model_saves/`` or ``plots/``.

    python -m svd_lstm_tpu_torch.examples.wide_rank_accuracy [--quick] [--recover-epochs 6] [--progressive] [--ckpt CKPT] [--out F] [--plot F] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from svd_lstm_tpu_torch import examples as ex

UNITS = (512, 512, 512)
RANKS = (256, 128, 64, 48, 32, 24, 16)
TIMING_T = 6656  # the bench.py wide operating point
RECOVER_MAX_RANK = 64
CKPT = "./model_saves/pretrained_3x512_n1.5.npz"


def _load_or_train(ckpt: str, save_dir: str, ds, units, quick: bool, epochs: int, dev):
    import torch

    import svd_lstm_tpu_torch as P

    if os.path.exists(ckpt):
        print(f"loaded {ckpt}")
        return P.load_params(ckpt, device=dev)
    tcfg = P.TrainConfig(epochs=2 if quick else epochs, batch_size=32 if quick else 128,
                         num_windows=512 if quick else 20_000, window_len=50 if quick else 200,
                         recurrence_kernel=dev.type == "cuda")
    print(f"training {'x'.join(map(str, units))} ({tcfg.epochs} epochs, kernel={tcfg.recurrence_kernel})...",
          flush=True)
    model = P.fit(P.init_stacked_lstm(torch.Generator().manual_seed(0), P.DataConfig().frame_width, units,
                                      device=dev), ds.X_train, ds.y_train, tcfg, verbose=True).params
    path = os.path.join(save_dir, os.path.basename(ckpt))
    os.makedirs(save_dir, exist_ok=True)
    P.save_params(path, model)
    print(f"saved {path}")
    return model


def run(model, ds, ranks=RANKS, rcfg=None, recover_epochs: int = 6, progressive_ranks=None,
        out: str = os.path.join(ex.SAVES, "wide_rank_accuracy.json"),
        plot: str = os.path.join(ex.PLOTS, "wide_rank_accuracy.png"), config: dict | None = None) -> dict:
    """The rank table of ``model`` (on its device) on ``ds``: each rank of
    ``ranks`` truncated, recovered at ranks ≤ 64 with ``rcfg`` for at most
    ``recover_epochs`` epochs, timed on the card; ``progressive_ranks``
    runs the progressive pipeline down that schedule. ``config`` goes into
    the JSON's config block. Returns the JSON's content."""
    import torch

    import svd_lstm_tpu_torch as P

    dev = next(model.parameters()).device
    on_card = dev.type == "cuda"
    rcfg = rcfg or P.TrainConfig(batch_size=128, num_windows=20_000, window_len=200)
    inv = lambda v: ex.to_metres(ds, v)  # noqa: E731
    y_true = inv(ds.y_test)
    x_test1 = torch.as_tensor(ds.X_test[0], dtype=torch.float32, device=dev)

    def rmse_of(m, precision: str = "exact") -> float:
        return P.rmse(y_true, inv(P.predict(m, x_test1, precision=precision)[:, 0]))
    full_rmse = rmse_of(model)
    full_w = sum(p.numel() for p in model.layers.parameters())  # the head is not counted
    full_fast_rmse = rmse_of(model, "fast")
    print(f"full model: RMSE {full_rmse * 1000:.3f} mm (fast {full_fast_rmse * 1000:.3f} mm)  weights {full_w}",
          flush=True)

    x_time = torch.tensor(np.random.default_rng(1).normal(size=(TIMING_T, model.layers[0].input_dim)),
                          dtype=torch.float32, device=dev)
    full_ms = None
    if on_card:
        full_ms = ex.time_ms(lambda: P.predict(model, x_time), dev=dev)
        print(f"full timing: {full_ms:.3f} ms (T={TIMING_T}, batch-1, {ex.clock(dev)})", flush=True)

    smodel = P.make_singular_model(model, merged_kernel=True)
    rows, recover_recipe = [], None
    for r in ranks:
        rmod = P.make_reduced_model(smodel, rank=r)
        e = rmse_of(rmod)
        red_w = sum(l.weight_count() for l in rmod.layers)
        e_fast = rmse_of(rmod, "fast")
        row = {"rank": r, "rmse_mm": round(float(e * 1000), 4), "rmse_ratio": round(float(e / full_rmse), 4),
               "rmse_fast_mm": round(float(e_fast * 1000), 4),
               "rmse_fast_ratio": round(float(e_fast / full_fast_rmse), 4),
               "weights": red_w, "weight_ratio": round(red_w / full_w, 4)}
        if recover_epochs and r <= RECOVER_MAX_RANK:
            rec, rinfo = P.recover_reduced_gated(rmod, ds.X_train, ds.y_train, train_cfg=rcfg,
                                                 max_epochs=recover_epochs, verbose=True)
            recover_recipe = {k: rinfo[k] for k in ("recipe", "lr_ladder", "clip", "max_epochs", "gate")}
            e_r = rmse_of(rec)
            row["rmse_recovered_mm"] = round(float(e_r * 1000), 4)
            row["recovered_ratio"] = round(float(e_r / full_rmse), 4)
            row["recovery"] = {"accepted_epochs": rinfo["accepted_epochs"],
                               "raw_val_mse": round(rinfo["raw_val_mse"], 6),
                               "best_val_mse": round(rinfo["best_val_mse"], 6), "trace": rinfo["trace"]}
        if on_card:
            red_ms = ex.time_ms(lambda: P.predict(rmod, x_time), dev=dev)
            row["reduced_ms"] = round(red_ms, 4)
            row["timing_ratio"] = round(red_ms / full_ms, 4)
        rows.append(row)
        print(f"r={r:3d}: RMSE {row['rmse_mm']:8.3f} mm (x{row['rmse_ratio']:.3f})  weights "
              f"x{row['weight_ratio']:.3f}"
              + (f"  recovered x{row['recovered_ratio']:.3f}" if "recovered_ratio" in row else "")
              + (f"  time x{row['timing_ratio']:.3f}" if on_card else ""), flush=True)

    prog = None
    if progressive_ranks:
        pranks = tuple(progressive_ranks)
        print(f"progressive pipeline: ranks {pranks}...", flush=True)
        rprog, infos = P.truncate_recover_progressive(model, ds.X_train, ds.y_train, ranks=pranks,
                                                      train_cfg=rcfg, max_epochs=recover_epochs,
                                                      verbose=True)
        e_p = rmse_of(rprog)
        e_pf = rmse_of(rprog, "fast")
        prog = {"ranks": list(pranks), "rmse_mm": round(float(e_p * 1000), 4),
                "rmse_ratio": round(float(e_p / full_rmse), 4), "rmse_fast_mm": round(float(e_pf * 1000), 4),
                "rmse_fast_ratio": round(float(e_pf / full_fast_rmse), 4),
                "stages": [{"rank": i["rank"], "accepted_epochs": i["accepted_epochs"],
                            "raw_val_mse": round(i["raw_val_mse"], 6),
                            "best_val_mse": round(i["best_val_mse"], 6)} for i in infos]}
        print(f"progressive r={pranks[-1]}: RMSE ratio {prog['rmse_ratio']:.3f}  fast "
              f"{prog['rmse_fast_ratio']:.3f}", flush=True)

    art = {
        "config": {"units": [l.units for l in model.layers], "merged_kernel": True, "timing_T": TIMING_T,
                   **(config or {}), "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "timing_clock": ex.clock(dev) if on_card else None, "recover": recover_recipe},
        "full_rmse_mm": round(float(full_rmse * 1000), 4),
        "full_rmse_fast_mm": round(float(full_fast_rmse * 1000), 4),
        "progressive_r24": prog,
        "full_weights": full_w,
        "full_ms": full_ms,
        "rows": rows,
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(art, f, indent=1)
    print(f"wrote {out}")
    if plot:
        _plot(rows, on_card, plot)
    else:
        print("--plot '': no figure written (wide_rank_accuracy)")
    return art


def _plot(rows: list, timed: bool, path: str) -> None:
    from svd_lstm_tpu_torch.viz.plots import pyplot

    plt = pyplot()
    fig, ax1 = plt.subplots(figsize=(7, 4.2))
    rs = [row["rank"] for row in rows]
    ax1.plot(rs, [row["rmse_ratio"] for row in rows], "o-", color="tab:blue", label="RMSE(reduced)/RMSE(full)")
    rec = [(row["rank"], row["recovered_ratio"]) for row in rows if "recovered_ratio" in row]
    if rec:
        ax1.plot(*zip(*rec), "^-", color="tab:green", label="after recovery fine-tune")
        ax1.legend(loc="upper left", fontsize=8)
    ax1.axhline(1.0, color="gray", lw=0.6)
    ax1.set_xlabel("retained rank r (of 512)")
    ax1.set_ylabel("RMSE ratio", color="tab:blue")
    ax1.set_xscale("log", base=2)
    ax1.invert_xaxis()
    if timed:
        ax2 = ax1.twinx()
        ax2.plot(rs, [row["timing_ratio"] for row in rows], "s--", color="tab:red",
                 label="time(reduced)/time(full)")
        ax2.set_ylabel("device-time ratio", color="tab:red")
        ax2.axhline(1.0, color="tab:red", lw=0.5, ls=":")
    fig.suptitle("3x512 merged truncation: accuracy AND timing vs rank")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch.examples.wide_rank_accuracy",
                                 description="Accuracy and timing against rank at 3x512.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--epochs", type=int, default=8, help="training epochs where no checkpoint exists")
    ap.add_argument("--recover-epochs", type=int, default=6,
                    help="max epochs of the validation-gated recovery at ranks <= 64; 0 disables")
    ap.add_argument("--progressive", action="store_true",
                    help="also the progressive truncate-recover pipeline to r = 24")
    ap.add_argument("--noise", type=float, default=1.5)
    ap.add_argument("--ckpt", default=CKPT, help=f"checkpoint to read (default {CKPT})")
    ap.add_argument("--out", default=None, help=f"JSON path (default under {ex.SAVES})")
    ap.add_argument("--plot", default=None, help=f"figure path (default under {ex.PLOTS}); '' draws none")
    ex.add_device(ap)
    args = ap.parse_args(argv)

    import svd_lstm_tpu_torch as P

    dev = ex.device_of(args.device)
    print(f"device: {dev}", flush=True)
    quick, sfx, ckpt = args.quick, "_quick" if args.quick else "", args.ckpt
    if quick:
        root, ext = os.path.splitext(ckpt)
        ckpt = f"{root}_quick{ext}"
    ds = ex.quick_dataset(duration=12.0 if quick else 42.0,
                          split_time=8.0 if quick else P.DataConfig().split_time, noise=args.noise)
    model = _load_or_train(ckpt, ex.SAVES, ds, (64, 64) if quick else UNITS, quick, args.epochs, dev)
    rcfg = P.TrainConfig(batch_size=32 if quick else 128, num_windows=512 if quick else 20_000,
                         window_len=50 if quick else 200)
    return run(model, ds, ranks=(32, 8) if quick else RANKS, rcfg=rcfg, recover_epochs=args.recover_epochs,
               progressive_ranks=((8, 4) if quick else (32, 24)) if args.progressive else None,
               out=args.out or os.path.join(ex.SAVES, f"wide_rank_accuracy{sfx}.json"),
               plot=os.path.join(ex.PLOTS, f"wide_rank_accuracy{sfx}.png") if args.plot is None else args.plot,
               config={"noise": args.noise,
                       "dataset": "synthetic DROPBEAR surrogate" + (" (quick)" if quick else "")})


if __name__ == "__main__":
    main()
