"""SVD compression workflow: factorize -> Hoyer fine-tune -> truncate ->
time and score the full and the reduced model.

Counterpart of ``examples/svd_acceleration.py`` (reference
code/svd_acceleration_v3.py:110-204): load the pretrained model (or train
one), make the singular model (split kernels unless ``--merged-kernel``),
fine-tune σ under the Hoyer penalty, count the recurrent σ below the cutoff,
truncate at it, optionally recover the factors (``--recover-epochs``) or
fine-tune through the int8 grid (``--qat-epochs``), time one whole-run
batch-1 ``predict`` of each model, and report the weight counts, RMSE and
SNR in metres, the overlay figure and, with ``--export``, the deployment
artifacts.

On the card ``--kernel`` trains through the train kernels (K7 at B = 64, as
the JAX script's fused Pallas engine), ``predict`` runs K1 for both models
(the reduced one on its exact dense reconstruction), and the timings are
CUDA events (``bench/devtime.py``). The whole-run accuracy evaluation of
the full model is ``predict_full_run`` (the plain scan), as in the JAX
script; the reduced model's is its timed ``predict``.

    python -m svd_lstm_tpu_torch compress [--quick] [--ckpt PATH] [--kernel] [--plots DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from svd_lstm_tpu_torch import examples as ex

TIMED_STEPS = 16384  # the JAX script times a bounded slice of the run


def weight_counts(model, rmodel) -> tuple:
    """(full, reduced) stored weights, the JAX script's accounting: every
    dense layer's W, U, b and the head; each reduced layer's ``weight_count``
    and the head."""
    head = lambda m: m.head.w.numel() + m.head.b.numel()  # noqa: E731
    full = sum(t.numel() for l in model.layers for t in (l.W, l.U, l.b)) + head(model)
    red = sum(l.weight_count() for l in rmodel.layers) + head(rmodel)
    return int(full), int(red)


def run(ds, ft_cfg, fcfg, ckpt: str = ex.PRETRAINED, units=(40, 40, 40, 40),
        recover_epochs: int = 0, qat_epochs: int = 0, export: str | None = None,
        plots: str = ex.PLOTS, device: str = "cuda", repeats: int = 2) -> dict:
    """The workflow on the dataset ``ds`` with the fine-tune's TrainConfig
    ``ft_cfg`` (also the fresh model's, where ``ckpt`` does not exist) and
    the FactorConfig ``fcfg``. Returns the models and every reported
    number."""
    import torch

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.viz.plots import plot_prediction_overlay

    dev = ex.device_of(device)
    if os.path.exists(ckpt):
        model = P.load_params(ckpt, device=dev)
        print(f"loaded pretrained model from {ckpt}")
    else:
        print("no checkpoint found — training a fresh model first")
        model = P.init_stacked_lstm(torch.Generator().manual_seed(0), 16, units, device=dev)
        model = P.fit(model, ds.X_train, ds.y_train, ft_cfg, verbose=True).params

    smodel = P.make_singular_model(model, merged_kernel=fcfg.merged_kernel)
    print("fine-tuning singular model (Hoyer regularizer on σ)...")
    smodel = P.finetune(smodel, ds.X_train, ds.y_train, fcfg, ft_cfg, verbose=True).params

    below = []
    for li, (_, su) in enumerate(P.harvest_sigmas(smodel)):
        # magnitude compare, as truncate_singular_layer's |σ| > cutoff
        below.append(int((np.abs(su) < fcfg.cutoff).sum()))
        print(f"layer {li}: {below[-1]}/{su.size} recurrent σ below cutoff")
    rmodel = P.make_reduced_model(smodel, cutoff=fcfg.cutoff)

    if recover_epochs:
        print("recovery fine-tune of the truncated model (B/C factors)...")
        rcfg = dataclasses.replace(ft_cfg, epochs=recover_epochs)
        rmodel = P.finetune_reduced(rmodel, ds.X_train, ds.y_train, train_cfg=rcfg, verbose=True).params
    if qat_epochs:
        print("QAT fine-tune of the reduced model (int8 STE view)...")
        # the train kernels have no QAT view; the STE wrapper runs the scan
        qcfg = dataclasses.replace(ft_cfg, epochs=qat_epochs, recurrence_kernel=False)
        rmodel = P.fit(rmodel, ds.X_train, ds.y_train, qcfg,
                       apply_fn=P.qat_apply(P.reduced_lstm_apply), verbose=True).params

    # timing: one whole-run batch-1 predict of each model on a bounded slice
    X = torch.as_tensor(ds.X[0], dtype=torch.float32, device=dev)
    Xt = X[:TIMED_STEPS]
    t_full = ex.time_ms(P.predict, model, Xt, dev=dev, repeats=repeats)
    t_red = ex.time_ms(P.predict, rmodel, Xt, dev=dev, repeats=repeats)
    print(f"full model timing:    {t_full:.3f} ms ({ex.clock(dev)}, T={Xt.shape[0]})")
    print(f"reduced model timing: {t_red:.3f} ms ({ex.clock(dev)})")
    print(f"ratio reduced/full:   {t_red / t_full:.3f}  (reference: 1.31)")

    full_w, red_w = weight_counts(model, rmodel)
    print(f"{full_w} weights in full model")
    print(f"{red_w} weights in reduced model")
    print(f"{100 - red_w / full_w * 100:.2f} percent reduction in weights")

    fy = P.predict_full_run(model, ds.X)
    ry = P.predict(rmodel, X)[:, 0]
    y_m, fy_m, ry_m = ex.to_metres(ds, ds.y), ex.to_metres(ds, fy), ex.to_metres(ds, ry)
    out = {
        "model": model, "smodel": smodel, "rmodel": rmodel, "below": below,
        "full_weights": full_w, "reduced_weights": red_w, "full_ms": t_full, "reduced_ms": t_red,
        "rmse_reduced": P.rmse(y_m, ry_m), "rmse_full": P.rmse(y_m, fy_m),
        "snr_reduced": P.signaltonoise(y_m, ry_m), "snr_full": P.signaltonoise(y_m, fy_m),
        "noise_full_to_reduced": P.signaltonoise(fy_m, ry_m, invert=True),
    }
    print(f"{out['rmse_reduced']:.6f} m RMSE of reduced model")
    print(f"{out['rmse_full']:.6f} m RMSE of full model")
    print(f"{out['rmse_reduced'] / max(out['rmse_full'], 1e-12) * 100 - 100:.2f} percent increase in RMSE")
    print(f"{out['snr_reduced']:.2f} dB SNR of reduced model")
    print(f"{out['snr_full']:.2f} dB SNR of full model")
    print(f"{out['noise_full_to_reduced']:.2f} dB noise from full to reduced model")

    path = ex.figure_path(plots, "svd_acceleration_prediction.png")
    if path:
        plot_prediction_overlay(ds.t, y_m, {"reduced model": ry_m, "full model": fy_m}, savepath=path)
        print(f"figure written to {path}")

    if export:
        from svd_lstm_tpu_torch.io.native import save_reduced_weights_as_csv

        os.makedirs(export, exist_ok=True)
        save_reduced_weights_as_csv(rmodel, export)
        print(f"two-step CSV export -> {export}/")
        if not fcfg.merged_kernel:
            from svd_lstm_tpu_torch.io.int8_export import save_model_int8_bin

            bin_path = os.path.join(export, "model_int8.bin")
            print(f"int8 native artifact -> {bin_path} ({save_model_int8_bin(rmodel, bin_path)} bytes)")
        else:
            print("int8 binary skipped: the artifact format is split-only")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch compress",
                                 description="Factorize, Hoyer fine-tune, truncate, time and score.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt", default=ex.PRETRAINED)
    ex.add_plots(ap)
    ap.add_argument("--hoyer", type=float, default=0.01)
    ap.add_argument("--trace-norm", type=float, default=0.0,
                    help="nuclear-norm sparsifier on the σ vectors (composable with --hoyer)")
    ap.add_argument("--orthogonal", type=float, default=0.0)
    ap.add_argument("--cutoff", type=float, default=0.05)
    ap.add_argument("--merged-kernel", action="store_true")
    ap.add_argument("--kernel", action="store_true",
                    help="train through the train kernels (TrainConfig.recurrence_kernel): the "
                    "fresh model's fit and the singular fine-tune (its dense view)")
    ap.add_argument("--recover-epochs", type=int, default=0,
                    help="after truncation, train the two-step factors for N epochs (finetune_reduced)")
    ap.add_argument("--qat-epochs", type=int, default=0,
                    help="after truncation, fine-tune the reduced model through the int8 grid for N epochs")
    ap.add_argument("--export", default=None, metavar="DIR",
                    help="write the truncated model's two-step CSVs and, split, its int8 .bin")
    ex.add_device(ap)
    args = ap.parse_args(argv)

    from svd_lstm_tpu_torch.config import FactorConfig, TrainConfig

    if args.quick:
        ds = ex.quick_dataset(duration=12.0, split_time=8.0)
        ft_cfg = TrainConfig(num_windows=1024, window_len=100, epochs=2, batch_size=64,
                             recurrence_kernel=args.kernel)
        units = (40, 40)
    else:
        ds = ex.full_dataset()
        ft_cfg = TrainConfig(num_windows=20000, window_len=200, epochs=10, batch_size=32,
                             recurrence_kernel=args.kernel)
        units = (40, 40, 40, 40)
    fcfg = FactorConfig(merged_kernel=args.merged_kernel, hoyer=args.hoyer, trace_norm=args.trace_norm,
                        orthogonal=args.orthogonal, cutoff=args.cutoff)
    return run(ds, ft_cfg, fcfg, ckpt=args.ckpt, units=units, recover_epochs=args.recover_epochs,
               qat_epochs=args.qat_epochs, export=args.export, plots=args.plots, device=args.device)


if __name__ == "__main__":
    main()
