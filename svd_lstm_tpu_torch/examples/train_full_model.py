"""Train the full (dense) DROPBEAR regressor.

Counterpart of ``examples/train_full_model.py`` (reference
code/train_full_model_v4.py): preprocess at the 500/16 µs clock, sample
random 200-step windows, a 4x40 stacked LSTM + Dense(1) under Adam on the
window-end MSE for 30 epochs, then the whole-run evaluation (SNR, RMSE,
NRMSE in metres; ``predict_full_run``, the plain scan, as in the JAX
script), the overlay figure and the checkpoint. ``--quick`` trains a 2x40
stack on 12 s of the surrogate run, and saves it under its own
``_quick`` name.

On the card ``--kernel`` trains through the train kernels (K7 for the narrow
stack at B = 64). The checkpoint is the JAX package's ``.npz`` format, so
either package loads it.

    python -m svd_lstm_tpu_torch train [--quick] [--out DIR] [--kernel] [--remat-chunk K] [--plots DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

from svd_lstm_tpu_torch import examples as ex


def run(ds, tcfg, units=(40, 40, 40, 40), out: str = ex.SAVES,
        ckpt_name: str = "pretrained_sequential.npz", plots: str = ex.PLOTS,
        plot_name: str = "full_model_prediction.png", device: str = "cuda") -> dict:
    """Train a seeded (``tcfg.seed``) dense stack on ``ds`` with ``tcfg``,
    evaluate it over the whole run and save it to ``out/ckpt_name``. Returns
    the result of ``fit``, the path and the metrics."""
    import torch

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.viz.plots import plot_prediction_overlay

    dev = ex.device_of(device)
    params = P.init_stacked_lstm(torch.Generator().manual_seed(tcfg.seed), 16, units, device=dev)
    t0 = time.perf_counter()
    res = P.fit(params, ds.X_train, ds.y_train, tcfg, verbose=True)
    print(f"training wall time: {time.perf_counter() - t0:.1f} s"
          f" ({'train-kernel' if tcfg.recurrence_kernel else 'plain scan'} path, {dev.type})")
    print(f"rollbacks: {res.rollbacks}")

    true_m = ex.to_metres(ds, ds.y)
    pred_m = ex.to_metres(ds, P.predict_full_run(res.params, ds.X))
    metrics = {"snr": P.signaltonoise(true_m, pred_m), "rmse": P.rmse(true_m, pred_m),
               "nrmse": P.nrmse(true_m, pred_m)}
    print(f"SNR: {metrics['snr']:.3f} dB")
    print(f"RMSE: {metrics['rmse']:.6f} m")
    print(f"NRMSE: {metrics['nrmse']:.6f}")

    path = ex.figure_path(plots, plot_name)
    if path:
        plot_prediction_overlay(ds.t, true_m, {"full model prediction": pred_m}, savepath=path)
    ckpt = os.path.join(out, ckpt_name)
    os.makedirs(out, exist_ok=True)
    P.save_params(ckpt, res.params)
    print(f"saved to {ckpt}")
    return {"result": res, "checkpoint": ckpt, **metrics}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch train",
                                 description="Train the full dense regressor.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=ex.SAVES)
    ex.add_plots(ap)
    ap.add_argument("--kernel", action="store_true",
                    help="train through the train kernels (TrainConfig.recurrence_kernel)")
    ap.add_argument("--remat-chunk", type=int, default=0, metavar="K",
                    help="chunked-time rematerialization of the plain scan's step "
                    "(TrainConfig.remat_chunk: O(T/K + K) live activations, the same values)")
    ex.add_device(ap)
    args = ap.parse_args(argv)

    from svd_lstm_tpu_torch.config import TrainConfig

    if args.quick:
        ds = ex.quick_dataset(duration=12.0, split_time=8.0)
        tcfg = TrainConfig(num_windows=2048, window_len=100, epochs=3, batch_size=64,
                           recurrence_kernel=args.kernel, remat_chunk=args.remat_chunk)
        units = (40, 40)
    else:
        ds = ex.full_dataset()
        tcfg = TrainConfig(recurrence_kernel=args.kernel, remat_chunk=args.remat_chunk)
        units = (40, 40, 40, 40)
    # the quick model keeps its own name, so it never stands in for the full one
    suffix = "_quick" if args.quick else ""
    return run(ds, tcfg, units=units, out=args.out, ckpt_name=f"pretrained_sequential{suffix}.npz",
               plots=args.plots, plot_name=f"full_model_prediction{suffix}.png", device=args.device)


if __name__ == "__main__":
    main()
