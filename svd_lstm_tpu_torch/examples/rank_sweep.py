"""Rank-reduction sweep: the RMSE-vs-rank curve and the prediction gif.

Counterpart of ``examples/rank_sweep.py`` (reference
code/old_versions/svd_acceleration.py): order every per-gate singular value
ascending (layer 0's W protected), truncate them one at a time, score the
whole test run every ``--evaluate-every`` reductions, and draw
RMSE_plot.png and reduce_rank.gif. Each evaluation is one ``predict`` on
the model's device (``bench/sweep.rank_sweep``): K1 on the card for stacks
of at most 128 units.

    python -m svd_lstm_tpu_torch sweep [--quick] [--ckpt PATH] [--evaluate-every 8] [--max-reductions N] [--plots DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from svd_lstm_tpu_torch import examples as ex


def run(ds, ckpt: str = ex.PRETRAINED, units=(40, 40, 40, 40), evaluate_every: int = 8,
        max_reductions: int | None = None, plots: str = ex.PLOTS, device: str = "cuda",
        fresh_cfg=None):
    """The sweep of the checkpoint (or, where it does not exist, of a
    seeded stack of ``units`` trained with ``fresh_cfg``) over ``ds``'s test
    run. Returns the ``SweepResult``."""
    import torch

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.bench.sweep import rank_sweep
    from svd_lstm_tpu_torch.config import SweepConfig, TrainConfig
    from svd_lstm_tpu_torch.viz.plots import plot_rmse_curve, save_prediction_gif

    dev = ex.device_of(device)
    if os.path.exists(ckpt):
        model = P.load_params(ckpt, device=dev)
    else:
        print("no checkpoint — training briefly")
        cfg = fresh_cfg or TrainConfig(num_windows=2048, window_len=100, epochs=3, batch_size=64)
        model = P.fit(P.init_stacked_lstm(torch.Generator().manual_seed(0), 16, units, device=dev),
                      ds.X_train, ds.y_train, cfg, verbose=True).params

    y_m = ex.to_metres(ds, ds.y_test)
    res = rank_sweep(model, ds.X_test, y_m, ds.pin_scaler.inverse_transform,
                     SweepConfig(evaluate_every=evaluate_every), max_reductions=max_reductions,
                     keep_predictions=True)
    print(f"{res.reductions_done} reductions; RMSE {res.rmse[0]:.5f} -> {res.rmse[-1]:.5f} m")

    path = ex.figure_path(plots, "RMSE_plot.png")
    if path:
        plot_rmse_curve(res.weights_eliminated, res.rmse_ratio, xlabel="weights eliminated",
                        savepath=path)
        try:
            save_prediction_gif(ds.t_test, y_m, res.predictions, os.path.join(plots, "reduce_rank.gif"),
                                labels=[f"eliminated = {int(w)}" for w in res.weights_eliminated])
            print("wrote RMSE_plot.png and reduce_rank.gif")
        except RuntimeError as e:
            print(f"gif skipped: {e}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch sweep",
                                 description="RMSE-vs-rank sweep and prediction gif.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ckpt", default=ex.PRETRAINED)
    ex.add_plots(ap)
    ap.add_argument("--evaluate-every", type=int, default=8)
    ap.add_argument("--max-reductions", type=int, default=None)
    ex.add_device(ap)
    args = ap.parse_args(argv)
    if args.quick:
        ds = ex.quick_dataset(duration=10.0, split_time=6.0)
        units, max_red = (40, 40), args.max_reductions or 128
    else:
        ds = ex.full_dataset()
        units, max_red = (40, 40, 40, 40), args.max_reductions
    return run(ds, ckpt=args.ckpt, units=units, evaluate_every=args.evaluate_every,
               max_reductions=max_red, plots=args.plots, device=args.device)


if __name__ == "__main__":
    main()
