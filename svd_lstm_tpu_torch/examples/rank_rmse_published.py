"""The published rank-RMSE experiment (slide 13): 4x30, cells 2-3 reduced.

Counterpart of ``examples/rank_rmse_published.py`` (reference
code/old_versions/svd_acceleration.py:125-157, per-layer reduction by
set_model_matrix_rank): a 4x30 stacked LSTM whose layers[1] and layers[2]
have every W and U gate block truncated to rank r = 30 - k, k = 0..19, the
whole-test-run RMSE(reduced)/RMSE(full) at each k, over ``--seeds``
independent trainings (init and window sampling), written to a JSON
artifact and the median curve to a figure. The JAX script's docstring says
why the default surrogate noise is 1.5 and what the flat-then-diverge
property measures; the property is asserted only on a full (not
``--quick``) v4 / adam / pretrained run, as there.

On the card both trainings run through the train kernels
(``recurrence_kernel``: K7, or K8 where the dispatch takes it; the JAX
script's Hoyer fine-tune takes its fused Pallas engine on the TPU, and the
port's plain scan is bound by the host), and each evaluation is one exact
whole-run ``predict`` (K1; the JAX script's ``predict_full_run`` is its
compiled scan, the port's a host-bound Python loop: 20 of them took ~60 s
of 8000 steps on the card). On the CPU ``predict`` runs the same plain scan
as ``predict_full_run``.

A seed's pretrained model is read from ``--ckpt`` (its ``_s<seed>`` sibling
for seed > 0), where a newly trained one is also saved. By default it is
read from the repository's committed
``model_saves/pretrained_30units_<pipeline>_n<noise>[_v1train].npz`` (read
only) or from ``torch_runs/model_saves/`` under the same name, where a newly
trained one is saved. ``--quick`` always trains and saves nothing.

    python -m svd_lstm_tpu_torch rank-rmse [--quick] [--seeds 3] [--ckpt PATH] [--out JSON] [--plot PNG] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from svd_lstm_tpu_torch import examples as ex

UNITS = (30, 30, 30, 30)
REDUCED_LAYERS = (1, 2)      # cells 2-3, 1-based (slide 13)
KS = list(range(20))         # k = n - r = 0..19
COMMITTED = "./model_saves"


def v1_broadcast_loss(model, x, y, apply_fn, rng=None):
    """Keras' broadcast loss of the v1 protocol: the whole output sequence
    (B, T) against the window-end label at every step."""
    import torch

    pred = apply_fn(model, x, return_sequences=True)[..., 0]
    return torch.mean(torch.square(pred - y[:, None]))


def ckpt_path(ckpt: str, seed: int) -> str:
    return ckpt if seed == 0 else os.path.splitext(ckpt)[0] + f"_s{seed}.npz"


def run(ds, tcfg, input_dim: int = 16, seeds: int = 1, ckpt: str | None = None,
        save: str | None = None, quick: bool = False,
        trainer: str = "adam", mode: str = "pretrained", hoyer: float = 0.05,
        finetune_epochs: int = 15, config: dict | None = None,
        out: str = os.path.join(ex.SAVES, "rank_rmse_30units.json"),
        plot: str = os.path.join(ex.PLOTS, "RMSE_plot_30units.png"), device: str = "cuda") -> dict:
    """The sweep over ``seeds`` pretrained 4x30 models on the dataset
    ``ds``: seed s's is read from ``ckpt`` or ``save`` (each with its
    ``_s<s>`` suffix past seed 0) where one exists and not ``quick``, else
    trained with ``tcfg`` and, unless ``quick``, saved to ``save``. Writes
    the JSON artifact to ``out`` (with ``config`` merged into its config)
    and the figure to ``plot`` ('' draws none); returns the artifact's
    dict."""
    import torch

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.factor.svd import set_model_matrix_rank

    dev = ex.device_of(device)
    on_card = dev.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(dev) if on_card else 'CPU'}", flush=True)

    def pretrained_model(seed: int):
        for path in (ckpt_path(p, seed) for p in (ckpt, save) if p):
            if os.path.exists(path) and not quick:
                print(f"loaded {path}")
                return P.load_params(path, device=dev)
        init = P.init_stacked_lstm(torch.Generator().manual_seed(seed), input_dim, UNITS, device=dev)
        cfg = dataclasses.replace(tcfg, seed=tcfg.seed + seed, recurrence_kernel=on_card)
        if trainer == "v1":
            # the original recipe (old_versions/train_full_model.py:116-131): SGD
            # (momentum .9, clip .5, lr .01), 1800 minibatches of 32 windows x 100
            # steps as one epoch, and the broadcast loss
            cfg = dataclasses.replace(cfg, num_windows=2048 if quick else 1800 * 32, window_len=100,
                                      batch_size=32, epochs=cfg.epochs if quick else 1)
            print(f"training 4x30 model seed={seed} (v1 protocol: SGD momentum+clip, broadcast "
                  f"loss, {cfg.num_windows // cfg.batch_size} minibatches)...", flush=True)
            model = P.fit(init, ds.X_train, ds.y_train, cfg,
                          optimizer=lambda m: ex.ClippedSGD(m.parameters(), lr=0.01, momentum=0.9, clip=0.5),
                          loss_fn=v1_broadcast_loss, verbose=True).params
        else:
            print(f"training 4x30 model seed={seed} ({cfg.epochs} epochs)...", flush=True)
            model = P.fit(init, ds.X_train, ds.y_train, cfg, verbose=True).params
        if save and not quick:
            path = ckpt_path(save, seed)
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            P.save_params(path, model)
            print(f"saved {path}")
        return model

    def hoyer_refine(model):
        # the reference's answer to flat surrogate spectra: fine-tune the
        # singular form under the Hoyer penalty, then collapse it to dense
        from svd_lstm_tpu_torch.config import FactorConfig, TrainConfig

        fcfg = FactorConfig(merged_kernel=False, hoyer=hoyer, finetune_epochs=3 if quick else finetune_epochs)
        ft = dataclasses.replace(tcfg if quick else TrainConfig(), epochs=fcfg.finetune_epochs,
                                 batch_size=fcfg.finetune_batch_size, recurrence_kernel=on_card)
        print(f"hoyer fine-tune (hoyer={fcfg.hoyer}, {fcfg.finetune_epochs} epochs)...", flush=True)
        smodel = P.make_singular_model(model, merged_kernel=False)
        return P.singular_to_dense(P.finetune(smodel, ds.X_train, ds.y_train, fcfg, train_cfg=ft,
                                              verbose=True).params)

    y_true = ex.to_metres(ds, ds.y_test)
    x_test = torch.as_tensor(ds.X_test[0], dtype=torch.float32, device=dev)

    def sweep(model):
        rmses = []
        for k in KS:
            r = UNITS[0] - k
            m_k = model
            for layer in REDUCED_LAYERS:
                for mat in (0, 1):            # W, U
                    for gate in range(4):     # i, f, c, o
                        m_k = set_model_matrix_rank(m_k, (layer, mat, gate), r)
            e = P.rmse(y_true, ex.to_metres(ds, P.predict(m_k, x_test)[:, 0]))
            rmses.append(e)
            print(f"k={k:2d} (r={r:2d}): RMSE {e * 1000:.3f} mm  ratio {e / rmses[0]:.4f}", flush=True)
        return rmses

    all_rmses, all_ratios = [], []
    for seed in range(seeds):
        model = pretrained_model(seed)
        if mode == "hoyer":
            model = hoyer_refine(model)
        print(f"-- seed {seed} sweep --", flush=True)
        rmses = sweep(model)
        all_rmses.append(rmses)
        all_ratios.append([e / rmses[0] for e in rmses])

    ratio_arr = np.asarray(all_ratios)               # (seeds, 20)
    ratio_mean = ratio_arr.mean(axis=0).tolist()
    ratio_std = ratio_arr.std(axis=0, ddof=1 if seeds > 1 else 0).tolist()
    ratio_median = np.median(ratio_arr, axis=0).tolist()
    flat_per_seed = ratio_arr[:, :16].max(axis=1)
    flat_max = max(ratio_median[:16])
    print(f"\nflat region k=0..15 over {seeds} seed(s): median-curve max {flat_max:.4f}, per-seed "
          f"{[round(float(v), 3) for v in flat_per_seed]} (published: ~1.00 flat to k=15)")
    print(f"divergence (median): ratio[17]={ratio_median[17]:.3f} ratio[19]={ratio_median[19]:.3f}  "
          "(published: ~1.1 at 17, >2 by 19)")
    for k in (15, 17, 19):
        print(f"  k={k}: mean {ratio_mean[k]:.3f} ± {ratio_std[k]:.3f}  median {ratio_median[k]:.3f}")

    artifact = {
        "config": {
            "units": UNITS,
            "reduced_layers_0based": REDUCED_LAYERS,
            "k_range": KS,
            "protocol": "set_model_matrix_rank over all W/U gates of cells 2-3 "
            "(slide 13 / old_versions/svd_acceleration.py)",
            "trainer": trainer,
            "mode": mode,
            "hoyer": hoyer if mode == "hoyer" else 0.0,
            "epochs": tcfg.epochs,
            "seeds": seeds,
            "device": dev.type,
            **(config or {}),
        },
        # the single-curve fields are seed 0's
        "rmse_m": all_rmses[0],
        "ratio": all_ratios[0],
        "per_seed": {"rmse_m": all_rmses, "ratio": all_ratios},
        "ratio_mean": ratio_mean,
        "ratio_std": ratio_std,
        "ratio_median": ratio_median,
        "flat_max_per_seed": [float(v) for v in flat_per_seed],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {out}")
    if plot:
        from svd_lstm_tpu_torch.viz.plots import plot_rmse_curve

        # published axes: x = n - r ticks 0..19, ylim (0.8, 2.0); the median curve
        plot_rmse_curve(KS, ratio_median, xlabel="n - r", savepath=plot, ylim=(0.8, 2.0))
        print(f"wrote {plot}")
    else:
        print("--plot '': no figure written")
    return artifact


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch rank-rmse",
                                 description="The published 4x30 rank-RMSE experiment.")
    ap.add_argument("--quick", action="store_true", help="small-scale smoke run (one seed)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--pipeline", choices=("v1", "v4"), default="v4",
                    help="v1 = 1-wide frames at ~800 Hz (the published plot's pipeline); "
                    "v4 = 16-wide frames at 2 kHz steps")
    ap.add_argument("--mode", choices=("pretrained", "hoyer"), default="pretrained",
                    help="hoyer = Hoyer-fine-tune the singular form before the sweep")
    ap.add_argument("--trainer", choices=("adam", "v1"), default="adam",
                    help="v1 = the original protocol: SGD(momentum .9, clip .5, lr .01), 1800 "
                    "minibatches of 32 x 100-step windows, the broadcast loss")
    ap.add_argument("--hoyer", type=float, default=0.05)
    ap.add_argument("--finetune-epochs", type=int, default=15)
    ap.add_argument("--noise", type=float, default=1.5, help="surrogate sensor-noise std")
    ap.add_argument("--seeds", type=int, default=3, help="independent training seeds (--quick: 1)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default=os.path.join(ex.SAVES, "rank_rmse_30units.json"))
    ap.add_argument("--plot", default=os.path.join(ex.PLOTS, "RMSE_plot_30units.png"),
                    help="figure path; '' draws none")
    ex.add_device(ap)
    args = ap.parse_args(argv)
    if args.quick:
        args.seeds = 1
    if args.ckpt is None:
        # the committed checkpoint where present (read only); a new one goes under torch_runs/
        name = f"pretrained_30units_{args.pipeline}_n{args.noise:g}{'_v1train' if args.trainer == 'v1' else ''}.npz"
        ckpt, save = os.path.join(COMMITTED, name), os.path.join(ex.SAVES, name)
    else:
        ckpt = save = args.ckpt
    # a run's artifacts never overwrite another kind's: suffixed names
    suffix = (("_v1train" if args.trainer == "v1" else "") + ("_hoyer" if args.mode == "hoyer" else "")
              + ("_quick" if args.quick else ""))
    if suffix:
        for attr in ("out", "plot"):
            default = ap.get_default(attr)
            if getattr(args, attr) == default:
                root, ext = os.path.splitext(default)
                setattr(args, attr, f"{root}{suffix}{ext}")

    from svd_lstm_tpu_torch.config import DataConfig, TrainConfig

    dcfg = (DataConfig(sampling_period=1.0 / 800.0, frame_width=1) if args.pipeline == "v1"
            else DataConfig())
    if args.quick:
        ds = ex.quick_dataset(duration=12.0, split_time=8.0, noise=args.noise, cfg=dcfg)
        tcfg = TrainConfig(num_windows=2048, window_len=100, epochs=6, batch_size=64)
    elif os.path.exists(dcfg.json_path):
        ds = ex.full_dataset(dcfg)  # the real dataset, when present
        tcfg = TrainConfig(epochs=args.epochs)
    else:
        from svd_lstm_tpu_torch.data import preprocess_raw, synthetic_dropbear_raw

        ds = preprocess_raw(synthetic_dropbear_raw(noise=args.noise), dcfg)
        tcfg = TrainConfig(epochs=args.epochs)
    config = {"pipeline": args.pipeline, "noise": args.noise,
              "dataset": "synthetic DROPBEAR surrogate" + (" (quick)" if args.quick else "")}
    art = run(ds, tcfg, input_dim=dcfg.frame_width, seeds=args.seeds, ckpt=ckpt, save=save,
              quick=args.quick, trainer=args.trainer, mode=args.mode, hoyer=args.hoyer,
              finetune_epochs=args.finetune_epochs, config=config, out=args.out, plot=args.plot,
              device=args.device)

    # the property last: the artifact above is the evidence either way
    ratio_median = art["ratio_median"]
    flat_per_seed = np.asarray(art["flat_max_per_seed"])
    if (not args.quick and args.noise >= 1.0 and args.pipeline == "v4"
            and args.trainer == "adam" and args.mode == "pretrained"):
        flat_max = max(ratio_median[:16])
        if not flat_max < 1.25:
            raise SystemExit(f"flat region violated (median): {flat_max}")
        if not float(np.mean(flat_per_seed < 1.25)) > 0.5:
            raise SystemExit(f"flat seeds are a minority: {flat_per_seed}")
        if not ratio_median[19] > ratio_median[15] + 0.2:
            raise SystemExit("no divergence at k=19")
        print("PUBLISHED-CONFIG PROPERTY HOLDS (median curve + majority of seeds): flat to k=15, "
              "divergent beyond")
    return art


if __name__ == "__main__":
    main()
