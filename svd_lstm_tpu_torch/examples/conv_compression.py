"""Conv-hybrid compression workflow: train, factorize, fine-tune, truncate,
deploy.

Counterpart of ``examples/conv_compression.py``: the reference's
convolutional experiment (Conv1D(15, 10, causal, relu) + 2x15 LSTM + a
dense head on DROPBEAR) through the compression pipeline: ``fit``, the
σ-only Hoyer fine-tune, the rank-``--rank`` two-step truncation (with
``--recover-epochs``, the recovery fine-tune), each scored over the whole
run by an exact ``predict`` (the JAX script's ``predict_full_run`` is an
XLA scan; on the card this runs the batch-1 kernels at the same values),
then the CSV export and
the native C++ runtime (``io/native.py``) over the first 256 frames,
within 5e-4 of the port's prediction. A native runtime that cannot be built
fails the command. ``--quick`` shrinks everything (12 s of the surrogate
run, 3 + 2 epochs).

The export goes under ``--out`` (default ``torch_runs/model_saves/``).

    python -m svd_lstm_tpu_torch.examples.conv_compression [--quick] [--rank 8] [--hoyer 0.01] [--recover-epochs 0] [--out DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from svd_lstm_tpu_torch import examples as ex

NATIVE_TOL = 5e-4   # the native consumer against the port's forward (the JAX script's assert)
NATIVE_FRAMES = 256


def run(ds, tcfg, ft_epochs: int, rank: int = 8, out: str = ex.SAVES, hoyer: float = 0.01,
        recover_epochs: int = 0, export_name: str = "conv_reduced_export", device: str = "cuda") -> dict:
    """The workflow on ``ds``: the hybrid trained with ``tcfg``, fine-tuned
    for ``ft_epochs``, truncated to ``rank``, exported to
    ``out/export_name`` (see the module docstring). Returns the RMSEs (mm),
    the weight counts, the native runtime's error and the three models."""
    import torch

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.io.native import NativeModel, save_reduced_weights_as_csv

    dev = ex.device_of(device)
    d_in = ds.X_train.shape[-1]
    sub = P.TrainConfig(num_windows=tcfg.num_windows, window_len=tcfg.window_len, batch_size=tcfg.batch_size,
                        epochs=ft_epochs)

    params = P.init_conv_lstm(torch.Generator().manual_seed(tcfg.seed), in_channels=d_in, filters=15,
                              kernel_size=10, units=(15, 15), device=dev)
    t0 = time.perf_counter()
    dense = P.fit(params, ds.X_train, ds.y_train, tcfg, verbose=True).params
    print(f"hybrid training wall time: {time.perf_counter() - t0:.1f} s")

    true_m = ex.to_metres(ds, ds.y)
    x_run = torch.as_tensor(ds.X[0], dtype=torch.float32, device=dev)

    def whole_run(model) -> np.ndarray:
        return P.predict(model, x_run)[:, 0].cpu().numpy()

    def rmse_mm(pred) -> float:
        return 1000.0 * P.rmse(true_m, ex.to_metres(ds, pred))

    res = {"rmse_dense_mm": rmse_mm(whole_run(dense))}
    n_dense = sum(p.numel() for p in dense.parameters())
    print(f"dense hybrid: RMSE {res['rmse_dense_mm']:.3f} mm, {n_dense} weights")

    cs = P.finetune(P.make_conv_singular_model(dense), ds.X_train, ds.y_train,
                    factor_cfg=P.FactorConfig(hoyer=hoyer), train_cfg=sub).params
    res["rmse_singular_mm"] = rmse_mm(whole_run(cs))
    sig = np.concatenate([s.ravel() for pair in P.harvest_sigmas(cs) for s in pair])
    kill_frac = float(np.mean(np.abs(sig) < 0.05))
    print(f"fine-tuned singular: RMSE {res['rmse_singular_mm']:.3f} mm; {100 * kill_frac:.0f}% of sigma "
          "below the 0.05 cutoff")

    cr = P.make_conv_reduced_model(cs, cutoff=None, rank=rank)
    if recover_epochs:
        print(f"reduced pre-recovery: RMSE {rmse_mm(whole_run(cr)):.3f} mm")
        rcfg = P.TrainConfig(num_windows=tcfg.num_windows, window_len=tcfg.window_len,
                             batch_size=tcfg.batch_size, epochs=recover_epochs)
        cr = P.finetune_reduced(cr, ds.X_train, ds.y_train, train_cfg=rcfg).params
    pred_red = whole_run(cr)
    res["rmse_reduced_mm"] = rmse_mm(pred_red)
    n_red = cr.weight_count()
    res.update(dense_weights=n_dense, reduced_weights=n_red)
    print(f"reduced hybrid (rank {rank}): RMSE {res['rmse_reduced_mm']:.3f} mm, {n_red} weights "
          f"({100 * (1 - n_red / n_dense):.0f}% smaller)")

    export_dir = os.path.join(out, export_name)
    os.makedirs(out, exist_ok=True)
    save_reduced_weights_as_csv(cr, export_dir)
    got = NativeModel.from_export_dir(export_dir).run(np.asarray(ds.X[0, :NATIVE_FRAMES], np.float32))
    res["native_err"] = float(np.max(np.abs(got - pred_red[:NATIVE_FRAMES])))
    print(f"native consumer vs the port over {NATIVE_FRAMES} frames: |delta| {res['native_err']:.2e}")
    if not res["native_err"] < NATIVE_TOL:
        raise AssertionError(f"native consumer diverged from the port's forward: {res['native_err']:.2e}")
    print("conv compression workflow OK")
    return {**res, "dense": dense, "singular": cs, "reduced": cr, "prediction": pred_red}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch.examples.conv_compression",
                                 description="Conv-hybrid compression, from training to deployment.")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--rank", type=int, default=8, help="two-step rank per gate block after fine-tuning")
    ap.add_argument("--out", default=ex.SAVES)
    ap.add_argument("--hoyer", type=float, default=0.01)
    ap.add_argument("--recover-epochs", type=int, default=0,
                    help="post-truncation recovery fine-tune of the two-step factors for N epochs")
    ex.add_device(ap)
    args = ap.parse_args(argv)

    from svd_lstm_tpu_torch.config import TrainConfig

    if args.quick:
        ds = ex.quick_dataset(duration=12.0, split_time=8.0)
        tcfg, ft_epochs = TrainConfig(num_windows=1024, window_len=100, epochs=3, batch_size=64), 2
    else:
        ds = ex.full_dataset()
        tcfg, ft_epochs = TrainConfig(num_windows=20_000, window_len=200, epochs=20), 10
    return run(ds, tcfg, ft_epochs, rank=args.rank, out=args.out, hoyer=args.hoyer,
               recover_epochs=args.recover_epochs,
               export_name="conv_reduced_export" + ("_quick" if args.quick else ""), device=args.device)


if __name__ == "__main__":
    main()
