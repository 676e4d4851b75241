"""Toy sine-series task: predict the period, amplitude or frequency.

Counterpart of ``examples/frequency_prediction.py`` (reference
code/old_versions/frequency-prediction-lstm.py): a 2x20 stacked LSTM on
generated sine series (10 000 of 76 steps, seed 42; 7 000 to train),
Adam(1e-3) on the last step's MSE in batches of 128, then the test RMSE and
a scatter plot of predicted against true values. The JAX script's jitted
loop is plain PyTorch here (``torch.optim.Adam``, optax's ``adam``; the
scan on the model's device) in the exact matmul scope.

    python -m svd_lstm_tpu_torch freq [--y-type frequency|period|amplitude] [--epochs 5] [--quick] [--plots DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import torch

from svd_lstm_tpu_torch import examples as ex

BATCH = 128


def last_step_mse(model, xb, yb):
    from svd_lstm_tpu_torch.models.lstm import stacked_lstm_apply

    return torch.mean((stacked_lstm_apply(model, xb, return_sequences=False)[..., 0] - yb) ** 2)


def run(y_type: str = "frequency", epochs: int = 5, n_series: int = 10000, n_steps: int = 76,
        n_train: int = 7000, units=(20, 20), params=None, plots: str = ex.PLOTS,
        device: str = "cuda") -> dict:
    """Train ``params`` (default: a seeded stack of ``units``, input 1) for
    ``epochs`` on the first ``n_train`` of ``n_series`` series and score it
    on the rest. Returns the model, each step's loss and the test RMSE."""
    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.data.synthetic import generate_time_series

    dev = ex.device_of(device)
    X, y = generate_time_series(n_series, n_steps, y_type=y_type, seed=42)
    X_train, y_train = (torch.as_tensor(a[:n_train], device=dev) for a in (X, y))
    X_test, y_test = X[n_train:], y[n_train:]

    model = params if params is not None else P.init_stacked_lstm(
        torch.Generator().manual_seed(0), 1, units, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    with P.exact_matmul():
        for epoch in range(epochs):
            epoch_losses = []
            for i in range(0, n_train - BATCH + 1, BATCH):
                loss = last_step_mse(model, X_train[i : i + BATCH], y_train[i : i + BATCH])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                epoch_losses.append(loss.detach())
            losses += [float(v) for v in epoch_losses]
            print(f"epoch {epoch}: loss {float(torch.stack(epoch_losses).mean()):.5f}")
        with torch.no_grad():
            pred = P.stacked_lstm_apply(model, torch.as_tensor(X_test, device=dev),
                                        return_sequences=False)[:, 0].cpu().numpy()
    rmse = P.rmse(y_test, pred)
    print(f"test RMSE: {rmse:.5f}")

    path = ex.figure_path(plots, f"predicting_{y_type}.png")
    if path:
        from svd_lstm_tpu_torch.viz.plots import pyplot

        plt = pyplot()
        plt.figure(figsize=(4, 3.4))
        plt.scatter(y_test, pred, s=2, label="Test Data")
        lo, hi = float(min(y_test.min(), pred.min())), float(max(y_test.max(), pred.max()))
        plt.plot([lo, hi], [lo, hi], c="k", label="y=x")
        plt.legend()
        plt.title(f"LSTM model predicts {y_type}")
        plt.xlabel(f"true {y_type}")
        plt.ylabel(f"predicted {y_type}")
        plt.tight_layout()
        os.makedirs(plots, exist_ok=True)
        plt.savefig(path, dpi=300)
        plt.close()
        print(f"wrote {path}")
    return {"model": model, "losses": losses, "rmse": rmse, "pred": pred}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch freq",
                                 description="Toy sine-series regression.")
    ap.add_argument("--y-type", default="frequency", choices=["frequency", "period", "amplitude"])
    ap.add_argument("--epochs", type=int, default=5)
    ex.add_plots(ap)
    ap.add_argument("--quick", action="store_true", help="one epoch")
    ex.add_device(ap)
    args = ap.parse_args(argv)
    return run(args.y_type, 1 if args.quick else args.epochs, plots=args.plots, device=args.device)


if __name__ == "__main__":
    main()
