"""v1 workflow: train two toy LSTMs on different targets, splice them into
one wider stacked model, and keep training it.

Counterpart of ``examples/sequentialize_train.py`` (reference
code/old_versions/train_full_model.py:42-190): a 2x20 'frequency' and a
2x10 'amplitude' model, each Adam(2e-3) on 4096 sine series of 60 steps,
merged layer by layer by ``merge_parallel_cell_weights`` (layer 0 reads the
same input, layer 1 the concatenated hidden states) under a new
Glorot-uniform head, then trained further on the frequency target with the
v1 optimizer, SGD(momentum .9) on gradients clamped to ±0.5. Each phase is
the last step's MSE over 32 batches of 128 an epoch, plain PyTorch in the
exact matmul scope on the model's device.

    python -m svd_lstm_tpu_torch seq-train [--epochs 3] [--out DIR] [--quick] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import torch

from svd_lstm_tpu_torch import examples as ex

N_SERIES, N_STEPS, BATCH = 4096, 60, 128


def run_epochs(model, opt, X, y, tag: str, epochs: int) -> list:
    """The minibatch trainer both phases share (only the optimizer and data
    differ): ``epochs`` passes over X in batches of 128 (32 of the 4096
    series). Returns every step's loss."""
    from svd_lstm_tpu_torch.api import exact_matmul
    from svd_lstm_tpu_torch.examples.frequency_prediction import last_step_mse

    dev = next(model.parameters()).device
    X, y = torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)
    losses = []
    with exact_matmul():
        for ep in range(epochs):
            epoch = []
            for i in range(0, len(X) - BATCH + 1, BATCH):
                loss = last_step_mse(model, X[i : i + BATCH], y[i : i + BATCH])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                epoch.append(loss.detach())
            losses += [float(v) for v in epoch]
            print(f"  [{tag}] epoch {ep}: loss {float(torch.stack(epoch).mean()):.5f}")
    return losses


def merge(freq, ampl):
    """The two toy stacks as one 30-unit stack, a seeded (9) Glorot head."""
    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.models.lstm import _glorot_uniform

    l0 = P.merge_parallel_cell_weights(freq.layers[0], ampl.layers[0], same_x=True)
    l1 = P.merge_parallel_cell_weights(freq.layers[1], ampl.layers[1], same_x=False)
    n = l1.units
    head = P.DenseHead(_glorot_uniform(torch.Generator().manual_seed(9), (n, 1), torch.float32),
                       torch.zeros(1))
    return P.StackedLSTM([l0, l1], head).to(l0.W.device)


def run(epochs: int = 3, out: str = ex.SAVES, name: str = "pretrained_split_merged.npz",
        toys=None, n_series: int = N_SERIES, n_steps: int = N_STEPS, device: str = "cuda") -> dict:
    """Both phases on ``n_series`` sine series of ``n_steps`` a target.
    ``toys`` = (freq, ampl) replaces the seeded untrained toy models (2x20
    seed 0, 2x10 seed 1; not modified). Returns the trained toys, the
    merged model before its training, the final model and the losses."""
    import copy

    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.data.synthetic import generate_time_series

    dev = ex.device_of(device)
    if toys is None:
        toys = (P.init_stacked_lstm(torch.Generator().manual_seed(0), 1, (20, 20), device=dev),
                P.init_stacked_lstm(torch.Generator().manual_seed(1), 1, (10, 10), device=dev))
    print("training toy models (frequency, amplitude)...")
    trained = []
    for (y_type, seed), model in zip((("frequency", 0), ("amplitude", 1)), toys):
        model = copy.deepcopy(model)
        X, y = generate_time_series(n_series, n_steps, y_type=y_type, seed=seed)
        run_epochs(model, torch.optim.Adam(model.parameters(), lr=2e-3), X, y, y_type, epochs)
        trained.append(model)

    print("splicing into one 30-unit stacked model...")
    merged = merge(*trained)
    params = copy.deepcopy(merged)
    X, yf = generate_time_series(n_series, n_steps, y_type="frequency", seed=7)
    print("continuing training on the merged model...")
    opt = ex.ClippedSGD(params.parameters(), lr=1e-2, momentum=0.9, clip=0.5)
    losses = run_epochs(params, opt, X, yf, "merged", epochs)

    path = os.path.join(out, name)
    os.makedirs(out, exist_ok=True)
    P.save_params(path, params)
    print(f"saved to {path}")
    return {"toys": trained, "merged": merged, "params": params, "losses": losses, "checkpoint": path}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m svd_lstm_tpu_torch seq-train",
                                 description="Train two toy LSTMs, merge them, keep training.")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", default=ex.SAVES)
    ap.add_argument("--quick", action="store_true", help="one epoch")
    ex.add_device(ap)
    args = ap.parse_args(argv)
    # the quick model keeps its own name, so it never stands in for the full one
    name = "pretrained_split_merged_quick.npz" if args.quick else "pretrained_split_merged.npz"
    return run(1 if args.quick else args.epochs, out=args.out, name=name, device=args.device)


if __name__ == "__main__":
    main()
