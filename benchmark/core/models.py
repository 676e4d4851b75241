"""The two sides' models of a configuration's form.

:func:`program_model` builds what the program runs, through the port's own
entry points: ``io.checkpoint.load_params`` for a committed checkpoint, the
port's module classes around the benchmark's seeded weights, and the
surgery ``make_singular_model`` then ``make_reduced_model(rank=...)``.
:func:`reference_weights` gives the reference its weights from the same
files and seed, worked out again by the reference's own code: nothing the
program made.
"""

from __future__ import annotations

import torch

from benchmark.core import cell as cells
from benchmark.core.weights import seeded_dense
from benchmark.reference import weights as refw


def program_model(config: dict, form: str, seed: int, device):
    """The port's model of ``form`` ("dense" or "reduced") on ``device``."""
    from svd_lstm_tpu_torch.factor.svd import make_reduced_model, make_singular_model
    from svd_lstm_tpu_torch.io.checkpoint import load_params
    from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM

    spec = config["forms"][form]
    if "checkpoint" in spec:
        return load_params(cells.checkpoint(spec), device=device)
    dense = config["forms"]["dense"]
    if "checkpoint" in dense:
        model = load_params(cells.checkpoint(dense), device=device)
    else:
        layers, (w, b) = seeded_dense(config, seed, device)
        model = StackedLSTM([LSTMLayer(*l) for l in layers], DenseHead(w, b))
    if form == "dense":
        return model
    return make_reduced_model(make_singular_model(model, merged_kernel=bool(spec["merged"])),
                              cutoff=None, rank=int(spec["rank"]))


def reference_weights(config: dict, form: str, seed: int, device) -> tuple:
    """``(layers, head)`` of ``form`` as float64 tensors on ``device``: a
    checkpoint read by the reference, or the seeded dense weights made
    again, truncated by the reference where the form says so."""
    spec = config["forms"][form]
    dense = config["forms"]["dense"]
    if "checkpoint" in spec:
        layers, head = refw.read_checkpoint(cells.checkpoint(spec))
    elif "checkpoint" in dense:
        layers, head = refw.read_checkpoint(cells.checkpoint(dense))
    else:
        ls, hd = seeded_dense(config, seed, device)
        layers = [tuple(p.double().cpu().numpy() for p in l) for l in ls]
        head = tuple(p.double().cpu().numpy() for p in hd)
    if "checkpoint" not in spec and spec.get("rank") is not None:
        layers = [(refw.truncate(W, spec["rank"], bool(spec["merged"])),
                   refw.truncate(U, spec["rank"], bool(spec["merged"])), b) for W, U, b in layers]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return [tuple(t(p) for p in l) for l in layers], tuple(t(p) for p in head)
