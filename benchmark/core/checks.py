"""The numbers that decide ``correct``, each held against its limit.

* ``out_err`` (whole-run ``predict``): over a sample of the window's calls,
  the largest |program − reference| of any prediction, as a share of the
  largest |reference prediction| of that call.
* Training, over the first three steps that set-up drove through the
  window's own call (the first alone, the next two inside one call that
  shuffles and gathers its rows as an epoch of the window does), gaps of norms taken leaf by leaf (the gap between the
  program's norm and the reference's, not the norm of their difference),
  each as a share of the larger of the reference's norm of that leaf and of
  the median leaf: ``loss1_gap``, the relative gap of the first step's
  loss; ``grad_gap``, the worst leaf of the first gradient as Adam received
  it; ``change_median_gap``, the median leaf's gap of the parameters'
  change after the three steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's would move under Adam by round-off alone,
  and are left out of both (none is, at the configurations of this
  benchmark).

  The later steps' loss (``loss_gap``, the larger gap of the first step's
  loss and of the later steps' mean, as the call reports it) and the worst leaf's
  change (``change_gap``) are reported beside them and held to no limit:
  Adam's first step moves every weight of a trained model by the learning
  rate, in the sign of its gradient, so where a gradient is near nought
  its rounding picks the sign, and float32 runs part from float64 ones by
  up to 5e-4 on some seeds, where the control reads from 1e-3.

A limit lies between the largest reading of sound runs of the program and
the smallest of the control (``limits/<cell>.json`` keeps both).
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

ZERO_GRAD = 1e-3  # a leaf's reference gradient under this share of the median leaf's is round-off


def out_err(outputs, reference: torch.Tensor) -> float:
    """``outputs``: the program's predictions of the sampled calls (T, out)
    each; ``reference``: (k, T, out) float64."""
    worst = 0.0
    for y, r in zip(outputs, reference):
        r = r.double().cpu().numpy()
        worst = max(worst, float(np.max(np.abs(np.asarray(y, np.float64) - r)) / np.max(np.abs(r))))
    return worst


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(program: dict, reference: dict, keep) -> dict:
    """|‖program‖ − ‖reference‖| / max(‖reference‖, median leaf's
    ‖reference‖) of each leaf of ``keep``, from the leaves' norms."""
    med = statistics.median(reference[k] for k in keep)
    return {k: abs(program[k] - reference[k]) / max(reference[k], med) for k in keep}


def train_numbers(program: dict, reference: dict) -> dict:
    """``program`` and ``reference``: ``{"losses", "first_grads", "start",
    "params"}`` of the first steps (leaves by name). Beside the numbers,
    ``leaves``: each kept leaf's [grad, change] gap, to find which leaf sets
    a number."""
    g_ref = _norms(reference["first_grads"])
    med = statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= ZERO_GRAD * med]
    change = lambda side: {k: side["params"][k].double() - side["start"][k].double()
                           for k in side["params"]}
    gaps = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    grad = leaf_gaps(_norms(program["first_grads"]), g_ref, keep)
    moved = leaf_gaps(_norms(change(program)), _norms(change(reference)), keep)
    return {
        "loss1_gap": gaps[0],
        "grad_gap": max(grad.values()),
        "change_median_gap": statistics.median(moved.values()),
        "loss_gap": max(gaps),
        "change_gap": max(moved.values()),
        "leaves": {k: [grad[k], moved[k]] for k in keep},
    }


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: whether every number is within its limit, and
    ``{name: {"value", "limit"}}`` in the limits' order. A number the run
    could not give (None, NaN) fails."""
    checks, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= spec["limit"]
        ok = ok and good
        checks[name] = {"value": v, "limit": spec["limit"]}
    return ok, checks
