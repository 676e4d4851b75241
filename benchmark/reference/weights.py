"""The reference's own weights: read from a committed checkpoint, or truncated
from dense weights, in NumPy float64.

* :func:`read_checkpoint` reads a ``.npz`` written by either package's
  ``save_params`` (leaf arrays and a JSON ``__spec__`` of the tree) and
  returns its dense weights: a reduced model's two-step factors (B, C)
  multiplied out, W = B·[I | C] (merged: one pair a side; split: one pair a
  gate, the gate blocks side by side).
* :func:`truncate` keeps the top ``rank`` singular values of each kernel
  (split: of each gate's block; merged: of the whole kernel), the weights
  W_r = U_r·Σ_r·V_rᵀ that the two-step form computes exactly.

Nothing here imports the program.
"""

from __future__ import annotations

import json

import numpy as np


def _build(spec, leaves):
    if "__leaf__" in spec:
        return leaves[spec["__leaf__"]]
    if "__node__" in spec:
        return {"__node__": spec["__node__"],
                **{k: _build(v, leaves) for k, v in spec["fields"].items()}}
    if "__tuple__" in spec:
        return [_build(v, leaves) for v in spec["__tuple__"]]
    raise ValueError(f"bad checkpoint spec node: {spec}")


def _two_step(Bs, Cs) -> np.ndarray:
    if isinstance(Bs, list):
        return np.concatenate([_two_step(B, C) for B, C in zip(Bs, Cs)], axis=1)
    B = np.asarray(Bs, np.float64)
    r = B.shape[1]
    IC = np.concatenate([np.eye(r), np.asarray(Cs, np.float64)], axis=1)
    return B @ IC


def read_checkpoint(path: str):
    """``(layers, head)``: [(W, U, b)] and (w, b), float64, of a dense or
    reduced model checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(str(z["__spec__"]))
        leaves = [z[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in z.files))]
    tree = _build(spec, leaves)
    kind = tree["__node__"]
    layers = []
    for l in tree["layers"]:
        if kind == "StackedLSTMParams":
            W, U = np.asarray(l["W"], np.float64), np.asarray(l["U"], np.float64)
        elif kind == "ReducedModelParams":
            W, U = _two_step(l["wB"], l["wC"]), _two_step(l["uB"], l["uC"])
        else:
            raise ValueError(f"{path}: a {kind} checkpoint; expected a dense or reduced model")
        layers.append((W, U, np.asarray(l["b"], np.float64)))
    head = (np.asarray(tree["head"]["w"], np.float64), np.asarray(tree["head"]["b"], np.float64))
    return layers, head


def _top(M: np.ndarray, rank: int) -> np.ndarray:
    u, s, vt = np.linalg.svd(M, full_matrices=False)
    r = min(rank, s.size)
    return (u[:, :r] * s[:r]) @ vt[:r]


def truncate(W: np.ndarray, rank: int, merged: bool) -> np.ndarray:
    """W (rows, 4n) with each gate block's (split) or the whole kernel's
    (merged) singular values past the ``rank`` largest dropped."""
    W = np.asarray(W, np.float64)
    if merged:
        return _top(W, rank)
    n = W.shape[1] // 4
    return np.concatenate([_top(W[:, g * n:(g + 1) * n], rank) for g in range(4)], axis=1)
