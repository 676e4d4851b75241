"""Per-gate CSV weight export and import: the LabVIEW deployment format.

Counterpart of ``svd_lstm_tpu/io/csv_weights.py``; the same model gives the
same bytes from either package, and each package reads the other's
directories. File layout per LSTM layer directory:

    Wi.csv Wf.csv Wc.csv Wo.csv   — input kernel gate blocks
    Ui.csv Uf.csv Uc.csv Uo.csv   — recurrent kernel gate blocks
    bi.csv bf.csv bc.csv bo.csv   — bias gate segments

plus ``dense_top/`` (``weights.csv``, ``bias.csv``). The writer stores the
untransposed Keras blocks ``W[:, g*n:(g+1)*n]`` (in_dim × units) and a
``layout.txt`` marker; the reference's shipped fixtures store the blocks
transposed (units × in_dim) and carry no marker, so the loader's default
reads a directory with the marker untransposed and one without it
transposed. A conv hybrid (``ConvLSTM``) adds its front end as ``conv/``:
``w.csv`` ((k·c_in) × filters, tap-major rows), ``b.csv`` and ``shape.csv``
(k, c_in), which the native runtime reads too; a directory with ``conv/``
loads as a ``ConvLSTM``.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from svd_lstm_tpu_torch.io.checkpoint import to_numpy, to_numpy_tree
from svd_lstm_tpu_torch.models.conv import ConvFront, ConvLSTM
from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM

GATES = ("i", "f", "c", "o")

_LAYOUT_MARKER = "layout.txt"


def save_conv_front_csv(conv, savpath: str) -> None:
    """Write a conv front end (``ConvFront`` or its tree, any device) as
    ``conv/`` next to the lstm_* directories: w.csv ((k·c_in) × filters,
    tap-major rows), b.csv, shape.csv (k, c_in)."""
    d = os.path.join(savpath, "conv")
    os.makedirs(d, exist_ok=True)
    w = to_numpy(conv.w)  # (k, c_in, filters)
    k, c_in, filters = w.shape
    np.savetxt(os.path.join(d, "w.csv"), w.reshape(k * c_in, filters), delimiter=",")
    np.savetxt(os.path.join(d, "b.csv"), to_numpy(conv.b), delimiter=",")
    np.savetxt(os.path.join(d, "shape.csv"), np.array([[k, c_in]]), delimiter=",")


def load_conv_front_csv(savpath: str, dtype=torch.float32, device: str | torch.device = "cuda"):
    """Load a ``conv/`` front-end directory onto ``device`` (the card unless
    ``device="cpu"``) if there is one; None otherwise. Raises
    ``ValueError`` when w.csv's rows disagree with shape.csv."""
    d = os.path.join(savpath, "conv")
    if not os.path.isdir(d):
        return None
    w = np.loadtxt(os.path.join(d, "w.csv"), delimiter=",", ndmin=2)
    b = np.atleast_1d(np.loadtxt(os.path.join(d, "b.csv"), delimiter=","))
    shape = np.loadtxt(os.path.join(d, "shape.csv"), delimiter=",").reshape(-1)
    k, c_in = int(shape[0]), int(shape[1])
    if w.shape[0] != k * c_in:
        raise ValueError(f"{d}/w.csv has {w.shape[0]} rows; shape.csv says k*c_in = {k * c_in}")
    return ConvFront(_tensor(w.reshape(k, c_in, -1), dtype, device), _tensor(b, dtype, device))


def _dense_tree(model):
    tree = to_numpy_tree(model)
    if type(tree).__name__ not in ("StackedLSTMParams", "ConvLSTMParams"):
        raise TypeError(f"per-gate CSVs hold a dense model, not {type(model).__name__}")
    return tree


def save_model_weights_as_csv(model, savpath: str = "./model_weights") -> None:
    """Write a dense model (``StackedLSTM``, or the ``ConvLSTM`` hybrid with
    its ``conv/``; any device) as per-gate CSVs, one directory per layer
    plus ``dense_top/``, with the ``layout.txt`` marker of the untransposed
    blocks."""
    params = _dense_tree(model)
    os.makedirs(savpath, exist_ok=True)
    with open(os.path.join(savpath, _LAYOUT_MARKER), "w") as f:
        f.write("keras\n")  # untransposed (in_dim, units) blocks
    if hasattr(params, "conv"):
        save_conv_front_csv(params.conv, savpath)
    for li, layer in enumerate(params.layers):
        d = os.path.join(savpath, f"lstm_{li}")
        os.makedirs(d, exist_ok=True)
        n = layer.U.shape[0]
        for g, name in enumerate(GATES):
            np.savetxt(os.path.join(d, f"W{name}.csv"), layer.W[:, g * n : (g + 1) * n], delimiter=",")
            np.savetxt(os.path.join(d, f"U{name}.csv"), layer.U[:, g * n : (g + 1) * n], delimiter=",")
            np.savetxt(os.path.join(d, f"b{name}.csv"), layer.b[g * n : (g + 1) * n], delimiter=",")
    d = os.path.join(savpath, "dense_top")
    os.makedirs(d, exist_ok=True)
    np.savetxt(os.path.join(d, "weights.csv"), params.head.w, delimiter=",")
    np.savetxt(os.path.join(d, "bias.csv"), params.head.b, delimiter=",")


def _load_gate(path: str) -> np.ndarray:
    return np.atleast_1d(np.loadtxt(path, delimiter=","))


def _load_gate_matrix(path: str) -> np.ndarray:
    # ndmin=2 keeps a single-column block (k, 1) as (k, 1), where
    # atleast_2d would make it (1, k) and transpose units=1 / in_dim=1 layers
    return np.loadtxt(path, delimiter=",", ndmin=2)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def load_layer_from_csv(
    layer_dir: str, transposed: bool = True, dtype=torch.float32,
    device: str | torch.device = "cuda",
) -> LSTMLayer:
    """Load one layer directory of per-gate CSVs into a Keras-layout
    ``LSTMLayer`` on ``device`` (the card unless ``device="cpu"``).
    ``transposed=True`` (default): the files hold (units, in_dim) blocks, as
    the shipped reference fixtures do."""
    Wg, Ug, bg = [], [], []
    for name in GATES:
        W = _load_gate_matrix(os.path.join(layer_dir, f"W{name}.csv"))
        U = _load_gate_matrix(os.path.join(layer_dir, f"U{name}.csv"))
        b = _load_gate(os.path.join(layer_dir, f"b{name}.csv"))
        if transposed:
            W, U = W.T, U.T
        Wg.append(W)
        Ug.append(U)
        bg.append(b)
    return LSTMLayer(
        _tensor(np.concatenate(Wg, axis=1), dtype, device),
        _tensor(np.concatenate(Ug, axis=1), dtype, device),
        _tensor(np.concatenate(bg), dtype, device),
    )


def list_layer_dirs(savpath: str) -> list:
    """``lstm_*`` subdirectories of a weight-export directory in layer order:
    numeric suffixes in numeric order (lstm_2 before lstm_10), others after,
    by name."""
    def _order(d):
        suffix = d[len("lstm_"):]
        return (0, int(suffix), d) if suffix.isdigit() else (1, 0, d)

    return sorted(
        (
            d for d in os.listdir(savpath)
            if d.startswith("lstm_") and os.path.isdir(os.path.join(savpath, d))
        ),
        key=_order,
    )


def load_model_from_csv(
    savpath: str,
    layer_dirs: Sequence[str] | None = None,
    dense_dir: str = "dense_top",
    transposed: bool | None = None,
    dtype=torch.float32,
    device: str | torch.device = "cuda",
) -> StackedLSTM:
    """Load a whole stacked model from a model_weights/-style directory onto
    ``device`` (the card unless ``device="cpu"``); with a ``conv/``
    directory, the ``ConvLSTM`` hybrid.

    ``layer_dirs`` default: every ``lstm_*`` subdirectory in layer order.
    ``transposed=None`` (default) reads a directory with the ``layout.txt``
    marker untransposed and a bare fixture directory transposed."""
    if transposed is None:
        transposed = not os.path.exists(os.path.join(savpath, _LAYOUT_MARKER))
    if layer_dirs is None:
        layer_dirs = list_layer_dirs(savpath)
    layers = [
        load_layer_from_csv(os.path.join(savpath, d), transposed, dtype, device)
        for d in layer_dirs
    ]
    w = np.atleast_1d(np.loadtxt(os.path.join(savpath, dense_dir, "weights.csv"), delimiter=","))
    b = np.atleast_1d(np.loadtxt(os.path.join(savpath, dense_dir, "bias.csv"), delimiter=","))
    if w.ndim == 1:
        w = w[:, None]
    head = DenseHead(_tensor(w, dtype, device), _tensor(b.reshape(-1), dtype, device))
    conv = load_conv_front_csv(savpath, dtype, device)
    if conv is not None:
        return ConvLSTM(conv, layers, head)
    return StackedLSTM(layers, head)


def save_model_weights_as_json(model, savpath: str = "model_weights.json") -> None:
    """Whole-model JSON dump of a dense model (reference
    load_preprocess.py:80-90): ``layer<i>`` = [W, U, b], then the head."""
    params = to_numpy_tree(model)
    if type(params).__name__ != "StackedLSTMParams":
        raise TypeError(f"the JSON dump holds a dense model, not {type(model).__name__}")
    data = {}
    for i, layer in enumerate(params.layers):
        data[f"layer{i}"] = [layer.W.tolist(), layer.U.tolist(), layer.b.tolist()]
    data[f"layer{len(params.layers)}"] = [params.head.w.tolist(), params.head.b.tolist()]
    with open(savpath, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=4)


def json_to_csv(json_file: str, savpath: str) -> None:
    """Dump every list-valued entry of a JSON file to <name>.csv (reference
    load_preprocess.py:130-143). A ragged entry (a [W, U, b] layer) splits
    into ``<name>_<j>.csv`` per component."""
    with open(json_file) as f:
        data = json.load(f)
    os.makedirs(savpath, exist_ok=True)
    for name, dataset in data.items():
        if not isinstance(dataset, list):
            continue
        try:
            arr = np.asarray(dataset, dtype=np.float64)
        except ValueError:
            arr = None  # inhomogeneous (a [W, U, b] layer entry)
        if arr is not None and arr.dtype != object:
            np.savetxt(os.path.join(savpath, f"{name}.csv"), arr, delimiter=",")
        else:
            for j, part in enumerate(dataset):
                np.savetxt(
                    os.path.join(savpath, f"{name}_{j}.csv"),
                    np.asarray(part, dtype=np.float64),
                    delimiter=",",
                )


def predictions_to_csv(path: str, y) -> None:
    """Persist a whole-run prediction, one float per line (the shipped
    ``model_prediction.csv`` fixture's format)."""
    np.savetxt(path, to_numpy(y).reshape(-1), delimiter=",")


def preprocessed_to_csv(savpath: str, t, y, X=None) -> None:
    """Persist preprocessed series as ``preprocessed_DROPBEAR_{t,y,X}.csv``
    (reference load_preprocess.py:146-165)."""
    os.makedirs(savpath, exist_ok=True)
    np.savetxt(os.path.join(savpath, "preprocessed_DROPBEAR_t.csv"), to_numpy(t).reshape(-1), delimiter=",")
    np.savetxt(os.path.join(savpath, "preprocessed_DROPBEAR_y.csv"), to_numpy(y).reshape(-1), delimiter=",")
    if X is not None:
        X = to_numpy(X)
        np.savetxt(os.path.join(savpath, "preprocessed_DROPBEAR_X.csv"),
                   X.reshape(X.shape[-2] if X.ndim == 3 else X.shape[0], -1), delimiter=",")
