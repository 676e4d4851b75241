"""Parameter checkpointing in the JAX package's ``.npz`` format.

Counterpart of ``svd_lstm_tpu/io/checkpoint.py``: a compressed ``.npz`` of
leaf arrays plus a JSON ``__spec__`` holding the tree (NamedTuple node
names and tuples; model checkpoints hold nothing else), read with
``allow_pickle=False``. A checkpoint written by either package loads in the
other, int8-quantized ones (``QuantizedTensor`` nodes, ``export --int8``'s
``model_int8.npz``) included.

The interchange between the two packages is the *numpy tree*: NamedTuples
whose type names and fields are the JAX package's parameter types, with
numpy leaves. :func:`to_numpy_tree` turns a port module into one;
:func:`from_numpy_tree` turns one (or the JAX package's own parameter
NamedTuples) into port modules, with row-major tensors.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any

import numpy as np
import torch

from svd_lstm_tpu_torch.models.lstm import DenseHead, LSTMLayer, StackedLSTM
from svd_lstm_tpu_torch.models.reduced import ReducedLayer, ReducedLSTM
from svd_lstm_tpu_torch.models.singular import SingularLayer, SingularLSTM
from svd_lstm_tpu_torch.utils.quantize import QuantizedTensor

_FIELDS = {
    "DenseParams": ("w", "b"),
    "LSTMLayerParams": ("W", "U", "b"),
    "StackedLSTMParams": ("layers", "head"),
    "SingularLayerParams": ("wl", "ws", "wr", "ul", "us", "ur", "b"),
    "SingularModelParams": ("layers", "head"),
    "ReducedLayerParams": ("wB", "wC", "uB", "uC", "b"),
    "ReducedModelParams": ("layers", "head"),
    "QuantizedTensor": QuantizedTensor._fields,
}
# numpy-tree node types, named as the JAX package names its parameter types
NODE_TYPES = {name: collections.namedtuple(name, fields) for name, fields in _FIELDS.items()}
NODE_TYPES["QuantizedTensor"] = QuantizedTensor

_MODULE_OF_NODE = {
    "DenseParams": DenseHead,
    "LSTMLayerParams": LSTMLayer,
    "StackedLSTMParams": StackedLSTM,
    "SingularLayerParams": SingularLayer,
    "SingularModelParams": SingularLSTM,
    "ReducedLayerParams": ReducedLayer,
    "ReducedModelParams": ReducedLSTM,
}
_NODE_OF_MODULE = {cls: name for name, cls in _MODULE_OF_NODE.items()}


def _unsupported(name: str) -> TypeError:
    return TypeError(
        f"checkpoint node type {name!r} is not supported by svd_lstm_tpu_torch "
        f"yet; supported: {sorted(_FIELDS)}"
    )


def _node(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def from_numpy_tree(tree: Any, device: str | torch.device = "cuda") -> Any:
    """NamedTuple parameter tree with array leaves (the JAX package's own
    types, or :data:`NODE_TYPES`) -> port modules on ``device``: the card
    unless ``device="cpu"`` is asked for (with no card, the default
    raises, as torch does). Array leaves are copied into tensors of their
    own dtype; tensor leaves are moved to ``device`` (not copied when they
    are there already)."""
    if _node(tree):
        name = type(tree).__name__
        if name not in _MODULE_OF_NODE:
            raise _unsupported(name)
        kids = {k: from_numpy_tree(getattr(tree, k), device) for k in _FIELDS[name]}
        if "layers" in kids:
            return _MODULE_OF_NODE[name](kids["layers"], kids["head"])
        return _MODULE_OF_NODE[name](**kids)
    if isinstance(tree, tuple):
        return tuple(from_numpy_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device).contiguous()
    # row-major whatever the source's order (a saved leaf may be Fortran-ordered)
    return torch.tensor(np.ascontiguousarray(tree), device=device)


def map_tree(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of a tree of NamedTuples and tuples; a
    :class:`QuantizedTensor` is one leaf."""
    if isinstance(tree, QuantizedTensor) or not isinstance(tree, tuple):
        return fn(tree)
    kids = [map_tree(fn, v) for v in tree]
    return type(tree)(*kids) if _node(tree) else tuple(kids)


def to_tensor_tree(module: Any) -> Any:
    """Port module -> :data:`NODE_TYPES` tree whose leaves are the module's
    own parameters (no copy, still in autograd's graph). A tree passes
    through unchanged."""
    if isinstance(module, tuple):
        return module
    if isinstance(module, torch.Tensor):
        return module
    if isinstance(module, (torch.nn.ModuleList, torch.nn.ParameterList)):
        return tuple(to_tensor_tree(m) for m in module)
    name = _NODE_OF_MODULE.get(type(module))
    if name is None:
        raise TypeError(f"cannot convert {type(module).__name__!r} to a parameter tree")
    return NODE_TYPES[name](**{k: to_tensor_tree(getattr(module, k)) for k in _FIELDS[name]})


def map_arrays(fn, tree: Any) -> Any:
    """``fn`` applied to every array of a tree, a :class:`QuantizedTensor`'s
    ``q`` and ``scale`` included."""
    return map_tree(lambda x: QuantizedTensor(fn(x.q), fn(x.scale))
                    if isinstance(x, QuantizedTensor) else fn(x), tree)


def to_numpy(x: Any) -> np.ndarray:
    """A tensor on any device (or an array) as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_numpy_tree(module: Any) -> Any:
    """Port module, or a tree with tensor leaves (a quantized model) ->
    numpy tree (:data:`NODE_TYPES` with numpy leaves)."""
    return map_arrays(to_numpy, to_tensor_tree(module))


def is_quantized(tree: Any) -> bool:
    """Whether a tree holds a :class:`QuantizedTensor` leaf."""
    found = []
    map_tree(lambda x: found.append(isinstance(x, QuantizedTensor)), tree)
    return any(found)


def _spec_of(obj: Any, leaves: list) -> Any:
    if _node(obj):
        if type(obj).__name__ not in _FIELDS:
            raise _unsupported(type(obj).__name__)
        return {
            "__node__": type(obj).__name__,
            "fields": {k: _spec_of(v, leaves) for k, v in obj._asdict().items()},
        }
    if isinstance(obj, tuple):
        return {"__tuple__": [_spec_of(v, leaves) for v in obj]}
    idx = len(leaves)
    leaves.append(np.asarray(obj))
    return {"__leaf__": idx}


def _build(spec: Any, leaves) -> Any:
    if "__leaf__" in spec:
        return leaves[spec["__leaf__"]]
    if "__node__" in spec:
        name = spec["__node__"]
        if name not in NODE_TYPES:
            raise _unsupported(name)
        if tuple(spec["fields"]) != _FIELDS[name]:
            raise TypeError(f"checkpoint node {name!r} has fields {tuple(spec['fields'])}, "
                            f"expected {_FIELDS[name]}")
        return NODE_TYPES[name](**{k: _build(v, leaves) for k, v in spec["fields"].items()})
    if "__tuple__" in spec:
        return tuple(_build(v, leaves) for v in spec["__tuple__"])
    raise ValueError(f"bad checkpoint spec node: {spec}")


def save_params(path: str, module: Any) -> None:
    """Save a dense/singular/reduced model, or a quantized one (the tree of
    ``utils.quantize.quantize_params``), to ``path`` (``.npz``; parent dirs
    are created) in the format ``svd_lstm_tpu.io.checkpoint`` reads."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    leaves: list = []
    spec = _spec_of(to_numpy_tree(module), leaves)
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    np.savez_compressed(path, __spec__=json.dumps(spec), **arrays)


def load_params(path: str, device: str | torch.device = "cuda") -> Any:
    """Load a model saved by either package's ``save_params`` onto
    ``device``: the card unless ``device="cpu"`` is asked for. A quantized
    checkpoint loads as its tree (:data:`NODE_TYPES`, int8 ``q`` and float32
    ``scale`` leaves on ``device``; ``utils.quantize.dequantize_params``
    makes it a model). A suffix-less ``path`` falls back to
    ``path + '.npz'``."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(str(z["__spec__"]))
        n_leaves = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n_leaves)]
    tree = _build(spec, leaves)
    if is_quantized(tree):
        return map_arrays(lambda a: from_numpy_tree(a, device), tree)
    return from_numpy_tree(tree, device)
