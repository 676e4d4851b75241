"""int8 binary deployment artifact for the native runtime.

Counterpart of ``svd_lstm_tpu/io/int8_export.py``, numpy inside: it takes
port models on any device and writes the same bytes as the JAX package for
the same model. One little-endian file holds every weight matrix
int8-quantized per output column (``w ~= q * scale``, ``scale =
max|col|/127``, ``utils/quantize.py``'s scheme) for the native C++ runtime
(``svdlstm_load_int8``), which dequantizes on load so the streaming math
stays float32.

Format (all little-endian; "qmat" = u32 rows, u32 cols, f32 scale[cols],
i8 data[rows*cols] row-major; "fvec" = u32 len, f32 data[len]):

    magic  "SVDL8BIN"            (8 bytes)
    u32    version (2 for LSTM stacks, 3 when a conv front end is present)
    u32    n_layers
    [version 3 only] u8 has_conv; if 1: u32 k, u32 c_in,
           qmat w ((k·c_in) x filters, tap-major rows), fvec b (filters)
    per layer:
      u8   kind: 'd' dense | 'r' reduced (split) | 'm' reduced (merged)
      dense:   qmat W (in x 4n), qmat U (n x 4n), fvec b (4n)
      reduced 'r': per gate g in [i,f,c,o]: qmat wB_g, qmat wC_g (cols may
               be 0 at full rank); then per gate: qmat uB_g, qmat uC_g;
               then fvec b (4n)
      reduced 'm': qmat wB (in x r), qmat wC (r x 4n-r), qmat uB, qmat uC,
               fvec b (4n)
    head: fvec w (n), f32 bias

Reduced models get **compensated quantization** (default on): the
two-step second factor ``C = V1^-1 V2`` carries the inverse's dynamic
range, so before quantizing C it is re-solved against the already-quantized
B, ``C' = argmin ||deq(q(B)) C' - B C||_F``, and whichever of C and C'
encodes the second block better is written.
"""

from __future__ import annotations

import os
import struct

import numpy as np

MAGIC = b"SVDL8BIN"
VERSION = 2


def _q(mat: np.ndarray):
    """Per-output-column symmetric int8 quantization (the scheme of
    ``utils/quantize.py``, in numpy)."""
    w = np.asarray(mat, np.float32)
    if w.size == 0:
        return np.zeros(w.shape, np.int8), np.zeros((w.shape[1],), np.float32)
    scale = np.max(np.abs(w), axis=0) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _dq(mat: np.ndarray) -> np.ndarray:
    """The float32 matrix the int8 artifact encodes for ``mat``."""
    q, scale = _q(mat)
    return (q.astype(np.float32) * scale).astype(np.float32)


def _compensated_gate_pairs(Bs, Cs, compensate: bool):
    """The (B, C) pairs actually encoded for one side (w or u) of a reduced
    layer (numpy arrays). With ``compensate``, C is re-solved against the
    quantized B before its own quantization, ``C' = lstsq(deq(q(B)), B @ C)``,
    and kept only where its encoding reconstructs the second block better.
    Shared by the exporter, :func:`dequantized_params` and
    ``utils.quantize.quantize_params``, so the artifacts and their oracle
    make the same choice."""
    out = []
    for B, C in zip(Bs, Cs):
        B = np.asarray(B, np.float32)
        C = np.asarray(C, np.float32)
        if compensate and C.size:
            Bdq = _dq(B)
            target = B @ C
            C2 = np.linalg.lstsq(Bdq, target, rcond=None)[0].astype(np.float32)
            if np.linalg.norm(Bdq @ _dq(C2) - target) < np.linalg.norm(
                Bdq @ _dq(C) - target
            ):
                C = C2
        out.append((B, C))
    return out


def _write_qmat(f, mat: np.ndarray) -> None:
    q, scale = _q(mat)
    rows, cols = q.shape
    f.write(struct.pack("<II", rows, cols))
    f.write(scale.tobytes())
    f.write(np.ascontiguousarray(q).tobytes())


def _write_fvec(f, v: np.ndarray) -> None:
    v = np.asarray(v, np.float32).reshape(-1)
    f.write(struct.pack("<I", v.size))
    f.write(v.tobytes())


def _numpy_model(model):
    """A dense or reduced port model, or the conv hybrid of either (or its
    tree), as ``(conv tree or None, the stack's numpy tree)``; other
    families raise ``TypeError``."""
    from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES, to_numpy_tree

    tree = to_numpy_tree(model)
    conv, name = None, type(tree).__name__
    if name == "ConvLSTMParams":
        conv, tree = tree.conv, NODE_TYPES["StackedLSTMParams"](layers=tree.layers, head=tree.head)
    elif name == "ConvReducedParams":
        conv, tree = tree.conv, tree.inner
    if type(tree).__name__ not in ("StackedLSTMParams", "ReducedModelParams"):
        raise TypeError(f"unsupported model params: {type(model).__name__}")
    return conv, tree


def save_model_int8_bin(model, path: str, compensate: bool = True) -> int:
    """Write a dense (``StackedLSTM``) or reduced (``ReducedLSTM``) model, or
    its conv hybrid (``ConvLSTM``, ``ConvReducedLSTM``: version 3), on any
    device, as the int8 binary artifact. Returns the file size in bytes.
    ``compensate`` (default True) applies the least-squares C-factor
    compensation to reduced models; False writes the raw per-matrix
    quantization."""
    conv, params = _numpy_model(model)
    head_b = np.asarray(params.head.b).reshape(-1)
    if head_b.size != 1:
        # the artifact (and the native runtime's scalar y = b + w·h) encodes a
        # single-output head; a multi-output model would lose all but the first
        raise ValueError(
            f"int8 binary export supports a single-output head, got head_dim={head_b.size}"
        )
    dense = type(params).__name__ == "StackedLSTMParams"
    # everything is validated before the file opens: a raise mid-stream would
    # leave a truncated artifact at the target path
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", VERSION if conv is None else 3, len(params.layers)))
        if conv is not None:
            w = np.asarray(conv.w, np.float32)  # (k, c_in, filters)
            k, c_in, filters = w.shape
            f.write(struct.pack("<B", 1))
            f.write(struct.pack("<II", k, c_in))
            _write_qmat(f, w.reshape(k * c_in, filters))
            _write_fvec(f, conv.b)
        for layer in params.layers:
            if dense:
                f.write(b"d")
                _write_qmat(f, layer.W)
                _write_qmat(f, layer.U)
            elif isinstance(layer.wB, tuple):  # split: per-gate factors
                f.write(b"r")
                for side_B, side_C in ((layer.wB, layer.wC), (layer.uB, layer.uC)):
                    for B, C in _compensated_gate_pairs(side_B, side_C, compensate):
                        _write_qmat(f, B)
                        _write_qmat(f, C)
            else:  # merged: one factor pair per side
                f.write(b"m")
                for side_B, side_C in ((layer.wB, layer.wC), (layer.uB, layer.uC)):
                    ((B, C),) = _compensated_gate_pairs((side_B,), (side_C,), compensate)
                    _write_qmat(f, B)
                    _write_qmat(f, C)
            _write_fvec(f, layer.b)
        _write_fvec(f, np.asarray(params.head.w).reshape(-1))
        f.write(struct.pack("<f", float(head_b[0])))
    return os.path.getsize(path)


def dequantized_params(model, compensate: bool = True):
    """The float32 model the int8 artifact encodes (every matrix quantized and
    dequantized; biases and head exact), as port modules on the model's
    device: the oracle the native runtime must match. ``compensate`` must
    match what :func:`save_model_int8_bin` was called with. A conv hybrid's
    kernel is dequantized per filter, its bias exact."""
    from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES, from_numpy_tree

    conv, params = _numpy_model(model)
    device = next(model.parameters()).device if hasattr(model, "parameters") else "cpu"
    stack = _dequantized_stack(params, compensate)
    if conv is not None:
        w = np.asarray(conv.w, np.float32)
        k, c_in, filters = w.shape
        conv = conv._replace(w=_dq(w.reshape(k * c_in, filters)).reshape(k, c_in, filters))
        if type(stack).__name__ == "StackedLSTMParams":
            stack = NODE_TYPES["ConvLSTMParams"](conv=conv, layers=stack.layers, head=stack.head)
        else:
            stack = NODE_TYPES["ConvReducedParams"](conv=conv, inner=stack)
    return from_numpy_tree(stack, device)


def _dequantized_stack(params, compensate: bool):
    """The numpy tree of the float32 stack the artifact encodes."""
    from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES

    if type(params).__name__ == "StackedLSTMParams":
        layers = tuple(l._replace(W=_dq(l.W), U=_dq(l.U)) for l in params.layers)
        return params._replace(layers=layers)

    def side(Bs, Cs):
        split = isinstance(Bs, tuple)
        pairs = _compensated_gate_pairs(Bs if split else (Bs,), Cs if split else (Cs,), compensate)
        qB = tuple(_dq(B) for B, _ in pairs)
        qC = tuple(_dq(C) if C.size else C for _, C in pairs)
        return (qB, qC) if split else (qB[0], qC[0])

    layers = []
    for l in params.layers:
        wB, wC = side(l.wB, l.wC)
        uB, uC = side(l.uB, l.uC)
        layers.append(NODE_TYPES["ReducedLayerParams"](wB=wB, wC=wC, uB=uB, uC=uC, b=l.b))
    return params._replace(layers=tuple(layers))
