"""Int8 weight quantization: a compression axis beside rank truncation.

Counterpart of ``svd_lstm_tpu/utils/quantize.py``. Scheme: for a matrix leaf
``w``, per-output-column symmetric scaling ``s = max|w| / 127`` (axis 0
reduced, keepdims) and ``q = round(w / s)`` in int8, so ``|w - q·s| <= s/2``
elementwise up to float32 rounding. 1-D leaves (biases, σ vectors) stay
float32, and so does σ of a split singular layer, stacked to (4, k): σ is
what the Hoyer fine-tune trains. Reduced layers quantize the compensated
(B, C) pairs of the binary exporter (``io/int8_export._compensated_gate_pairs``:
C re-solved against the quantized B), so the ``.npz`` and ``.bin`` artifacts
encode the same float32 model. A conv hybrid's kernel (k, c_in, filters) is
quantized per filter: one scale over its k·c_in taps, the (k·c_in ×
filters) per-column scheme of the ``.bin``'s conv section, stored as a
(1, 1, filters) scale; its bias stays float32 and the stack follows its
family's rule.

A quantized model is a tree, not an ``nn.Module``: the ``NODE_TYPES``
namedtuples of ``io/checkpoint.py`` with :class:`QuantizedTensor` leaves (and
float32 tensor leaves for what stays float32), on the model's device. int8
tensors are not trainable parameters. The weights stay int8 in device memory
until :func:`dequantize_params` widens them for a call
(:func:`quantized_apply`): that widening is an elementwise pass that writes
the float32 weights to device memory before the forward runs, not a
widening on chip inside the kernels. No kernel of either package takes int8
weights.

The QAT view (:func:`fake_quantize_params`, :func:`qat_apply`) trains the
float32 master weights through the int8 grid with the straight-through
estimator ``w + (enc - w).detach()``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class QuantizedTensor(NamedTuple):
    """An int8-quantized matrix: ``w ~= q.float() * scale``."""

    q: torch.Tensor  # int8, the original's shape
    scale: torch.Tensor  # float32, (1, ..., cols): per output column

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.numel() * 1 + self.scale.numel() * 4


def quantize_tensor(w, axis: int = 0) -> QuantizedTensor:
    """Symmetric int8 quantization with a per-column scale (reduce ``axis``)."""
    w = torch.as_tensor(w, dtype=torch.float32)
    scale = w.abs().amax(dim=axis, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scale)


def dequantize_tensor(t: QuantizedTensor) -> torch.Tensor:
    return t.q.to(torch.float32) * t.scale


def _is_qt(x: Any) -> bool:
    return isinstance(x, QuantizedTensor)


def _is_matrix(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.ndim >= 2 and x.is_floating_point()


def _tree(params: Any) -> Any:
    """The parameter tree of a model (its own tensors), or the tree itself."""
    from svd_lstm_tpu_torch.io.checkpoint import to_tensor_tree

    return to_tensor_tree(params)


def _conv_kernel_grid(w: torch.Tensor, fn) -> Any:
    """``fn`` (a per-column quantizer of a matrix) over a conv kernel (k,
    c_in, filters) viewed as the (k·c_in, filters) matrix: one scale a
    filter. Returns ``fn``'s result reshaped back (a tensor, or a
    :class:`QuantizedTensor` with a (1, 1, filters) scale)."""
    k, c_in, filters = w.shape
    out = fn(w.reshape(k * c_in, filters))
    if _is_qt(out):
        return QuantizedTensor(out.q.reshape(k, c_in, filters), out.scale.reshape(1, 1, filters))
    return out.reshape(k, c_in, filters)


def _split_conv(tree: Any, recurse) -> Any:
    """A conv hybrid's tree with ``recurse`` applied to its stack's tree
    (a dense ``ConvLSTMParams`` stack as ``StackedLSTMParams``), or None
    for a tree without a conv front end."""
    from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES

    name = type(tree).__name__
    if name == "ConvLSTMParams":
        inner = recurse(NODE_TYPES["StackedLSTMParams"](layers=tree.layers, head=tree.head))
        return tree._replace(layers=inner.layers, head=inner.head)
    if name in ("ConvSingularParams", "ConvReducedParams"):
        return tree._replace(inner=recurse(tree.inner))
    return None


def _leaves(tree: Any) -> list:
    from svd_lstm_tpu_torch.io.checkpoint import map_tree

    out: list = []
    map_tree(out.append, tree)
    return out


def _device(tree: Any) -> torch.device:
    leaf = _leaves(tree)[0]
    return (leaf.q if _is_qt(leaf) else leaf).device


def quantize_params(params: Any) -> Any:
    """Quantize every floating matrix leaf (ndim >= 2) of a dense, singular
    or reduced model or a conv hybrid to a :class:`QuantizedTensor`; 1-D
    leaves and σ stay float32. Returns the model's tree (``io.checkpoint.NODE_TYPES``) on its
    device, which ``io.checkpoint.save_params`` writes and
    :func:`quantized_apply`-wrapped forwards take. Idempotent: a quantized
    tree passes through."""
    from svd_lstm_tpu_torch.io.checkpoint import map_tree, to_numpy

    tree = _tree(params)

    def maybe_q(x):
        if _is_qt(x):
            return x
        if _is_matrix(x):
            # split-singular factors are (4, rows, cols): reduce the ROW axis
            # within each gate so the scheme stays per output column
            return quantize_tensor(x.detach(), axis=x.ndim - 2)
        return x.detach() if isinstance(x, torch.Tensor) else x

    hybrid = _split_conv(tree, quantize_params)
    if hybrid is not None:
        w = hybrid.conv.w
        qw = w if _is_qt(w) else _conv_kernel_grid(w.detach(), quantize_tensor)
        return hybrid._replace(conv=hybrid.conv._replace(w=qw, b=hybrid.conv.b.detach()))

    name = type(tree).__name__
    if name == "ReducedModelParams":
        from svd_lstm_tpu_torch.io.int8_export import _compensated_gate_pairs

        def side(Bs, Cs):
            if _is_qt(Bs) or _is_qt(Bs[0]):  # idempotent, like maybe_q
                return Bs, Cs
            split = isinstance(Bs, tuple)
            first = Bs[0] if split else Bs
            pairs = _compensated_gate_pairs(
                [to_numpy(B) for B in (Bs if split else (Bs,))],
                [to_numpy(C) for C in (Cs if split else (Cs,))],
                True,
            )
            qB = tuple(maybe_q(torch.from_numpy(B).to(first.device)) for B, _ in pairs)
            qC = tuple(maybe_q(torch.from_numpy(C).to(first.device)) for _, C in pairs)
            return (qB, qC) if split else (qB[0], qC[0])

        layers = []
        for l in tree.layers:
            wB, wC = side(l.wB, l.wC)
            uB, uC = side(l.uB, l.uC)
            layers.append(l._replace(wB=wB, wC=wC, uB=uB, uC=uC, b=maybe_q(l.b)))
        return tree._replace(layers=tuple(layers), head=map_tree(maybe_q, tree.head))

    if name == "SingularModelParams":
        # only the U/V factors: split σ stacks to (4, k), which the ndim
        # rule alone would quantize
        layers = tuple(
            l._replace(
                wl=maybe_q(l.wl), ws=l.ws.detach(), wr=maybe_q(l.wr),
                ul=maybe_q(l.ul), us=l.us.detach(), ur=maybe_q(l.ur), b=l.b.detach(),
            )
            for l in tree.layers
        )
        return tree._replace(layers=layers, head=map_tree(maybe_q, tree.head))

    return map_tree(maybe_q, tree)


def dequantize_params(qparams: Any) -> Any:
    """Inverse of :func:`quantize_params`: the float32 model (port modules) on
    the tree's device. A model passes through unchanged."""
    from svd_lstm_tpu_torch.io.checkpoint import from_numpy_tree, map_tree

    if isinstance(qparams, torch.nn.Module):
        return qparams
    tree = map_tree(lambda x: dequantize_tensor(x) if _is_qt(x) else x, qparams)
    return from_numpy_tree(tree, _device(tree))


def quantized_apply(apply_fn):
    """Wrap a forward ``apply_fn(model, ...)`` (``predict``,
    ``stacked_lstm_apply``, ...) so it takes a quantized tree: the weights
    are widened to float32 in device memory for the call, then the forward
    runs on the float32 model."""

    def wrapped(qparams, *args, **kwargs):
        return apply_fn(dequantize_params(qparams), *args, **kwargs)

    return wrapped


# --------------------------------------------------------------------------
# Quantization-aware fine-tuning (QAT): train THROUGH the int8 grid.
#
# fake_quantize_params builds a straight-through-estimator view of the
# artifact: forward values are the float32 model the int8 encoding
# represents (the leaves quantize_params targets, the C compensation of the
# exporter), gradients pass through to the float32 master weights unchanged.
# --------------------------------------------------------------------------


def _ste(w: torch.Tensor, encoded: torch.Tensor) -> torch.Tensor:
    """value = encoded, d/dw = identity (straight-through estimator)."""
    return w + (encoded - w).detach()


def fake_quant_tensor(w, axis: int = 0) -> torch.Tensor:
    """STE view of one matrix: forward = dequantize(quantize(w))."""
    w = torch.as_tensor(w, dtype=torch.float32)
    if w.numel() == 0:
        return w
    return _ste(w, dequantize_tensor(quantize_tensor(w.detach(), axis)))


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.lstsq(a, b)[0]`` as the JAX package computes it: the thin
    SVD of ``a``, singular values below ``eps · max(m, n) · s[0]`` dropped."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    mask = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)), torch.zeros_like(s))
    return vt.T @ (s_inv[:, None] * (u.T @ b))


def _fake_quant_compensated_side(Bs, Cs):
    """STE view of one reduced side (w or u) under the exporter's
    compensated encoding, on the factors' device: B encodes plainly; C is
    re-solved against the encoded B, then whichever of {raw C, re-solved C}
    reconstructs the second block better is the value trained against.
    The encoded values carry no gradient, so both B and C get the plain STE
    identity."""
    from svd_lstm_tpu_torch.utils.precision import exact_matmul

    split = isinstance(Bs, tuple)
    outB, outC = [], []
    for B, C in zip(Bs if split else (Bs,), Cs if split else (Cs,)):
        with torch.no_grad(), exact_matmul():
            Benc = dequantize_tensor(quantize_tensor(B.detach(), axis=0))
            if C.numel():
                target = B.detach() @ C.detach()
                C2 = _lstsq(Benc, target)
                Cenc = dequantize_tensor(quantize_tensor(C.detach(), axis=0))
                C2enc = dequantize_tensor(quantize_tensor(C2, axis=0))
                use_comp = torch.linalg.norm(Benc @ C2enc - target) < torch.linalg.norm(
                    Benc @ Cenc - target
                )
                Cv = torch.where(use_comp, C2enc, Cenc)
        outB.append(_ste(B, Benc))
        outC.append(_ste(C, Cv) if C.numel() else C)
    if split:
        return tuple(outB), tuple(outC)
    return outB[0], outC[0]


def fake_quantize_params(params: Any) -> Any:
    """The STE (QAT) view of a float32 model: its tree
    (``io.checkpoint.NODE_TYPES``) with every leaf that :func:`quantize_params`
    quantizes replaced by its encoded value, in autograd's graph of the
    model's parameters with the identity gradient. Other leaves are the
    model's own parameters. Refuses a quantized tree."""
    from svd_lstm_tpu_torch.io.checkpoint import map_tree

    tree = _tree(params)
    if any(_is_qt(x) for x in _leaves(tree)):
        raise ValueError(
            "fake_quantize_params expects float32 master weights, not an "
            "already-quantized tree"
        )

    def maybe_fq(x):
        return fake_quant_tensor(x, axis=x.ndim - 2) if _is_matrix(x) else x

    hybrid = _split_conv(tree, fake_quantize_params)
    if hybrid is not None:
        return hybrid._replace(conv=hybrid.conv._replace(
            w=_conv_kernel_grid(hybrid.conv.w, fake_quant_tensor)))

    name = type(tree).__name__
    if name == "ReducedModelParams":
        layers = []
        for l in tree.layers:
            wB, wC = _fake_quant_compensated_side(l.wB, l.wC)
            uB, uC = _fake_quant_compensated_side(l.uB, l.uC)
            layers.append(l._replace(wB=wB, wC=wC, uB=uB, uC=uC))
        return tree._replace(layers=tuple(layers), head=map_tree(maybe_fq, tree.head))

    if name == "SingularModelParams":
        layers = tuple(
            l._replace(wl=maybe_fq(l.wl), wr=maybe_fq(l.wr), ul=maybe_fq(l.ul), ur=maybe_fq(l.ur))
            for l in tree.layers
        )
        return tree._replace(layers=layers, head=map_tree(maybe_fq, tree.head))

    return map_tree(maybe_fq, tree)


def _named_leaves(tree: Any, prefix: str = ""):
    """(parameter name, leaf) in ``named_parameters()``'s naming."""
    if isinstance(tree, tuple):
        keys = tree._fields if hasattr(tree, "_fields") else range(len(tree))
        for k, v in zip(keys, tree):
            yield from _named_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


class _Bound(torch.nn.Module):
    """``fn(model, ...)`` as a module's forward, for ``functional_call``."""

    def __init__(self, fn, model: torch.nn.Module):
        super().__init__()
        self.fn = fn
        self.model = model

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def qat_apply(apply_fn):
    """Wrap a forward so training runs through the int8 grid:
    ``fit(model, ..., apply_fn=qat_apply(reduced_lstm_apply))`` fine-tunes
    the float32 master weights against the quantized view (QAT); a conv
    hybrid's forward (``conv_reduced_apply``, ...) trains its kernel against
    the per-filter grid. The forward runs on the model with its parameters swapped for the view's
    tensors for the call (``torch.func.functional_call``); the model's own
    parameters stay float32 and take the gradients."""

    def wrapped(model, *args, **kwargs):
        view = {f"model.{k}": v for k, v in _named_leaves(fake_quantize_params(model))}
        return torch.func.functional_call(_Bound(apply_fn, model), view, args, kwargs)

    wrapped.__name__ = f"qat_{getattr(apply_fn, '__name__', 'apply')}"
    return wrapped


def param_bytes(params: Any) -> int:
    """Device-memory footprint of a (possibly quantized) model or tree."""
    from svd_lstm_tpu_torch.io.checkpoint import map_arrays

    total = []
    map_arrays(lambda t: total.append(t.numel() * t.element_size()), _tree(params))
    return int(sum(total))
