"""Real-time streaming inference: the state-carrying single-step API.

Counterpart of ``svd_lstm_tpu/models/streaming.py``: the deployment
semantics of the reference's per-sample, state-carrying batch-1 cells
(code/old_versions/svd_classes.py:104-119) as a functional API,
``state = init_stream(model)``, then ``y, state = stream_step(model, state,
frame)`` per incoming frame. A step never writes into the state it is given.
Covers the dense, singular and reduced families, merged and split; the conv
hybrids are ROADMAP queue 1 item 7.

:func:`make_stream_fn` is the deployment loop's step. Its layers are packed
once (the reduced layers' ``[I|C]`` folds and the split layers' padded
stacks), and for a model on the card the packed step is captured once as a
CUDA graph over static frame and state buffers: a frame is then one copy
in, one graph replay and one copy out, where the eager step issues a few
dozen kernels. On the CPU the step is the eager packed step.
"""

from __future__ import annotations

from typing import Tuple

import torch

from svd_lstm_tpu_torch.models.lstm import gate_update
from svd_lstm_tpu_torch.models.reduced import folded_projection
from svd_lstm_tpu_torch.models.singular import (
    singular_input_projection,
    singular_recurrent_product,
)
from svd_lstm_tpu_torch.utils.precision import exact_matmul

StreamState = Tuple  # per layer (h, c)


def _layers(model):
    if hasattr(model, "conv") or hasattr(model, "inner"):
        raise NotImplementedError(
            f"streaming {type(model).__name__}: conv hybrids are not ported yet "
            "(ROADMAP queue 1, item 7)"
        )
    return model.layers


def init_stream(model, batch: int = 1, dtype=torch.float32, device=None) -> StreamState:
    """Zero (h, c) for every layer, on ``device`` (default: the model's)."""
    if device is None:
        device = model.head.w.device
    return tuple(
        (torch.zeros((batch, l.units), dtype=dtype, device=device),
         torch.zeros((batch, l.units), dtype=dtype, device=device))
        for l in _layers(model)
    )


def _layer_step(layer, x, h, c):
    if hasattr(layer, "wB"):  # ReducedLayer
        z = (folded_projection(layer.wB, layer.wC)(x) + layer.b
             + folded_projection(layer.uB, layer.uC)(h))
    elif hasattr(layer, "ws"):  # SingularLayer
        z = singular_input_projection(layer, x) + singular_recurrent_product(layer, h)
    else:  # LSTMLayer
        z = x @ layer.W + h @ layer.U + layer.b
    return gate_update(z, c)


def stream_step(model, state: StreamState, frame: torch.Tensor):
    """One frame in, one prediction out, in exact float32 matmuls. frame:
    (batch, d); returns (y (batch, head_dim), new_state). Autograd follows
    the caller's mode."""
    x = frame
    new_state = []
    with exact_matmul():
        for layer, (h, c) in zip(_layers(model), state):
            h, c = _layer_step(layer, x, h, c)
            new_state.append((h, c))
            x = h
        y = model.head(x)
    return y, tuple(new_state)


def stream_many(model, state: StreamState, frames: torch.Tensor):
    """Chunked streaming: frames (batch, K, d) -> (y (batch, K, head_dim),
    state), a loop of :func:`stream_step` over the chunk's frames."""
    ys = []
    for k in range(frames.shape[1]):
        y, state = stream_step(model, state, frames[:, k])
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _packed_step(model):
    """The step of :func:`stream_step` with every layer's packing done once:
    the same products in the same order."""
    fns = []
    for layer in _layers(model):
        if hasattr(layer, "wB"):
            wp = folded_projection(layer.wB, layer.wC)
            up = folded_projection(layer.uB, layer.uC)

            def fn(x, h, c, wp=wp, up=up, b=layer.b):
                return gate_update(wp(x) + b + up(h), c)
        else:
            def fn(x, h, c, layer=layer):
                return _layer_step(layer, x, h, c)
        fns.append(fn)
    head = model.head

    def step(state, frame):
        x = frame
        new_state = []
        for fn, (h, c) in zip(fns, state):
            h, c = fn(x, h, c)
            new_state.append((h, c))
            x = h
        return head(x), tuple(new_state)

    return step


def _graph_step(step, state0: StreamState, frame0: torch.Tensor):
    """``step`` captured as a CUDA graph. The frame and the state are copied
    into one static input buffer (one kernel), the graph replays, and its
    static output buffer ([y | h_0 | c_0 | ...]) is cloned (one kernel) and
    handed out as views of the clone: fresh tensors every call, so a state
    the caller holds is never overwritten."""
    parts_in = [frame0] + [t for hc in state0 for t in hc]
    static_in = torch.cat([t.reshape(-1) for t in parts_in])
    sizes_in = [t.numel() for t in parts_in]

    def unpack_in(buf):
        views = [v.view(t.shape) for v, t in zip(buf.split(sizes_in), parts_in)]
        return views[0], tuple(zip(views[1::2], views[2::2]))

    frame_v, state_v = unpack_in(static_in)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture (cuBLAS handles, workspaces)
        for _ in range(2):
            step(state_v, frame_v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, new_state = step(state_v, frame_v)
        parts_out = [y] + [t for hc in new_state for t in hc]
        static_out = torch.cat([t.reshape(-1) for t in parts_out])
    sizes_out = [t.numel() for t in parts_out]
    shapes_out = [t.shape for t in parts_out]

    def graph_step(state, frame):
        torch.cat([t.reshape(-1) for t in (frame, *(t for hc in state for t in hc))], out=static_in)
        graph.replay()
        views = [v.view(s) for v, s in zip(static_out.clone().split(sizes_out), shapes_out)]
        return views[0], tuple(zip(views[1::2], views[2::2]))

    # the graph reads the packed weights and its pool by address: hold them
    graph_step.graph, graph_step.step = graph, step
    return graph_step


def make_stream_fn(model, batch: int = 1, dtype=torch.float32):
    """Pre-packed streaming step: returns ``(step_fn, state0)`` with
    ``y, state = step_fn(state, frame)`` for frames (batch, d) on the model's
    device. On the card ``step_fn`` replays a CUDA graph of the packed step
    (a capture that fails raises); on the CPU it is the eager packed step.
    The step runs without autograd, in exact float32 matmuls."""
    state0 = init_stream(model, batch, dtype)
    with torch.no_grad():
        packed = _packed_step(model)

    def eager(state, frame):
        with torch.no_grad(), exact_matmul():
            return packed(state, frame)

    device = state0[0][0].device
    if device.type != "cuda":
        return eager, state0
    d = model.layers[0].input_dim
    frame0 = torch.zeros((batch, d), dtype=dtype, device=device)
    with torch.no_grad(), exact_matmul():
        return _graph_step(packed, state0, frame0), state0
