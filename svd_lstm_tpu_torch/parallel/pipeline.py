"""Pipeline-parallel whole-run inference: layer stages over the ranks.

Counterpart of ``svd_lstm_tpu/parallel/pipeline.py``, for the workload dp
cannot split: batch-1 inference over one long run, whose recurrence is
sequential in time. A stacked LSTM is a chain of per-layer recurrences,
sequential in time but independent across layers once the layer below's
hidden sequence is known, so:

* the time axis is cut into chunks of ``ct`` steps (the last one shorter
  when ``ct`` does not divide T);
* stage ``s`` (rank ``s``) owns layers ``[s·L/S, (s+1)·L/S)`` and their
  state (h, c), which never leaves it;
* at tick ``k`` stage ``s`` runs its layers over chunk ``k − s`` and hands
  the chunk's hidden sequence to stage ``s + 1`` (``dist.isend`` /
  ``dist.recv``). Ticks 0 to C + S − 2 cover C chunks. The ticks are not
  counted: each stage simply runs its chunks in order, each as soon as the
  stage above has sent it, which is the same wavefront; a stage has
  nothing to do outside its C ticks and its state stays as it is;
* the last stage's hidden sequence is broadcast to every rank, and each
  applies the head.

Inside a stage each layer runs the chunk from its carried state, its
weights folded and packed once a run: the x-side is one product over the
chunk, then at batch 1 on the card
the batch-1 kernels with their final c stored (``ops/cuda_lstm``: K3
``lstm_recurrence`` for a dense layer, K2 ``reduced_recurrence`` for a
reduced one, ``return_c=True``); on CPU tensors the same wrappers run
their plain versions, and at B > 1 the plain scan runs (the JAX package
runs a ``lax.scan`` for every layer). Everything is exact.

Both families the benchmark compares run under the same wavefront: dense
(``StackedLSTM``) and reduced (``ReducedLSTM``, merged or split). The JAX
package zero-pads every layer to one stacked shape, so that one array with
a leading ``pp`` axis can be sharded (its ``_pack_stages``); a rank here
holds its own layers as modules, so nothing is padded. The stages need
uniform units, so that every chunk handed on has one shape.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from svd_lstm_tpu_torch.api import exact_matmul
from svd_lstm_tpu_torch.models.lstm import StackedLSTM, scan_recurrence
from svd_lstm_tpu_torch.models.reduced import (
    ReducedLayer,
    ReducedLSTM,
    folded_projection,
)
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from svd_lstm_tpu_torch.parallel.mesh import Mesh


def _check_stages(model, n_stages: int) -> int:
    """The layers a stage for ``model`` over ``n_stages`` stages; a model of
    non-uniform units or a layer count ``n_stages`` does not divide raises."""
    units = [l.units for l in model.layers]
    if any(u != units[0] for u in units):
        raise ValueError(f"pipeline stages need uniform units, got {units}; "
                         "non-uniform stacks shard over dp instead (parallel/train.py)")
    if len(units) % n_stages:
        raise ValueError(f"{len(units)} layers do not split into {n_stages} stages")
    return len(units) // n_stages


def _layer_runner(layer, batch: int, on_card: bool) -> Callable:
    """One layer's chunk step ``(x (B, t, m), h, c (B, n)) -> (h_seq (B, t,
    n), h, c)`` from the carried state, the layer's weights folded once
    for every chunk of a run, and packed once for the card's batch-1
    kernel."""
    if isinstance(layer, ReducedLayer):
        xside = folded_projection(layer.wB, layer.wC)
        uB, uC = (tuple(layer.uB), tuple(layer.uC)) if layer.split else (layer.uB, layer.uC)
        if batch == 1:
            kernel, args = ck.reduced_recurrence, (uB, uC)
            packed = ck.pack_reduced_recurrence(uB, uC) if on_card else None
        else:
            rec = folded_projection(uB, uC)
    else:
        W, U = layer.W, layer.U
        xside = lambda v: torch.matmul(v, W)  # noqa: E731
        if batch == 1:
            kernel, args = ck.lstm_recurrence, (U,)
            packed = ck.pack_recurrence(U, fast=False) if on_card else None
        else:
            rec = lambda hh: torch.matmul(hh, U)  # noqa: E731
    b = layer.b

    def kernel_step(x, h, c):  # the batch-1 kernel (its plain version for CPU tensors)
        h_seq, c_T = kernel((xside(x) + b)[0].contiguous(), *args, h[0], c[0], return_c=True,
                            packed=packed)
        return h_seq[None], h_seq[-1:], c_T[None]

    def scan_step(x, h, c):
        h_seq, (h, c) = scan_recurrence(xside(x) + b, rec, h, c)
        return h_seq, h, c

    return kernel_step if batch == 1 else scan_step


def make_pipeline_inference(mesh: Mesh, n_stages: int | None = None, ct: int = 512,
                            return_sequences: bool = True) -> Callable:
    """``run(model, X) -> (B, T, 1)`` (``(B, 1)`` without
    ``return_sequences``) on every rank: the dense or reduced model's
    predictions through ``n_stages`` pipeline stages (default: every rank of
    the mesh; ranks past them only receive the result), equal to
    ``stacked_lstm_apply`` / ``reduced_lstm_apply`` up to float32 summation
    order. Every rank passes the same model and X (B, T, d); the model's
    layer count must be divisible by ``n_stages``."""
    S = mesh.world if n_stages is None else n_stages
    if S > mesh.world:
        raise ValueError(f"n_stages {S} exceeds {mesh.world} devices")
    if ct < 1:
        raise ValueError(f"ct {ct}: a chunk needs at least one step")

    @torch.no_grad()
    def run(model, X) -> torch.Tensor:
        if not isinstance(model, (StackedLSTM, ReducedLSTM)):
            raise TypeError(f"pipeline inference takes a dense or reduced model, "
                            f"not {type(model).__name__}")
        lps = _check_stages(model, S)
        x = torch.as_tensor(X, dtype=torch.float32, device=mesh.device)
        B, T, _ = x.shape
        n = model.layers[0].units
        s = mesh.rank
        out = torch.empty((B, T, n), dtype=torch.float32, device=mesh.device)
        with exact_matmul():
            if s < S:
                steps = [_layer_runner(l, B, x.is_cuda) for l in model.layers[s * lps:(s + 1) * lps]]
                h = [torch.zeros((B, n), dtype=torch.float32, device=mesh.device) for _ in steps]
                c = [torch.zeros_like(v) for v in h]
                sends = []
                for t0 in range(0, T, ct):  # chunk t0 // ct: tick t0 // ct + s
                    t1 = min(t0 + ct, T)
                    if s == 0:
                        cur = x[:, t0:t1]
                    else:
                        cur = torch.empty((B, t1 - t0, n), dtype=torch.float32, device=mesh.device)
                        dist.recv(cur, src=s - 1)
                    for j, step in enumerate(steps):
                        cur, h[j], c[j] = step(cur, h[j], c[j])
                    if s < S - 1:
                        sends.append(dist.isend(cur.contiguous(), dst=s + 1))
                    else:
                        out[:, t0:t1] = cur
                for req in sends:
                    req.wait()
            if mesh.world > 1:  # the last stage's hidden sequence to every rank
                keep = out if return_sequences else out[:, -1:].contiguous()
                dist.broadcast(keep, src=S - 1)
                out = keep
            h_last = out if return_sequences else out[:, -1]
            return model.head(h_last)

    return run
