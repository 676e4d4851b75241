"""Sharded training steps (dp × tp) and sharded batched inference.

Counterpart of ``svd_lstm_tpu/parallel/train.py``. Every function here runs
on every rank of a :class:`~svd_lstm_tpu_torch.parallel.mesh.Mesh` (SPMD):
each rank passes the same global batch and the same model, works on its own
part, and gets the same result back.

* **dp**: the window batch is split along its batch axis; rank ``r`` takes
  the rows of its dp index. Each rank's gradients and loss go into one flat
  buffer that is summed over the dp group and divided by its size, so
  every rank applies the same update (the JAX package's ``pmean``).
* **tp**: Megatron-style gate-column sharding of every LSTM layer, the JAX
  package's layout: rank ``s`` of a tp group holds columns ``[s·n/tp,
  (s+1)·n/tp)`` of each of the four gate blocks of ``W``, ``U`` and ``b``,
  and the matching slice of ``h`` and ``c``. Each step all-gathers ``h``
  over tp (the step's one collective). The all-gather is a
  ``torch.autograd.Function`` whose backward is the reduce-scatter: the
  ranks' partial gradients of the gathered ``h`` are summed (an
  ``all_reduce``, as gloo has no reduce-scatter) and each keeps its slice.
  The last layer's gather feeds the head, which every rank holds whole and
  applies alike: its gradient there is already complete on each rank, so
  that backward only takes the slice. The head's gradients are then equal
  on every tp rank, and the true ones (the JAX package's ``pmean`` of them
  over tp changes nothing).
* **pp**: ``parallel/pipeline.py``.

Steps run their products exact (``train_matmul_scope("float32")``), as the
JAX package's run at its global float32 matmul precision.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from svd_lstm_tpu_torch.api import exact_matmul
from svd_lstm_tpu_torch.models.lstm import LSTMLayer, StackedLSTM, gate_update
from svd_lstm_tpu_torch.parallel.mesh import Mesh
from svd_lstm_tpu_torch.utils.precision import train_matmul_scope


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def rows_of(X, index: int, parts: int, device) -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``X``'s batch axis, as a
    float32 tensor on ``device``; an indivisible batch raises."""
    B = X.shape[0]
    if B % parts:
        raise ValueError(f"batch {B} not divisible by {parts} devices")
    k = B // parts
    return torch.as_tensor(X[index * k:(index + 1) * k], dtype=torch.float32, device=device)


def mean_grads(params: list, loss: torch.Tensor, group, size: int) -> torch.Tensor:
    """Each parameter's gradient and the loss, averaged over the ``size``
    ranks of ``group`` through one flat buffer (a sum, then / size): every
    rank ends with the same gradients and returns the same mean loss (a
    0-d tensor), so a NaN on one rank reaches all. A parameter without a
    gradient counts as zeros."""
    if size == 1:
        return loss.detach()
    flat = torch.cat([torch.zeros(p.numel(), dtype=p.dtype, device=p.device) if p.grad is None
                      else p.grad.reshape(-1) for p in params] + [loss.detach().reshape(1)])
    dist.all_reduce(flat, group=group)
    flat /= size
    i = 0
    for p in params:
        g = flat[i:i + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        i += p.numel()
    return flat[-1]


def gather_cat(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in rank
    order."""
    if size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherTp(torch.autograd.Function):
    """The tp all-gather of ``h`` along ``dim``. Backward: the
    reduce-scatter when the consumers on each rank are partial (``partial``:
    the next step's or layer's local gate columns), the slice alone when
    they are replicated (the head)."""

    @staticmethod
    def forward(ctx, h, mesh: Mesh, dim: int, partial: bool):
        ctx.mesh, ctx.dim, ctx.partial = mesh, dim, partial
        return gather_cat(h, mesh.tp_group, mesh.tp, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        if ctx.partial:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=mesh.tp_group)
        k = g.shape[dim] // mesh.tp
        return g.narrow(dim, mesh.tp_index * k, k), None, None, None


def _gather_tp(h: torch.Tensor, mesh: Mesh, dim: int, partial: bool = True) -> torch.Tensor:
    return h if mesh.tp == 1 else _GatherTp.apply(h, mesh, dim, partial)


# ---------------------------------------------------------------------------
# tp layout: per-gate column slices
# ---------------------------------------------------------------------------

def _gate_columns(n: int, tp: int, index: int) -> torch.Tensor:
    """Columns ``[index·n/tp, (index+1)·n/tp)`` of each of the four gate
    blocks, in gate order."""
    if n % tp:
        raise ValueError(f"units {n} not divisible by tp {tp}")
    k = n // tp
    return torch.cat([torch.arange(g * n + index * k, g * n + (index + 1) * k) for g in range(4)])


def shard_layer_tp(layer: LSTMLayer, tp: int, index: int) -> LSTMLayer:
    """tp-shard ``index``'s local slice of a layer (copies): columns
    ``[index·n/tp, (index+1)·n/tp)`` of each gate block; all rows."""
    cols = _gate_columns(layer.units, tp, index).to(layer.W.device)
    return LSTMLayer(layer.W.detach()[:, cols].clone(), layer.U.detach()[:, cols].clone(),
                     layer.b.detach()[cols].clone())


def shard_params_for_mesh(model: StackedLSTM, mesh: Mesh) -> StackedLSTM:
    """This rank's part of a dense model on ``mesh.device`` (a copy): each
    layer's gate-column slice of its tp index, the head whole. At tp = 1 a
    copy of the model."""
    from svd_lstm_tpu_torch.models.lstm import DenseHead

    layers = [shard_layer_tp(l, mesh.tp, mesh.tp_index) for l in model.layers]
    head = DenseHead(model.head.w.detach().clone(), model.head.b.detach().clone())
    return StackedLSTM(layers, head).to(mesh.device)


def unshard_params_from_mesh(model: StackedLSTM, mesh: Mesh) -> StackedLSTM:
    """The inverse of :func:`shard_params_for_mesh` on every rank: the
    tp-local slices gathered over the tp group back into the Keras layout
    (a new model on ``mesh.device``)."""
    from svd_lstm_tpu_torch.models.lstm import DenseHead

    layers = []
    with torch.no_grad():
        for l in model.layers:
            # gathered column p = s·4k + g·k + j holds the layer's column g·n + s·k + j
            W, U, b = (gather_cat(t, mesh.tp_group, mesh.tp, -1) for t in (l.W, l.U, l.b))
            n = U.shape[0]
            perm = torch.cat([_gate_columns(n, mesh.tp, s) for s in range(mesh.tp)])
            inv = torch.argsort(perm).to(W.device)
            layers.append(LSTMLayer(W[:, inv].clone(), U[:, inv].clone(), b[inv].clone()))
        head = DenseHead(model.head.w.detach().clone(), model.head.b.detach().clone())
    return StackedLSTM(layers, head).to(mesh.device)


def _local_layer_apply(layer: LSTMLayer, x_seq: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """One layer whose W, U, b and h, c are this rank's tp-local gate
    slices. x_seq (B, T, d), the same on every tp rank -> the local h
    slice (B, T, n/tp). Each step gathers h over tp for the product with U
    (U keeps all n rows)."""
    B, T, _ = x_seq.shape
    k = layer.W.shape[1] // 4
    xp = torch.matmul(x_seq, layer.W) + layer.b
    h = torch.zeros((B, k), dtype=x_seq.dtype, device=x_seq.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(T):
        h, c = gate_update(xp[:, t] + torch.matmul(_gather_tp(h, mesh, 1), layer.U), c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _forward_local(model: StackedLSTM, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The window-end prediction through tp-local layer slices: each layer's
    output gathered over tp for the next, the head (whole on every rank) on
    the gathered last hidden state."""
    h = x
    for i, layer in enumerate(model.layers):
        h = _gather_tp(_local_layer_apply(layer, h, mesh), mesh, 2,
                       partial=i < len(model.layers) - 1)
    return model.head(h[:, -1])


# ---------------------------------------------------------------------------
# sharded train steps
# ---------------------------------------------------------------------------

def _optimizer_params(optimizer: torch.optim.Optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def make_sharded_train_step(mesh: Mesh, optimizer: torch.optim.Optimizer) -> Callable:
    """``step(model, x, y) -> loss``: one dp × tp step of the window-end MSE
    on this rank's part, ``model`` the rank's :func:`shard_params_for_mesh`
    and ``optimizer`` built over its parameters. ``x`` (B, T, d) and ``y``
    (B,) are the global batch, B divisible by dp; the rank takes its dp
    rows. Gradients and the loss are averaged over dp; the update is in
    place. Returns the global batch's loss, the same on every rank."""
    params = _optimizer_params(optimizer)

    def step(model: StackedLSTM, x, y) -> float:
        xl = rows_of(x, mesh.dp_index, mesh.dp, mesh.device)
        yl = rows_of(y, mesh.dp_index, mesh.dp, mesh.device)
        with train_matmul_scope("float32"):
            pred = _forward_local(model, xl, mesh)[..., 0]
            loss = torch.mean(torch.square(pred - yl))
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        value = mean_grads(params, loss, mesh.dp_group, mesh.dp)
        optimizer.step()
        return float(value)

    return step


def make_dp_train_step(mesh: Mesh, optimizer: torch.optim.Optimizer, apply_fn: Callable,
                       loss_extra: Callable | None = None) -> Callable:
    """Data-parallel ``step(model, x, y) -> loss`` for any model family
    (dense, singular, reduced, the conv hybrids): the model and the
    optimizer (built over its parameters) whole on every rank, the global
    batch split over every rank of the mesh, gradients and the loss
    averaged. ``loss_extra(model) -> scalar`` adds the fine-tune's
    regularizers (the same on every rank). The update is in place."""
    params = _optimizer_params(optimizer)

    def step(model, x, y) -> float:
        xl = rows_of(x, mesh.rank, mesh.world, mesh.device)
        yl = rows_of(y, mesh.rank, mesh.world, mesh.device)
        with train_matmul_scope("float32"):
            pred = apply_fn(model, xl, return_sequences=False)[..., 0]
            loss = torch.mean(torch.square(pred - yl))
            if loss_extra is not None:
                loss = loss + loss_extra(model)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        value = mean_grads(params, loss, None, mesh.world)
        optimizer.step()
        return float(value)

    return step


def make_dp_finetune_step(mesh: Mesh, smodel, factor_cfg=None, learning_rate: float = 1e-3):
    """The dp singular fine-tune step: Adam over σ and the head (and the
    factors with ``train_uv``), the Hoyer and orthogonality penalties in the
    loss; the sharded form of ``train.finetune.finetune``'s step. Returns
    ``(step, optimizer)``, the optimizer over ``smodel``'s parameters (the
    model the step then trains in place)."""
    from svd_lstm_tpu_torch.config import FactorConfig
    from svd_lstm_tpu_torch.models.conv import ConvSingularLSTM, conv_singular_apply
    from svd_lstm_tpu_torch.models.singular import singular_lstm_apply
    from svd_lstm_tpu_torch.train.finetune import make_finetune_optimizer, regularization_loss

    if factor_cfg is None:
        factor_cfg = FactorConfig()
    apply_fn = conv_singular_apply if isinstance(smodel, ConvSingularLSTM) else singular_lstm_apply
    optimizer = make_finetune_optimizer(smodel, factor_cfg, learning_rate)
    step = make_dp_train_step(mesh, optimizer, apply_fn,
                              loss_extra=lambda m: regularization_loss(m, factor_cfg))
    return step, optimizer


# ---------------------------------------------------------------------------
# batched multi-sequence inference
# ---------------------------------------------------------------------------

def make_batched_inference(mesh: Mesh, apply_fn: Callable) -> Callable:
    """``run(model, X) -> (B, T, out)``: a batch of independent sequences
    split over every rank of the mesh, each rank's part through
    ``apply_fn`` (exact), the parts gathered to every rank. B divisible by
    the world size."""

    @torch.no_grad()
    def run(model, X) -> torch.Tensor:
        xl = rows_of(X, mesh.rank, mesh.world, mesh.device)
        with exact_matmul():
            out = apply_fn(model, xl, return_sequences=True)
        return gather_cat(out, None, mesh.world, 0)

    return run


def make_batched_fast_inference(mesh: Mesh) -> Callable:
    """``run(model, X) -> (B, T, out)``: the fast-precision batched forward
    of a dense model (``ops/cuda_batched.batched_forward_fast``: K5 on the
    card) on each rank's part of the batch; no collective until the parts
    are gathered to every rank. B divisible by the world size."""
    from svd_lstm_tpu_torch.ops.cuda_batched import batched_forward_fast

    def run(model, X) -> torch.Tensor:
        return gather_cat(batched_forward_fast(model, rows_of(X, mesh.rank, mesh.world, mesh.device)),
                          None, mesh.world, 0)

    return run
