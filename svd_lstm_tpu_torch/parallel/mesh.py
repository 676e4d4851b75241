"""The (dp, tp) mesh over ``torch.distributed`` ranks, and a launcher.

Counterpart of ``svd_lstm_tpu/parallel/mesh.py``. The JAX package is one
controller that sees every device: ``make_mesh`` lays them out as a
``jax.sharding.Mesh`` of shape (dp, tp), and one call of a sharded function
runs on all of them. PyTorch runs one process a rank (SPMD): every rank
calls the same function on its own part and gets the same result back. So
here ``make_mesh`` runs inside an initialised process group and returns
this rank's view of the mesh: its place in the (dp, tp) grid, the sub-groups
of its row and column, and its device.

The layout is the JAX package's ``devices.reshape(dp, tp)``: rank ``r`` sits
at dp index ``r // tp`` and tp index ``r % tp``; a tp group is one row (the
ranks that split a layer's gate columns), a dp group one column (the ranks
that split the batch).

:func:`launch` starts ``world_size`` ranks with the ``spawn`` start method,
a ``file://`` rendezvous in a temporary directory (never a fixed port, so
several launches may run at once), and returns each rank's result. Backends:
``nccl`` for CUDA tensors, one card a rank; ``gloo`` for the CPU, and for
data parallelism at several ranks on one card (its only collective,
``all_reduce``, takes CUDA tensors under gloo).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)  # a collective that waits longer fails the run


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the (dp, tp) mesh."""

    rank: int
    dp: int
    tp: int
    device: torch.device
    backend: str
    dp_group: Any = None  # the ranks of this tp index (None: the column is this rank alone)
    tp_group: Any = None  # the ranks of this dp index (None: the row is this rank alone)

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device a rank computes on. ``"cpu"`` stays; a CUDA device without
    an index is ``cuda:rank`` under nccl (one card a rank) and ``cuda:0``
    under gloo (every rank on the one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
    return dev


def make_mesh(dp: int | None = None, tp: int = 1, device="cuda") -> Mesh:
    """This rank's (dp, tp) mesh over the initialised default process
    group. Defaults: tp = 1, dp = world size / tp. Every rank must call it,
    in the same order as its other group creations: it creates every row's
    and every column's group (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside an initialised process group (see launch)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // tp
    if dp * tp > world:
        raise ValueError(f"need {dp * tp} devices, have {world}")
    if dp * tp < world:
        raise ValueError(f"a {dp}x{tp} mesh leaves {world - dp * tp} of {world} ranks out; "
                         "every rank of the group must be in the mesh")
    backend = dist.get_backend()
    dp_group = tp_group = None
    for j in range(tp):  # the columns: ranks j, j + tp, ...
        g = dist.new_group(list(range(j, world, tp))) if dp > 1 else None
        if rank % tp == j:
            dp_group = g
    for i in range(dp):  # the rows: ranks i·tp .. i·tp + tp − 1
        g = dist.new_group(list(range(i * tp, (i + 1) * tp))) if tp > 1 else None
        if rank // tp == i:
            tp_group = g
    return Mesh(rank, dp, tp, rank_device(device, rank, backend), backend, dp_group, tp_group)


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0, root: str | None = None):
    """The default process group for the duration of the block, joined
    through a ``file://`` rendezvous in ``root`` (every rank passes the same
    directory; by default a new temporary one, which suits world size 1: a
    one-rank group in this process, as the card's tests and smoke use)."""
    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(tempfile.TemporaryDirectory(prefix="svd_lstm_group_"))
        dist.init_process_group(backend, init_method=f"file://{os.path.join(root, 'rendezvous')}",
                                world_size=world_size, rank=rank, timeout=TIMEOUT)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, device, root: str) -> None:
    """One spawned rank: load its own copy of the arguments, join the group,
    run ``fn(device, *args)``, save its result for the launcher, leave the
    group."""
    args = torch.load(os.path.join(root, "args.pt"), weights_only=False)
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    with process_group(backend, world_size, rank, root):
        torch.save(fn(dev, *args), os.path.join(root, f"result_{rank}.pt"))


def launch(fn: Callable, world_size: int, backend: str, device, *args) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` spawned ranks of one
    process group and return each rank's result, in rank order. ``fn`` is a
    module-level function (it is pickled by name); ``device`` is each rank's
    as :func:`rank_device` resolves it. A rank that raises fails the launch
    (the others are stopped) with its traceback. Results travel through
    ``torch.save``, as the arguments do, so every rank gets a copy of its
    own (``torch.multiprocessing`` would share a tensor's storage between
    the ranks): tensors in a result come back on the CPU."""
    import torch.multiprocessing as mp

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card is available")
    with tempfile.TemporaryDirectory(prefix="svd_lstm_ranks_") as root:
        torch.save(args, os.path.join(root, "args.pt"))
        mp.start_processes(_rank_main, args=(fn, world_size, backend, device, root),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(root, f"result_{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world_size)]
