"""Measured-best ``predict`` route and training regime, with a persistent
cache.

Counterpart of ``svd_lstm_tpu/bench/autotune.py``.
``predict(impl="auto")`` routes by a table carried over from the JAX
package, which fitted it on a TPU. This module measures the choice on the
device that is present: it times every implementation that is valid for the
model and input (``api.valid_impls``; on the card with CUDA events,
``bench.devtime.device_time_ms``, on the CPU with the host's clock) and
returns the winner, and it remembers winners in a JSON file keyed by the
model family, every leaf's shape, the parameter and input dtypes, the input
shape, the precision and the device (``"cuda:" + the card's name``, or
``"cpu"``); a conv hybrid's family is ``"conv+" + its stack's`` and its
dims start with ``("conv", the conv's leaf shapes)``. Every field but
``device`` is the JAX package's key for the same model. ``predict(impl="auto")`` consults the file (:func:`cached_impl`), so
one ``tune`` run redirects every later ``predict`` of that shape on that
card.

The cache file is ``$XDG_CACHE_HOME/svd_lstm_tpu_torch/autotune.json``
(``~/.cache`` without the variable); delete it to forget every winner.

The training half times one whole train step (forward, backward and the
optimizer, the family's own: the σ-masked Hoyer fine-tune for a singular
model) in each of the JAX package's five training regimes
(``_TRAIN_REGIMES``) and picks the fastest relaxed one as ``TrainConfig``
flags (:func:`autotune_train`); ``tune --train`` and
:func:`tuned_train_flags` store them in the same file, under a key of the
model, the window batch's shape and the device
(:func:`train_cache_key`), and ``fit`` with ``TrainConfig.auto_flags``
looks them up (:func:`cached_train_flags`).
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import time
import weakref
from typing import NamedTuple, Sequence

import torch

from svd_lstm_tpu_torch.io.checkpoint import to_tensor_tree
from svd_lstm_tpu_torch.models.conv import CONV_TYPES, inner_stack
from svd_lstm_tpu_torch.models.lstm import StackedLSTM
from svd_lstm_tpu_torch.models.reduced import ReducedLSTM
from svd_lstm_tpu_torch.models.singular import SingularLSTM

DISK_RECHECK_S = 1.0  # a process sees another's new cache entries after at most this long


class TuneResult(NamedTuple):
    impl: str                      # winning impl for api.predict
    ms: float                      # its measured time
    table: dict                    # impl -> ms for every valid candidate
    failed: dict                   # impl -> error for candidates that raised


def _family(model) -> str:
    if isinstance(model, StackedLSTM):
        return "dense"
    if isinstance(model, SingularLSTM):
        return "singular"
    if isinstance(model, ReducedLSTM):
        return "reduced"
    if isinstance(model, CONV_TYPES):
        return "conv+" + _family(inner_stack(model))
    raise TypeError(f"unknown model params: {type(model)}")


def _leaves(node) -> list:
    if isinstance(node, tuple):
        return [leaf for kid in node for leaf in _leaves(kid)]
    return [node]


def _dims(model) -> list:
    """Per layer (units, every leaf's shape in the JAX package's leaf
    order), then the head's leaf shapes: the units pin the width rules, the
    shapes the input width, per-gate ranks, split or merged and the head. A
    conv hybrid's start with ("conv", the conv's leaf shapes)."""
    tree = to_tensor_tree(model)
    shapes = lambda node: [tuple(int(s) for s in leaf.shape) for leaf in _leaves(node)]  # noqa: E731
    front = []
    if isinstance(model, CONV_TYPES):
        front = [("conv", shapes(tree.conv))]
        tree = getattr(tree, "inner", tree)  # ConvLSTM's tree holds its layers itself
        model = inner_stack(model)
    return front + [(int(l.units), shapes(t)) for l, t in zip(model.layers, tree.layers)] + [
        shapes(tree.head)]


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def device_kind(x: torch.Tensor) -> str:
    """The device key of a winner: "cuda:" + the card's name, or "cpu"."""
    return f"cuda:{torch.cuda.get_device_name(x.device)}" if x.is_cuda else x.device.type


def cache_key(model, x: torch.Tensor, precision: str) -> str:
    """Stable string key: family, per-layer leaf shapes, parameter dtypes,
    input shape and dtype, precision, and the device of ``x`` (the card's
    name: a winner must not outlive the card it was measured on)."""
    return json.dumps(
        {
            "family": _family(model),
            "dims": _dims(model),
            "pdtype": sorted({_dtype(p) for p in model.parameters()}),
            "x": tuple(int(s) for s in x.shape),
            "dtype": _dtype(x),
            "precision": precision,
            "device": device_kind(x),
        },
        sort_keys=True,
    )


def candidates(model, x: torch.Tensor, precision: str = "exact") -> list:
    """The implementations with distinct execution paths for this (model,
    input, precision): ``api.valid_impls``, next to ``predict``'s dispatch,
    so the two cannot drift."""
    from svd_lstm_tpu_torch.api import valid_impls

    return valid_impls(model, x, precision)


# a candidate's refusal of its inputs (the wrappers' shape, limit and dtype
# checks): the candidate is skipped. A kernel that fails to build or launch
# raises anything else, which propagates: no plain version takes its place.
_REFUSALS = (ValueError, TypeError)


def _host_time_ms(fn, repeats: int) -> float:
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def autotune(model, x: torch.Tensor, precision: str = "exact", impls: Sequence[str] | None = None,
             repeats: int = 2) -> TuneResult:
    """Time every valid ``predict`` implementation (or ``impls``) on ``x``'s
    device and pick the fastest: CUDA events for an input on the card, the
    host's clock for a CPU input, the median of ``repeats`` after a warm-up
    call. A candidate that refuses its inputs (``_REFUSALS``) goes into
    ``failed`` and the others are still timed; any other error propagates. Each candidate runs with ``consult_cache=False``, so no
    cached winner redirects ``"auto"`` while it is measured."""
    from svd_lstm_tpu_torch.api import predict
    from svd_lstm_tpu_torch.bench.devtime import device_time_ms

    table, failed = {}, {}
    for impl in impls if impls is not None else candidates(model, x, precision):
        fn = lambda i=impl: predict(model, x, impl=i, precision=precision, consult_cache=False)  # noqa: E731
        try:
            table[impl] = (device_time_ms(fn, repeats=repeats) if x.is_cuda
                           else _host_time_ms(fn, repeats))
        except _REFUSALS as e:
            failed[impl] = f"{type(e).__name__}: {e}"
    if not table:
        raise RuntimeError(f"every candidate failed: {failed}")
    best = min(table, key=table.get)
    return TuneResult(impl=best, ms=table[best], table=table, failed=failed)


# ---------------------------------------------------------------- cache --

_MEM_CACHE: dict = {}   # key -> impl: this process's stores and disk reads
_DISK_MEMO: dict = {}   # path -> [time checked, mtime, contents]
# predict's per-call lookup: model -> [generation, its first and last
# parameter, their data pointers, {(path, x's shape, dtype, device,
# precision): impl or None}]
_FAST: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_GENERATION = [0]       # bumped by every store, disk change and module edit
_HOOKS: list = []       # torch's registration hooks, once installed (_watch_modules)
_PATHS: dict = {}       # ($XDG_CACHE_HOME, $HOME) -> the cache file's path


def default_cache_path() -> str:
    env = (os.environ.get("XDG_CACHE_HOME"), os.environ.get("HOME"))
    path = _PATHS.get(env)
    if path is None:
        base = env[0] or os.path.expanduser("~/.cache")
        path = _PATHS[env] = os.path.join(base, "svd_lstm_tpu_torch", "autotune.json")
    return path


def _load_disk(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_disk(path: str, key: str, impl: str) -> None:
    """Add one entry to the shared file: an exclusive lock across the
    read-modify-write (two processes tuning other models keep each other's
    entries), ``os.replace`` so a reader never sees half a file."""
    import fcntl

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        data = _load_disk(path)
        data[key] = impl
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        _DISK_MEMO[path] = [time.monotonic(), os.path.getmtime(path), data]
    _GENERATION[0] += 1


def _read_disk_cached(path: str) -> dict:
    """The file's contents, read again when its mtime moved; the mtime is
    looked at no more than once each ``DISK_RECHECK_S``."""
    now = time.monotonic()
    hit = _DISK_MEMO.get(path)
    if hit is not None and now - hit[0] < DISK_RECHECK_S:
        return hit[2]
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    if hit is not None and hit[1] == mtime:
        hit[0] = now
        return hit[2]
    data = {} if mtime is None else _load_disk(path)
    if hit is not None:
        _GENERATION[0] += 1  # the file changed: every per-model memo is stale
    _DISK_MEMO[path] = [now, mtime, data]
    return data


def _cached_value(key: str, cache_path: str | None) -> str | None:
    """Read-only lookup (memory, then disk); never measures."""
    if cache_path is None:
        cache_path = default_cache_path()
    val = _MEM_CACHE.get(key)
    if val is None and cache_path:
        val = _read_disk_cached(cache_path).get(key)
        if val is not None:
            _MEM_CACHE[key] = val
    return val


def _bump(*_) -> None:
    _GENERATION[0] += 1


def _watch_modules() -> None:
    """Forget every per-model memo whenever a module anywhere gains or
    replaces a parameter or a submodule (a new shape under an old model):
    torch's global registration hooks, installed at the first lookup."""
    if not _HOOKS:
        from torch.nn.modules import module as nn_module

        _HOOKS.append(nn_module.register_module_parameter_registration_hook(_bump))
        _HOOKS.append(nn_module.register_module_module_registration_hook(_bump))


def cached_impl(model, x: torch.Tensor, precision: str = "exact",
                cache_path: str | None = None) -> str | None:
    """The measured-best impl for this (model, input, precision, device) if
    one was ever stored (``tune``, :func:`tuned_impl`, :func:`store_tuned`),
    else None: the read-only lookup ``predict(impl="auto")`` makes before
    its first launch, on the host inside the call's time. A repeated lookup
    costs a few dict lookups: the full key (every leaf's shape as JSON) is
    built once a model and input shape, and again only after a module
    anywhere gains or replaces a parameter or a submodule, the model's first
    or last parameter moved to other storage (``.to(dtype)`` moves them
    all), a winner was stored, or the file changed. A lone parameter whose
    ``.data`` is swapped for another shape or dtype is not seen."""
    path = default_cache_path() if cache_path is None else cache_path
    if not _HOOKS:
        _watch_modules()
    if path:
        _read_disk_cached(path)  # bumps the generation when the file changed
    memo = _FAST.get(model)
    if (memo is None or memo[0] != _GENERATION[0] or memo[1].data_ptr() != memo[3]
            or memo[2].data_ptr() != memo[4]):
        params = list(model.parameters())
        memo = [_GENERATION[0], params[0], params[-1], params[0].data_ptr(),
                params[-1].data_ptr(), {}]
        _FAST[model] = memo
    table = memo[5]
    small = (path, tuple(x.shape), x.dtype, x.device, precision)
    if small not in table:
        table[small] = _cached_value(cache_key(model, x, precision), path)
    return table[small]


def store_tuned(key: str, value: str, cache_path: str | None = None) -> str:
    """Store a winner in memory and in the file (``cache_path=""``: memory
    only). Returns the path used."""
    if cache_path is None:
        cache_path = default_cache_path()
    _MEM_CACHE[key] = value
    _GENERATION[0] += 1
    if cache_path:
        _store_disk(cache_path, key, value)
    return cache_path


def tuned_impl(model, x: torch.Tensor, precision: str = "exact", cache_path: str | None = None) -> str:
    """The best impl for this (model, input, precision, device): measured
    once (:func:`autotune`), then served from memory and the file
    (``cache_path=""``: memory only)."""
    if cache_path is None:
        cache_path = default_cache_path()
    key = cache_key(model, x, precision)
    impl = _cached_value(key, cache_path)
    if impl is None:
        impl = autotune(model, x, precision=precision).impl
        store_tuned(key, impl, cache_path)
    return impl


def predict_tuned(model, x: torch.Tensor, precision: str = "exact", cache_path: str | None = None):
    """``api.predict`` through the measured-best implementation."""
    from svd_lstm_tpu_torch.api import predict

    return predict(model, x, impl=tuned_impl(model, x, precision, cache_path), precision=precision)


# ------------------------------------------------------------- training --


class TrainTuneResult(NamedTuple):
    matmul_precision: str          # winning TrainConfig.matmul_precision
    recurrence_kernel: bool        # winning TrainConfig.recurrence_kernel
    ms: float                      # its measured whole-step time
    table: dict                    # regime -> ms for every candidate
    failed: dict                   # regime -> why it was not measured, or its error
    compact_gates: bool = False    # winning TrainConfig.compact_gates


# (name, TrainConfig.matmul_precision, recurrence_kernel, compact_gates),
# the JAX package's five. f32_scan is the exact regime, measured for context
# and never the winner: exact training has one implementation. The others
# relax the step's products and compete: the TF32 and bf16 scans, and the
# bf16-operand kernels (K7f, K9f, K6f through the dispatch; K8f where
# compact_gates picks it).
_TRAIN_REGIMES = (
    ("f32_scan", "float32", False, False),
    ("tf32_scan", "tensorfloat32", False, False),
    ("bf16_scan", "bfloat16", False, False),
    ("fused_kernel", "bfloat16", True, False),
    ("fused_kernel_compact", "bfloat16", True, True),
)


def _train_apply_for(model):
    """The family's scan apply, loss extra and optimizer factory, as
    ``fit`` and ``finetune`` train it, so the measured step is the step
    that family runs (a conv hybrid's: its front end, then its stack's)."""
    from svd_lstm_tpu_torch.train.loop import default_apply_fn

    adam = lambda m: torch.optim.Adam(m.parameters(), lr=1e-3)  # noqa: E731
    fam = _family(model)
    if fam.removeprefix("conv+") == "singular":
        from svd_lstm_tpu_torch.config import FactorConfig
        from svd_lstm_tpu_torch.train.finetune import make_finetune_optimizer, regularization_loss

        fcfg = FactorConfig(hoyer=0.01)
        return (default_apply_fn(model), lambda m: regularization_loss(m, fcfg),
                lambda m: make_finetune_optimizer(m, fcfg))
    return default_apply_fn(model), None, adam


def _compact_candidate(model, x) -> bool:
    """Whether the compact regime is a program of its own for this model:
    the dense family (the singular and reduced views keep "auto"), and a
    stack that K8 takes (``compact_eligible`` and ``compact_fits``)."""
    from svd_lstm_tpu_torch.ops.cuda_train import compact_eligible, compact_fits

    d = int(x.shape[-1])
    return (_family(model) == "dense" and compact_eligible(model, d)
            and compact_fits([l.units for l in model.layers], d))


def _train_step(model, apply_fn, loss_extra, make_opt, matmul_precision: str, x, y):
    """One whole train step of ``model`` (updated in place) on (x, y):
    the window-end MSE (+ the loss extra), its backward and the optimizer,
    under ``train_matmul_scope(matmul_precision)``."""
    from svd_lstm_tpu_torch.train.loop import mse_last_step
    from svd_lstm_tpu_torch.utils.precision import train_matmul_scope

    opt = make_opt(model)

    def step():
        with train_matmul_scope(matmul_precision):
            loss = mse_last_step(model, x, y, apply_fn)
            if loss_extra is not None:
                loss = loss + loss_extra(model)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    return step


def autotune_train(model, x: torch.Tensor, y: torch.Tensor, repeats: int = 2,
                   include_exact: bool = True) -> TrainTuneResult:
    """Time one whole train step in every training regime valid for this
    model (``_TRAIN_REGIMES``; ``include_exact=False`` leaves f32_scan out)
    and pick the fastest relaxed one as ``TrainConfig`` flags. ``x`` (B, T,
    d) and ``y`` (B,): a window batch on the model's device; each regime
    trains its own copy of the model. Timed as ``autotune`` times: CUDA
    events on the card, the host's clock on the CPU. The compact regime is
    skipped (recorded in ``failed``) where it would run the same program as
    fused_kernel, and a kernel regime where the family has no kernel path;
    a regime that refuses its inputs (``_REFUSALS``) goes into ``failed``;
    any other error, such as a kernel that fails to build or launch,
    propagates."""
    from svd_lstm_tpu_torch.bench.devtime import device_time_ms
    from svd_lstm_tpu_torch.config import TrainConfig
    from svd_lstm_tpu_torch.train.loop import resolve_train_apply_fn

    base_apply, loss_extra, make_opt = _train_apply_for(model)
    table, failed = {}, {}
    for name, prec, kernel, compact in _TRAIN_REGIMES:
        if name == "f32_scan" and not include_exact:
            continue
        apply_fn = base_apply
        if kernel:
            if compact and not _compact_candidate(model, x):
                failed[name] = "compact layout ineligible for this model"
                continue
            apply_fn, using_kernel = resolve_train_apply_fn(
                TrainConfig(matmul_precision=prec, recurrence_kernel=True, compact_gates=compact),
                base_apply)
            if not using_kernel:
                failed[name] = "no training kernel for this model family"
                continue
        step = _train_step(copy.deepcopy(model), apply_fn, loss_extra, make_opt, prec, x, y)
        try:
            table[name] = (device_time_ms(step, repeats=repeats) if x.is_cuda
                           else _host_time_ms(step, repeats))
        except _REFUSALS as e:
            failed[name] = f"{type(e).__name__}: {e}"
    relaxed = {k: v for k, v in table.items() if k != "f32_scan"}
    if not relaxed:
        raise RuntimeError(f"every relaxed training regime failed: {failed}")
    best = min(relaxed, key=relaxed.get)
    prec, kernel, compact = {n: (p, k, c) for n, p, k, c in _TRAIN_REGIMES}[best]
    return TrainTuneResult(matmul_precision=prec, recurrence_kernel=kernel, ms=relaxed[best],
                           table=table, failed=failed, compact_gates=compact)


def train_cache_key(model, x) -> str:
    """The training regime's key: ``cache_key``'s family and leaf shapes,
    the window batch's shape (``x`` a tensor or a shape) and the device the
    model trains on, with the train marker; the precision is what is tuned,
    so it is not in the key. Every field but ``device`` is the JAX
    package's key for the same model."""
    shape = tuple(int(s) for s in (x.shape if hasattr(x, "shape") else x))
    return json.dumps(
        {
            "train": True,
            "family": _family(model),
            "dims": _dims(model),
            "x": shape,
            "device": device_kind(next(model.parameters())),
        },
        sort_keys=True,
    )


def encode_train_flags(prec: str, kernel: bool, compact: bool) -> str:
    return f"{prec}|{int(kernel)}|{int(compact)}"


def _decode_train_flags(val: str) -> tuple:
    """``prec|kernel[|compact]`` (compact absent: False, as the JAX
    package's older entries)."""
    parts = val.split("|")
    compact = bool(int(parts[2])) if len(parts) > 2 else False
    return parts[0], bool(int(parts[1])), compact


def cached_train_flags(model, x, cache_path: str | None = None) -> tuple | None:
    """The stored ``(matmul_precision, recurrence_kernel, compact_gates)``
    for this model, window batch (a tensor or a shape) and device, or None:
    the read-only lookup of ``TrainConfig.auto_flags``; never measures."""
    val = _cached_value(train_cache_key(model, x), cache_path)
    return None if val is None else _decode_train_flags(val)


def tuned_train_flags(model, x: torch.Tensor, y: torch.Tensor,
                      cache_path: str | None = None) -> tuple:
    """The best ``(matmul_precision, recurrence_kernel, compact_gates)``
    for this model, window batch and device: measured once
    (:func:`autotune_train`, relaxed regimes only), then served from memory
    and the file (``cache_path=""``: memory only). Apply as
    ``dataclasses.replace(cfg, matmul_precision=p, recurrence_kernel=k,
    compact_gates=c)``."""
    if cache_path is None:
        cache_path = default_cache_path()
    key = train_cache_key(model, x)
    val = _cached_value(key, cache_path)
    if val is None:
        r = autotune_train(model, x, y, include_exact=False)
        val = encode_train_flags(r.matmul_precision, r.recurrence_kernel, r.compact_gates)
        store_tuned(key, val, cache_path)
    return _decode_train_flags(val)
