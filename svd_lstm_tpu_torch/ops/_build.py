"""Build and load the CUDA kernels in ``ops/csrc``.

The sources are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface, which is loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds). The library goes into
``build/kernels/`` at the repository root, under a name keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. A missing ``nvcc`` or a failed build raises; nothing degrades to
another implementation.

Exact mode needs ``expf``/``tanhf`` as written, so ``--use_fast_math`` is
never passed (fast mode rounds only the products' operands, by the bf16
intrinsics, and keeps the same gate arithmetic).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/*.cu and their argument types; each returns a cudaError_t.
_SIGNATURES = {
    # meta, L, x, out, T, d, bf16, stream
    "fused_dense_stack_launch": [_P, _I, _P, _P, _I, _I, _I, _P],
    # meta, L, P, E, x, out, T, d, lanes, home, bf16, stream
    "dense_stack_wave_launch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    # xp, P, ranks (int*), blocks, h0, c0, out, T, n, cluster, warps, home, bf16, stream
    "reduced_recurrence_launch": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # xp, P, h0, c0, out, T, n, units, home, bf16, stream
    "lstm_recurrence_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # n, units, home, bf16, per_sm (int*)
    "lstm_recurrence_per_sm": [_I, _I, _I, _I, _P],
    # meta, L, x, out, T, d, bf16, stream
    "fused_reduced_stack_launch": [_P, _I, _P, _P, _I, _I, _I, _P],
    # meta, L, P, entries, x, out, T, d, cluster, warps, home, bf16, stream
    "reduced_stack_wave_launch": [_P, _I, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # meta, L, x, T, B, d, lanes, stream
    "fused_narrow_train_fwd_launch": [_P, _I, _P, _I, _I, _I, _I, _P],
    # meta, L, x, dh_last, dx, T, B, d, lanes, threads, stream
    "fused_narrow_train_bwd_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # K8: as K7's
    "fused_narrow_train_compact_fwd_launch": [_P, _I, _P, _I, _I, _I, _I, _P],
    "fused_narrow_train_compact_bwd_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # A, shift, dz, out, partial, M, p, G, splits, stream
    "weight_grad_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # xz, Ui, h, c, T, B, stride, n, rows, units, staged, row_groups, stream
    "wide_fwd_chain_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # meta (int64: see csrc wide_gemm_launch), stream
    "wide_gemm_launch": [_P, _P],
    # partial, out, size, splits, stream
    "sum_splits_launch": [_P, _P, _I, _I, _P],
    # z, Ut, c, dh, dz, P, T, B, stride, n, rows, units, staged, row_groups, stream
    "wide_bwd_chain_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # xp, Ut, h, T, B, stride, n, rows, units, bf16, stream
    "batched_lstm_recurrence_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # n, rows, units, bf16, per_sm (int*)
    "batched_lstm_per_sm": [_I, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of svd_lstm_tpu_torch cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvdlstm_kernels_{h.hexdigest()[:16]}.so"


def _failed(cmd: list, code: int, output: str) -> RuntimeError:
    return RuntimeError(f"nvcc failed (exit {code}):\n{' '.join(cmd)}\n{output}")


@functools.cache
def build() -> dict:
    """Compile the sources unless a library of the same hash exists: one
    ``nvcc -c`` per source, all at once, then one link. Returns ``{"path",
    "seconds", "log"}``: the library, the time the build took (0 when it was
    reused) and the compilers' output."""
    lib = _library_path()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        jobs = []
        for src, obj in zip(_sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        done = [(cmd, proc, "".join(proc.communicate())) for cmd, proc in jobs]
        for cmd, proc, output in done:
            if proc.returncode != 0:
                raise _failed(cmd, proc.returncode, output)
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise _failed(cmd, proc.returncode, proc.stdout + proc.stderr)
        log = "".join(output for _, _, output in done) + proc.stdout + proc.stderr
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return {"path": str(lib), "seconds": time.perf_counter() - t0, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry point's
    ``argtypes`` and ``restype`` set."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
