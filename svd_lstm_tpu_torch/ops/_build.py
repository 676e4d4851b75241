"""Build and load the CUDA kernels in ``ops/csrc``.

The sources are compiled at first use with ``nvcc`` into one shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds). The library goes into
``build/kernels/`` at the repository root, under a name keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused. A missing ``nvcc`` or a failed build raises; nothing degrades to
another implementation.

Exact mode needs ``expf``/``tanhf`` as written, so ``--use_fast_math`` is
never passed.
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/*.cu and their argument types; each returns a cudaError_t.
_SIGNATURES = {
    # meta, L, x, out, T, d, stream
    "fused_dense_stack_launch": [_P, _I, _P, _P, _I, _I, _P],
    # xp, Bt, IC, h0, c0, out, T, n, R, stream
    "reduced_recurrence_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # xp, U, h0, c0, out, T, n, stream
    "lstm_recurrence_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvdlstm_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def build() -> dict:
    """Compile the sources unless a library of the same hash exists.
    Returns ``{"path", "seconds", "log"}``: the library, the time the build
    took (0 when it was reused) and the compiler's output."""
    lib = _library_path()
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return {"path": str(lib), "seconds": seconds, "log": proc.stdout + proc.stderr}


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
