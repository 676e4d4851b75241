"""ctypes bindings for the native C++ streaming runtime (``native/``).

Counterpart of ``svd_lstm_tpu/io/native.py``. The runtime is the LabVIEW
consumer's role rebuilt: it loads the per-gate CSV export, the two-step CSV
export or the int8 ``.bin`` artifact and runs state-carrying batch-1
inference on the host (dense or exact two-step reduced cells), with no
Python, JAX or torch in its loop.

The library is compiled at first use from ``native/svdlstm_runtime.cpp``
with ``native/Makefile``'s flags, into ``build/native/`` at the repository
root (not ``native/``, so the JAX package's ``make -C native`` and this
build never write one file). The compiler writes a temporary file that is
renamed into place, and the library is rebuilt when the source is newer. A
failed build raises: no prebuilt library is loaded in its place.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "svdlstm_runtime.cpp"
LIB_PATH = _REPO / "build" / "native" / "libsvdlstm.so"
# native/Makefile's CXXFLAGS (less its warnings) and its link flag
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-march=native", "-ffast-math", "-shared")


def build_native() -> str:
    """Compile the runtime into ``build/native/libsvdlstm.so`` unless a build
    at least as new as the source is there; returns its path. Raises
    ``RuntimeError`` when the compiler is missing or fails."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return str(LIB_PATH)
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libsvdlstm.", suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, str(SOURCE)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n{detail[-2000:]}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(LIB_PATH)


@functools.cache
def _load_lib():
    lib = ctypes.CDLL(build_native())
    lib.svdlstm_load.restype = ctypes.c_void_p
    lib.svdlstm_load.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.svdlstm_load_int8.restype = ctypes.c_void_p
    lib.svdlstm_load_int8.argtypes = [ctypes.c_char_p]
    lib.svdlstm_load_int8_ex.restype = ctypes.c_void_p
    lib.svdlstm_load_int8_ex.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.svdlstm_step.restype = ctypes.c_float
    lib.svdlstm_step.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.svdlstm_run.restype = None
    lib.svdlstm_run.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
    ]
    lib.svdlstm_reset.restype = None
    lib.svdlstm_reset.argtypes = [ctypes.c_void_p]
    lib.svdlstm_free.restype = None
    lib.svdlstm_free.argtypes = [ctypes.c_void_p]
    lib.svdlstm_input_dim.restype = ctypes.c_int
    lib.svdlstm_input_dim.argtypes = [ctypes.c_void_p]
    lib.svdlstm_layer_info.restype = ctypes.c_int
    lib.svdlstm_layer_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


class NativeModel:
    """Streaming handle over the C++ runtime."""

    def __init__(
        self,
        base_dir: str,
        layer_dirs: Sequence[str],
        # one char per layer: 'd' dense; 'r' / 'm' reduced (split / merged)
        # with the load-time dispatch (a side whose rank cannot pay for the
        # two-step is reconstructed to dense); 'R' / 'M' with the two-step
        # forced
        kinds: str,
        transposed: bool = False,
    ):
        self._lib = _load_lib()
        handle = self._lib.svdlstm_load(
            base_dir.encode(), ":".join(layer_dirs).encode(), kinds.encode(),
            1 if transposed else 0,
        )
        if not handle:
            raise RuntimeError(f"native runtime failed to load model from {base_dir}")
        self._h = handle

    @classmethod
    def from_export_dir(
        cls,
        base_dir: str,
        force_two_step: bool = False,
        transposed: bool | None = None,
    ) -> "NativeModel":
        """Load a weight-export directory, discovering the layers and their
        kinds from the files present: ``lstm_<i>/Wi.csv`` is a dense layer
        ('d', ``save_model_weights_as_csv``), ``wBi.csv`` a split reduced one
        ('r', or 'R' with ``force_two_step``), ``wB.csv`` a merged reduced one
        ('m' / 'M'; both ``save_reduced_weights_as_csv``). ``transposed=None``
        reads a directory with the layout marker untransposed and a bare
        fixture directory transposed, as ``load_model_from_csv`` does."""
        from svd_lstm_tpu_torch.io.csv_weights import _LAYOUT_MARKER, list_layer_dirs

        if not os.path.isdir(base_dir):
            raise RuntimeError(f"no such export directory: {base_dir}")
        if transposed is None:
            transposed = not os.path.exists(os.path.join(base_dir, _LAYOUT_MARKER))
        layer_dirs = list_layer_dirs(base_dir)
        if not layer_dirs:
            raise RuntimeError(f"no lstm_* layer directories under {base_dir}")
        kinds = []
        for d in layer_dirs:
            p = os.path.join(base_dir, d)
            if os.path.exists(os.path.join(p, "Wi.csv")):
                kinds.append("d")
            elif os.path.exists(os.path.join(p, "wBi.csv")):
                kinds.append("R" if force_two_step else "r")
            elif os.path.exists(os.path.join(p, "wB.csv")):
                kinds.append("M" if force_two_step else "m")
            else:
                raise RuntimeError(
                    f"{p}: none of Wi.csv (dense), wBi.csv (split reduced) or "
                    "wB.csv (merged reduced) found: not a weight-export layer directory"
                )
        return cls(base_dir, layer_dirs, "".join(kinds), transposed=transposed)

    @classmethod
    def from_int8(cls, path: str, force_two_step: bool = False) -> "NativeModel":
        """Load the int8 binary artifact (``io/int8_export.py``); the weights
        dequantize on load and the streaming math stays float32. Reduced
        layers get the load-time dispatch unless ``force_two_step``."""
        self = cls.__new__(cls)
        self._lib = _load_lib()
        handle = self._lib.svdlstm_load_int8_ex(path.encode(), 1 if force_two_step else 0)
        if not handle:
            raise RuntimeError(f"native runtime failed to load int8 artifact {path}")
        self._h = handle
        return self

    def layer_info(self, li: int) -> dict:
        """The execution path the load-time dispatch chose for layer ``li``:
        {'w_reduced', 'u_reduced', 'units'}."""
        w = ctypes.c_int()
        u = ctypes.c_int()
        n = ctypes.c_int()
        ok = self._lib.svdlstm_layer_info(
            self._h, li, ctypes.byref(w), ctypes.byref(u), ctypes.byref(n)
        )
        if not ok:
            raise IndexError(f"no layer {li}")
        return {"w_reduced": bool(w.value), "u_reduced": bool(u.value), "units": n.value}

    def reset(self) -> None:
        self._lib.svdlstm_reset(self._h)

    @property
    def input_dim(self) -> int:
        """Frame width the model expects (layer 0's in_dim)."""
        d = getattr(self, "_in_dim", None)  # cached: step() checks it every frame
        if d is None:
            d = self._in_dim = int(self._lib.svdlstm_input_dim(self._h))
        return d

    def step(self, frame: np.ndarray) -> float:
        frame = np.ascontiguousarray(frame, np.float32).reshape(-1)
        # the C side refuses a wrong width with a quiet NaN; raise here instead
        if frame.size != self.input_dim:
            raise ValueError(f"frame has {frame.size} values; model expects {self.input_dim}")
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return float(self._lib.svdlstm_step(self._h, ptr, frame.size))

    def run(self, frames: np.ndarray) -> np.ndarray:
        frames = np.ascontiguousarray(frames, np.float32)
        T, d = frames.shape
        if d != self.input_dim:
            raise ValueError(f"frames have width {d}; model expects {self.input_dim}")
        out = np.empty(T, np.float32)
        self._lib.svdlstm_run(
            self._h,
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            T, d,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.svdlstm_free(h)
            self._h = None


def save_reduced_weights_as_csv(model, savpath: str) -> None:
    """Two-step CSV export of a reduced model (``ReducedLSTM``, any device)
    for the native runtime and other consumers. Split layers write per-gate
    files (wB{i,f,c,o}.csv, wC*.csv, uB*.csv, uC*.csv, b*.csv); merged
    layers one file per factor (wB.csv, wC.csv, uB.csv, uC.csv, b.csv): the
    runtime's 'r' and 'm' kinds. A C with no columns (full rank) is not
    written."""
    from svd_lstm_tpu_torch.io.checkpoint import to_numpy_tree
    from svd_lstm_tpu_torch.io.csv_weights import _LAYOUT_MARKER

    if hasattr(model, "inner"):
        raise NotImplementedError(
            f"{type(model).__name__}: conv hybrids are not ported yet (ROADMAP queue 1, item 7)"
        )
    params = to_numpy_tree(model)
    if type(params).__name__ != "ReducedModelParams":
        raise TypeError(f"two-step CSVs hold a reduced model, not {type(model).__name__}")
    gates = "ifco"
    os.makedirs(savpath, exist_ok=True)
    # the marker of save_model_weights_as_csv, so from_export_dir reads both alike
    with open(os.path.join(savpath, _LAYOUT_MARKER), "w") as f:
        f.write("untransposed (in_dim x units) gate blocks; two-step B/C\n")
    for li, layer in enumerate(params.layers):
        d = os.path.join(savpath, f"lstm_{li}")
        os.makedirs(d, exist_ok=True)
        b = layer.b
        if not isinstance(layer.wB, tuple):
            np.savetxt(os.path.join(d, "wB.csv"), layer.wB, delimiter=",")
            np.savetxt(os.path.join(d, "uB.csv"), layer.uB, delimiter=",")
            if layer.wC.shape[1]:
                np.savetxt(os.path.join(d, "wC.csv"), layer.wC, delimiter=",")
            if layer.uC.shape[1]:
                np.savetxt(os.path.join(d, "uC.csv"), layer.uC, delimiter=",")
            np.savetxt(os.path.join(d, "b.csv"), b, delimiter=",")
            continue
        n = layer.uB[0].shape[0]
        for g, name in enumerate(gates):
            np.savetxt(os.path.join(d, f"wB{name}.csv"), layer.wB[g], delimiter=",")
            np.savetxt(os.path.join(d, f"uB{name}.csv"), layer.uB[g], delimiter=",")
            if layer.wC[g].shape[1]:
                np.savetxt(os.path.join(d, f"wC{name}.csv"), layer.wC[g], delimiter=",")
            if layer.uC[g].shape[1]:
                np.savetxt(os.path.join(d, f"uC{name}.csv"), layer.uC[g], delimiter=",")
            np.savetxt(os.path.join(d, f"b{name}.csv"), b[g * n : (g + 1) * n], delimiter=",")
    dt = os.path.join(savpath, "dense_top")
    os.makedirs(dt, exist_ok=True)
    np.savetxt(os.path.join(dt, "weights.csv"), params.head.w, delimiter=",")
    np.savetxt(os.path.join(dt, "bias.csv"), params.head.b, delimiter=",")
