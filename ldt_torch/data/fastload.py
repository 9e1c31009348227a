"""The native bulk .npy loader, counterpart of `ldt_tpu/data/fastload.py`.

`load_npy_batch(paths, shape)` reads and parses every file on a C++ thread
pool (`ldt_torch/csrc/fastload.cc`) into one preallocated float32 block.
The library is built with g++ at first use into `build/ldt_torch/` at the
root of the checkout, its name keyed by a hash of the source and the flags
(as `ops/_build.py` keys the CUDA libraries), and bound with ctypes. A file
the native parser rejects (not '<f4', Fortran order, another shape,
missing) is read again with np.load, with the same result. If the build or
the load of the library fails, `build_failed` turns true, a warning says
why (once), and every file goes through np.load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

from ldt_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "fastload.cc"
FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# True once the library could not be built or loaded (np.load reads then)
build_failed = False


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"fastload-{digest}.so"


def _build() -> str:
    """g++ the library if it is missing; returns its path, raises on a
    failure."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        res = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             timeout=120)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ exited {res.returncode}:\n{res.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent build sees no half file
    return str(out)


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, build_failed
    with _lock:
        if _lib is not None or build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            build_failed = True
            warnings.warn(f"ldt_torch.data.fastload: the native loader could "
                          f"not be built or loaded ({e}); np.load reads "
                          "every file", RuntimeWarning)
            return None
        lib.ldt_load_npy_batch.restype = ctypes.c_int
        lib.ldt_load_npy_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library is built and loaded (building it)."""
    return _get_lib() is not None


def load_npy_batch(paths: Sequence[str], shape: Tuple[int, ...],
                   n_threads: int = 0, strict_shape: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Load `len(paths)` .npy files of `shape` into float32 [N, *shape]:
    (block, ok). A file the native path rejects is read with np.load and
    cast to float32; one np.load cannot read either has ok False (its rows
    unspecified). A readable file of another shape has ok False, or with
    `strict_shape` raises ValueError. `n_threads` 0: one a core."""
    n = len(paths)
    out = np.empty((n,) + tuple(shape), np.float32)
    ok = np.ones((n,), bool)
    if n == 0:
        return out, ok
    lib = _get_lib()
    statuses = np.full((n,), -1, np.int32)
    if lib is not None:
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        # the whole shape, checked dim by dim in the parser: a file of
        # another shape with as many elements is rejected, not scrambled
        c_shape = np.asarray(shape, np.int64)
        lib.ldt_load_npy_batch(
            c_paths, n,
            c_shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(shape), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(n_threads))
    for i in np.nonzero(statuses != 0)[0]:
        try:
            arr = np.load(paths[i])
        except Exception:
            ok[i] = False
            continue
        if arr.shape != tuple(shape):
            if strict_shape:
                raise ValueError(
                    f"{paths[i]}: shape {arr.shape} != expected {shape}")
            ok[i] = False
            continue
        out[i] = arr.astype(np.float32)
    return out, ok
