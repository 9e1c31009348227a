"""Build the port's CUDA sources into shared libraries and load them.

Each `ldt_torch/csrc/<name>.cu` exposes a plain C interface and is compiled
by `nvcc` for sm_90a into `build/ldt_torch/<name>-<hash>.so` at the root of
the checkout, where the hash covers the source, the headers beside it
(`csrc/*.h`) and the flags, so an edit rebuilds. The library is loaded with
`ctypes`. Nothing is built when a module is imported: the first launch (or
an explicit `build(...)`) builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ldt_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("ldt_torch: nvcc not found (set CUDA_HOME or put "
                       "nvcc on PATH) — the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.h"))]
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in sources)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> str | None:
    """Compile `csrc/<name>.cu` if its library is missing. Returns the
    compiler output, or None when the library was up to date; raises if the
    compile failed."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ldt_torch: nvcc failed for {name} (exit "
                           f"{res.returncode}):\n{res.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return res.stdout


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it first if needed."""
    build(name)
    return ctypes.CDLL(str(library_path(name)))



# the kernel wrappers' launches by shape, by wrapper name (counted where a
# wrapper counts its `.launches`), and the calls that took a wrapper's plain
# twin (a CPU tensor) by shape; kept here, not on the wrappers, so that a
# stand-in for a wrapper leaves them in place
SHAPES: dict = {}
PLAIN_SHAPES: dict = {}


def count_shape(table: dict, name: str, t, heads: int | None = None) -> None:
    """Add one to `table[name]` at the key of `t`'s shape (and the heads),
    as "BxNxD/hH"."""
    key = "x".join(map(str, t.shape)) + (f"/h{heads}" if heads else "")
    row = table.setdefault(name, {})
    row[key] = row.get(key, 0) + 1
