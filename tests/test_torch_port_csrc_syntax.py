"""A host compiler's syntax check of the port's CUDA sources, which this
machine cannot build (no nvcc): each `ldt_torch/csrc/*.cu`, its kernel
launches (`<<<...>>>`) stripped, through `g++ -fsyntax-only` against the
declarations in `tests/cuda_stubs/`. It catches typos, undeclared names and
template errors in every instantiated kernel and entry point; the device's
own rules (registers, shared memory, inline PTX) show only when nvcc builds
the source on the card.

`host_rules()` builds `csrc/rules.h`, the schedule rules that the CUDA
sources launch by, with the same host compiler into a library that the
CPU tests ask (`tests/test_torch_port_cd_split.py`,
`tests/test_torch_port_bwd_tiles.py`, `tests/test_torch_port_k3_tiles.py`)."""

import ctypes
import functools
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import pytest

from ldt_torch.ops import _build

STUBS = Path(__file__).resolve().parent / "cuda_stubs"
SOURCES = sorted(p.name for p in _build.CSRC.glob("*.cu"))


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    return gxx


@functools.lru_cache(maxsize=None)
def _host_rules_path() -> str:
    out = Path(tempfile.mkdtemp(prefix="ldt_rules_")) / "rules.so"
    res = subprocess.run([_gxx(), "-std=c++17", "-O1", "-shared", "-fPIC",
                          "-x", "c++", str(_build.CSRC / "rules.h"), "-o",
                          str(out)], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    return str(out)


def host_rules() -> ctypes.CDLL:
    """`csrc/rules.h` built by the host compiler: `ldt_cd_schedule`,
    `ldt_cross_bwd_tiled`, `ldt_cross_bwd_tiled_smem_bytes`,
    `ldt_self_bwd_tiled` and `ldt_self_bwd_smem_bytes`, the code the CUDA
    libraries decide and export with."""
    lib = ctypes.CDLL(_host_rules_path())
    i = ctypes.c_int
    lib.ldt_cd_schedule.argtypes = [i] * 5
    lib.ldt_cd_schedule.restype = i
    lib.ldt_cross_bwd_tiled.argtypes = [i] * 5
    lib.ldt_cross_bwd_tiled.restype = i
    lib.ldt_cross_bwd_tiled_smem_bytes.argtypes = [i] * 4
    lib.ldt_cross_bwd_tiled_smem_bytes.restype = ctypes.c_size_t
    lib.ldt_self_bwd_tiled.argtypes = [i] * 3
    lib.ldt_self_bwd_tiled.restype = i
    lib.ldt_self_bwd_smem_bytes.argtypes = [i] * 3
    lib.ldt_self_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def test_every_source_is_checked():
    assert SOURCES == ["attention.cu", "eval.cu"]


@pytest.mark.parametrize("name", SOURCES)
def test_source_passes_a_host_syntax_check(name, tmp_path):
    src = re.sub(r"<<<.*?>>>", "", (_build.CSRC / name).read_text(),
                 flags=re.S)
    out = tmp_path / (Path(name).stem + ".cc")
    out.write_text(src)
    res = subprocess.run([_gxx(), "-std=c++17", "-fsyntax-only", "-I",
                          str(STUBS), "-I", str(_build.CSRC), str(out)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]


def test_the_rules_header_builds_alone_and_exports_its_rules():
    lib = host_rules()
    assert lib.ldt_cd_schedule(64, 2048, 2048, 1, 132) == 2
    assert lib.ldt_cross_bwd_tiled(32, 32, 32, 32, 1) == 1
    assert lib.ldt_self_bwd_tiled(32, 64, 1) == 1
