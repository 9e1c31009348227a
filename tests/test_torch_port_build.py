"""The kernel build (`ldt_torch/ops/_build.py`) with a stand-in compiler:
library names follow the source, a library is compiled once per source
version, a failed compile raises and leaves nothing behind. The real nvcc
runs only on the card (`chip_smoke.py`, tests/test_torch_port_cuda.py)."""

import os
import stat

import pytest
import torch

from ldt_torch.ops import _build
from ldt_torch.ops import attention as ops

# Writes the file named after -o, or fails when the source says FAIL.
FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift
done
if grep -q FAIL "$src"; then echo "error: broken source"; exit 1; fi
echo "ptxas info: Used 32 registers"; echo built > "$out"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc, build


def test_library_name_follows_the_source(fake_tree):
    csrc, _ = fake_tree
    (csrc / "a.cu").write_text("int x;")
    first = _build.library_path("a")
    (csrc / "a.cu").write_text("int y;")
    assert _build.library_path("a") != first
    assert first.name.startswith("a-") and first.suffix == ".so"


def test_build_compiles_missing_libraries_once(fake_tree):
    csrc, build = fake_tree
    (csrc / "a.cu").write_text("// a")
    log = _build.build("a")
    assert "registers" in log
    assert _build.library_path("a").read_text() == "built\n"
    assert _build.build("a") is None  # up to date: nothing compiled
    (csrc / "a.cu").write_text("// a, edited")
    assert "registers" in _build.build("a")  # an edit rebuilds
    assert _build.library_path("a").read_text() == "built\n"
    assert len(os.listdir(build)) == 2  # one library per source version


def test_failed_compile_raises_and_leaves_nothing(fake_tree):
    csrc, build = fake_tree
    (csrc / "bad.cu").write_text("FAIL")
    with pytest.raises(RuntimeError, match="broken source"):
        _build.build("bad")
    assert not _build.library_path("bad").exists()
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]


def test_kernel_sources_are_plain_c_interfaces():
    """The sources bind through ctypes: no PyTorch headers to compile."""
    src = (_build.CSRC / "attention.cu").read_text()
    assert "torch/extension.h" not in src and 'extern "C"' in src
    for fn in ("ldt_packed_self_attention", "ldt_cross_attention",
               "ldt_error_string"):
        assert fn in src


def test_eval_kernel_source_is_a_plain_c_interface():
    """csrc/eval.cu (K5, K6/K7) binds through ctypes too, its distances
    rounded op by op (no FMA contraction) and its exponentials accurate."""
    src = (_build.CSRC / "eval.cu").read_text()
    assert "torch/extension.h" not in src and 'extern "C"' in src
    for fn in ("ldt_pairwise_cd_means", "ldt_approx_match_cost",
               "ldt_eval_error_string", "__fmul_rn", "expf("):
        assert fn in src
    assert "__expf" not in src.replace("not __expf", "")
    assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("fn,args", [
    (ops.packed_self_attention, (torch.zeros(1, 4, 24, device="meta"), 2)),
    (ops.cross_attention, tuple(torch.zeros(1, 4, 8, device="meta")
                                for _ in range(3)) + (2,)),
])
def test_no_fallback_for_other_devices(fn, args):
    """Only CPU tensors take the plain twin; any other device is refused
    (CUDA tensors launch the kernel or raise)."""
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args)
