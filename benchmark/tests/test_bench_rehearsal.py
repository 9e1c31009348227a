"""Tiny CPU rehearsals of every cell through the harness: the result line's
keys, the checks against the reference passing, and the modules loaded."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.tests import tiny

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name, trace, capsys):
    r = tiny.run(name, trace)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[:5] == list(harness.RESULT_KEYS)
    assert list(r)[-1] == "checks"
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in
                                     harness.cell(name)["end_to_end"]}
        assert all(m["value"] > 0 for m in r["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        # on the CPU the device's readers find nothing and say so
        assert set(r["metrics"]) | set(r["silent"]) == \
            {m["name"] for m in harness.cell(name)["per_layer"]}
    harness.report(r)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert set(harness.RESULT_KEYS) <= set(last)
    assert err.strip().splitlines()[-1].startswith("check ")


def test_no_jax_after_a_rehearsal():
    """In a fresh process: every cell's rehearsal loads none of the
    forbidden top-level modules, compared by whole name."""
    script = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "for w in harness.spec()['workloads']:\n"
        "    tiny.run(w['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, found = out.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "ldt_torch" in loaded and "'jax'" not in loaded


def test_reference_loads_no_program():
    script = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import benchmark.reference.models, benchmark.reference.diffusion\n"
        "import benchmark.reference.optim, benchmark.reference.evaluation\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = out.stdout.strip().splitlines()[-1]
    for name in ("ldt_torch", "ldt_tpu", "jax", "flax", "bench",
                 "chip_smoke"):
        assert f"'{name}'" not in loaded


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result (this sandbox has none; on the card the test has nothing to
    show)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    script = (
        "import sys\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "harness.report(tiny.run(harness.spec()['workloads'][0]['name']))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and not out.stdout.strip()
