"""The benchmark on the card: every cell's command at a short length, each
result line correct and complete. Marked `cuda`; skips without a card.

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          name, "--seed", "2147483659", "--seconds", "5",
                          "--trace", str(trace)], cwd=REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        # on the card every per-layer metric listed for the cell reads
        # something: a silent one has lost its kernels' names
        assert r["device"]["busy_s"] > 0 and not r["silent"]
        assert set(r["metrics"]) == {m["name"] for m in
                                     harness.cell(name)["per_layer"]}
