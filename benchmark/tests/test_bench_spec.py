"""The benchmark's files: BENCHMARK.json keeps to its contract, every cell,
configuration, traffic mix and metric loads by name, and a new cell with
its own mix and metric is added by adding files and entries alone."""

import hashlib
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank")), k
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"train_step_ms", "gen_clouds_per_min",
                        "eval_pairs_per_s", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for w in m["workloads"]:  # each listed cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", CELLS)
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    c = harness.cell(name)
    assert harness.runner_class(c["traffic"]["runner"])
    assert {"params", "limits", "control"} <= set(c["traffic"])
    assert c["per_layer"], name
    for m in c["per_layer"]:
        assert callable(harness.reader(m["reader"]))
        if m["reader"] in ("mfu", "roofline"):
            module = importlib.import_module(f"benchmark.counts.{m['count']}")
            assert callable(module.count)
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_only_new_files(tmp_path):
    """In a copy: a new configuration, traffic mix, cell and per-layer
    metrics (one with a new reader; a roofline of a function no metric
    counted before, with its count module) run with no existing file
    edited. The CPU has no device kernels, so the roofline reads a kernel
    planted in the traced stretch's summary."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "airplane.json").read_text())
    cfg["data"]["test_batch_size"] = 32
    (b / "configs" / "airplane_b32.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "eval.json").read_text())
    mix["params"]["clouds"] = 32
    (b / "traffic" / "eval_small.json").write_text(json.dumps(mix))
    (b / "readers" / "window_ms.py").write_text(
        "def read(metric, summary, work):\n"
        "    return summary['window_s'] * 1e3\n")
    (b / "metrics" / "stretch_ms.eval_small.json").write_text(
        json.dumps({"reader": "window_ms"}))
    # K5's function: each pair's two clouds read once, one distance
    # written, 8 N M instructions at 128 lanes an SM a clock
    (b / "counts" / "chamfer_eval.py").write_text(
        "from benchmark.counts.base import least_seconds\n"
        "def count(work):\n"
        "    n, p = work['clouds'], work['points']\n"
        "    pairs = 3 * n * n\n"
        "    return work['calls'] * max(pairs * (2 * p * 12 + 4) / 3.35e12,\n"
        "                               pairs * 8 * p * p / 33.45e12)\n")
    (b / "metrics" / "cd_roofline.eval_small.json").write_text(
        json.dumps({"reader": "roofline", "count": "chamfer_eval",
                    "kernels": ["pairwise_cd"]}))
    bench["configs"].append({"name": "airplane_b32", "source": "x",
                             "file": "benchmark/configs/airplane_b32.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "airplane_b32.eval_small",
                               "config": "airplane_b32",
                               "traffic": "eval_small", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][2]["workloads"].append("airplane_b32.eval_small")
    bench["per_layer"].append({"name": "stretch_ms.eval_small", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "eval_pairs_per_s",
                               "workloads": ["airplane_b32.eval_small"]})
    bench["per_layer"].append({"name": "cd_roofline.eval_small", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "csrc (kernels)",
                               "moves": "eval_pairs_per_s",
                               "workloads": ["airplane_b32.eval_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]\n"
        "import benchmark\n"
        f"assert benchmark.__file__.startswith({str(tmp_path)!r})\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.readers import trace as tr\n"
        "plain = tr.Stretch.summary\n"
        "def planted(self):\n"
        "    out = plain(self)\n"
        "    out['kernels'].append(('pairwise_cd_kernel', 0.0, 1e-3, True))\n"
        "    return out\n"
        "tr.Stretch.summary = planted\n"
        "for trace in (False, True):\n"
        "    r = tiny.run('airplane_b32.eval_small', trace)\n"
        "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert lines[0]["correct"] and "eval_pairs_per_s" in lines[0]["metrics"]
    assert lines[1]["metrics"]["stretch_ms.eval_small"]["value"] > 0
    # tiny's eval: 6 clouds of 128 points, one call in the stretch
    pairs = 3 * 6 * 6
    least = max(pairs * (2 * 128 * 12 + 4) / 3.35e12,
                pairs * 8 * 128 * 128 / 33.45e12)
    assert lines[1]["metrics"]["cd_roofline.eval_small"]["value"] == \
        pytest.approx(100.0 * least / 1e-3)
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
