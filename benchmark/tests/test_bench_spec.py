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


# A runner of a cell added by files alone: a thin twin of the sample
# runner, with its own tiny size (one Score block fewer) and its own faults.
TWIN_RUNNER = """
from benchmark import faults as f
from benchmark.runners import sample

TINY = dict(sample.TINY, check_rows=1, config={"score": {"num_blocks": 1}})


def faults():
    from ldt_torch.training import latent_sde_trainer as lst

    return {"latents altered": (lst, "sample_latents",
                                lambda: f.scaled(lst.sample_latents, 1.02))}


class Runner(sample.Runner):
    pass
"""

# In the copy: the tiny rehearsals of both new cells untraced and traced,
# the new runner's one fault planted, and its control. The CPU has no
# device kernels, so the traced summaries get a planted kernel, launched
# inside the first `sample.score` span where the stretch recorded one.
NEW_CELLS_SCRIPT = """
import json, sys
sys.path[:0] = [{copy!r}, {repo!r}]
import benchmark
assert benchmark.__file__.startswith({copy!r})
from benchmark import faults, harness
from benchmark.control import readings
from benchmark.readers import program_spans as ps
from benchmark.tests import tiny
plain = ps.Stretch.summary
def planted(self):
    out = plain(self)
    score = [s[1] for s in out['spans'] if s[0] == 'sample.score']
    out['kernels'].append(('pairwise_cd_kernel', 0.0, 1e-3, True))
    out['kernel_spans'].append(score[0] if score else None)
    out['busy_s'] = max(out['busy_s'], 1e-3)
    return out
ps.Stretch.summary = planted
for name in ('airplane_b32.eval_small', 'all55.sample_twin'):
    for trace in (False, True):
        print(json.dumps(tiny.run(name, trace)))
obj, attr, broken = faults.plant('sample_twin', 'latents altered')
sound = getattr(obj, attr)
setattr(obj, attr, broken)
print(json.dumps(tiny.run('all55.sample_twin')))
setattr(obj, attr, sound)
c = tiny.shrink(harness.cell('all55.sample_twin'))
runner, program = readings(c, tiny.SEED, 1, 'cpu')
lim = c['traffic']['limits']
print(json.dumps({{'program': {{n: [v, lim[n]] for n, v in program.items()}},
    'control': {{
    n: [v, lim] for n, v, lim in runner.control('bf16')}},
    'blocks': c['config']['score']['num_blocks']}}))
"""


def test_a_new_cell_is_only_new_files(tmp_path):
    """In a copy: new configurations, traffic mixes, cells, a runner with
    its own tiny size and faults, and per-layer metrics (one with a new
    reader; a roofline of a function no metric counted before, with its
    count module; one on a span the program opens) run with no existing
    file edited: untraced and traced, with the new runner's fault planted
    (not correct) and with its control (not correct)."""
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
    (b / "runners" / "sample_twin.py").write_text(TWIN_RUNNER)
    mix = json.loads((b / "traffic" / "sample_label.json").read_text())
    mix["runner"] = "sample_twin"
    (b / "traffic" / "sample_twin.json").write_text(json.dumps(mix))
    (b / "metrics" / "score_ms.sample_twin.json").write_text(
        json.dumps({"reader": "span_ms", "spans": ["sample.score"],
                    "per": "sample.step"}))
    bench["configs"].append({"name": "airplane_b32", "source": "x",
                             "file": "benchmark/configs/airplane_b32.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "airplane_b32.eval_small",
                               "config": "airplane_b32",
                               "traffic": "eval_small", "chips": 1,
                               "why": "x"})
    bench["workloads"].append({"name": "all55.sample_twin",
                               "config": "all55", "traffic": "sample_twin",
                               "chips": 1, "why": "x"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["eval_pairs_per_s"]["workloads"].append("airplane_b32.eval_small")
    e2e["gen_clouds_per_min"]["workloads"].append("all55.sample_twin")
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
    bench["per_layer"].append({"name": "score_ms.sample_twin", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "models.score / nn.layers",
                               "moves": "gen_clouds_per_min",
                               "workloads": ["all55.sample_twin"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = NEW_CELLS_SCRIPT.format(copy=str(tmp_path), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert len(lines) == 6
    eval_plain, eval_traced, twin_plain, twin_traced, fault, ctl = lines
    assert eval_plain["correct"] and "eval_pairs_per_s" in \
        eval_plain["metrics"]
    assert eval_traced["metrics"]["stretch_ms.eval_small"]["value"] > 0
    # tiny's eval: 6 clouds of 128 points, one call in the stretch
    pairs = 3 * 6 * 6
    least = max(pairs * (2 * 128 * 12 + 4) / 3.35e12,
                pairs * 8 * 128 * 128 / 33.45e12)
    assert eval_traced["metrics"]["cd_roofline.eval_small"]["value"] == \
        pytest.approx(100.0 * least / 1e-3)
    assert twin_plain["correct"] and twin_traced["correct"]
    assert set(twin_plain["metrics"]) == {"gen_clouds_per_min", "setup_s"}
    # the planted kernel's 1 ms over the stretch's sampler steps
    assert set(twin_traced["metrics"]) == {"score_ms.sample_twin"}
    assert twin_traced["silent"] == []
    assert 0 < twin_traced["metrics"]["score_ms.sample_twin"]["value"] <= 1
    assert not fault["correct"], fault["checks"]
    assert ctl["blocks"] == 1
    assert all(v <= lim for v, lim in ctl["program"].values()), ctl
    assert any(not (v <= lim) for v, lim in ctl["control"].values()), ctl
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
