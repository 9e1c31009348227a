"""The benchmark's run: find a cell's files by name, check the card, set
up, measure a window (or trace a bounded stretch), judge the outputs, and
print the result line.

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<traffic>.json`); the
mix names its runner (`runners/<runner>.py`, class `Runner`) and holds the
runner's parameters and the limits of its comparison. The runner's module
also holds its faults (`faults()`, see `faults.py`) and its parameters at
the CPU tests' tiny size (`TINY`, see `tests/tiny.py`). A per-layer metric
is `metrics/<name>.json`, which names a reader (`readers/<reader>.py`,
function `read`) and its parameters; a reader that needs a count (model
FLOPs, a function's least time) takes it from the module the metric file
names under `count` (`counts/<count>.py`). Adding a cell, a mix, a runner,
a configuration or a metric adds files; no file here changes. A listed
per-layer metric whose reader finds nothing to read is left out of the
result line, named on standard error and under the line's `silent` key.

The traced stretch records the program's spans beside the device activity
(`readers/program_spans.py`), so a reader may credit device or idle time
to the span that launched it; the measured window runs with spans off.

A runner has:
  setup()          build the program's objects from the seed, warm every
                   shape the window uses, run what the check follows;
  unit() -> dict   one unit of work, ended by a synchronize: its counts
                   ({"steps": ...} or {"clouds": ...} or {"pairs": ...});
  end_to_end(window_s, counts) -> {metric: value};
  traced(stretch) -> work   run a bounded stretch, calling
                   stretch.begin() / stretch.end() around it; `work` holds
                   the facts of what it computed (steps, batch, the
                   precision), to which the harness adds the
                   configuration (`work["config"]`);
  release()        free the program's state (after the peak is read);
  check() -> [(name, value, limit)]   the comparison with the reference;
                   `attempted` counts the units (steps, generations, calls)
                   it judged, `failed` in the result the numbers over
                   their limits.
"""

from __future__ import annotations

import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ldt_tpu", "bench",
             "chip_smoke")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell `name` with its configuration, traffic mix and metrics
    loaded: {"name", "chips", "config", "traffic", "end_to_end",
    "per_layer"}."""
    bench = spec()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])

    def reports(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [dict(m, **load_json(ROOT / "metrics" / f"{m['name']}.json"))
                 for m in bench["per_layer"]
                 if reports(m) and m["moves"] in e2e_names]
    return {"name": name, "chips": w["chips"],
            "config": load_json(REPO / cfg["file"]),
            "traffic": load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def runner_module(kind: str):
    return importlib.import_module(f"benchmark.runners.{kind}")


def runner_class(kind: str):
    return runner_module(kind).Runner


def reader(name: str):
    return importlib.import_module(f"benchmark.readers.{name}").read


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a runner is given: the cell's configuration, its traffic mix's
    parameters and limits, the seed and the device."""

    def __init__(self, c: dict, seed: int, device: str):
        self.seed = seed
        self.config, self.params = c["config"], c["traffic"]["params"]
        self.limits = c["traffic"]["limits"]
        self.device = device


def sync(device: str) -> None:
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def window(runner, seconds: float, device: str):
    """Units back to back from the first's start to the last's end; a unit
    starts only when the mean so far says it ends inside `seconds`. Names
    the count of units and the slowest and fastest on standard error."""
    counts: dict = {}
    sync(device)
    start = time.perf_counter()
    ends = []
    while True:
        for k, v in runner.unit().items():
            counts[k] = counts.get(k, 0) + v
        ends.append(time.perf_counter() - start)
        elapsed = ends[-1]
        if elapsed + elapsed / len(ends) > seconds:
            spans = [b - a for a, b in zip([0.0] + ends, ends)]
            print(f"window: {len(ends)} units in {elapsed!r} s; slowest "
                  f"{max(spans)!r} s, fastest {min(spans)!r} s",
                  file=sys.stderr)
            return elapsed, counts


def device_info(device: str) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t0: float | None = None,
        config_over: dict | None = None,
        params_over: dict | None = None, stretch=None) -> dict:
    """One run of cell `name`; returns the result object. The CPU (with
    `config_over` / `params_over` shrinking the cell) is for the tests.
    A traced run traces with `stretch`, by default a new
    `program_spans.Stretch`."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from benchmark.readers import program_spans

    c = cell(name)
    for key, over in (config_over or {}).items():
        c["config"][key] = {**c["config"][key], **over} \
            if isinstance(over, dict) else over
    c["traffic"]["params"].update(params_over or {})
    ctx = Context(c, seed, device)
    runner = runner_class(c["traffic"]["runner"])(ctx)
    runner.setup()
    sync(device)
    setup_s = time.perf_counter() - t0
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    metrics, silent = {}, []
    if trace:
        if stretch is None:
            stretch = program_spans.Stretch(device)
        work = dict(runner.traced(stretch), config=c["config"])
        summary = stretch.summary()
        print(f"trace: window {summary['window_s']!r} s, busy "
              f"{summary['busy_s']!r} s, {summary['launches']} launches, "
              f"{len(summary['kernels'])} device events", file=sys.stderr)
        for m in c["per_layer"]:
            value = reader(m["reader"])(m, summary, work)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                silent.append(m["name"])
                print(f"per-layer metric {m['name']} read nothing: its "
                      f"kernels or spans are off the path or off their "
                      f"names", file=sys.stderr)
        dev = device_info(device)
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    else:
        window_s, counts = window(runner, seconds, device)
        values = runner.end_to_end(window_s, counts)
        values["setup_s"] = setup_s
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        dev = device_info(device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules that the run may not load: {found}")
    runner.release()
    checks = runner.check()
    bad = [n for n, v, lim in checks if not (v <= lim)]
    result = {"correct": not bad, "attempted": runner.attempted,
              "failed": len(bad), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = summary["breakdown"]
        result["silent"] = silent
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def report(result: dict) -> None:
    """The compared numbers on standard error, then the result line."""
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=True))

