"""A cell's traced stretch with the program's spans recorded.

    python benchmark/trace_spans.py --workload <cell> --seed <n>

from the root of a checkout. Runs the cell as `run.py --trace 1` does
(`harness.run`), with `readers.program_spans.Stretch` in the place of
`readers.trace.Stretch`: `ldt_torch`'s spans (`tools.profiling`) are
recorded beside the device activity, and the idle gaps of the breakdown
are labelled with the span the host was in. Prints the compared numbers on
standard error and one JSON line last: the result line, with besides

- `span_metrics`: the metrics of `span_metrics.json` (per-layer entries
  in `BENCHMARK.json`'s form, read by `readers/span_ms.py` and
  `readers/span_idle.py`) listed for the cell; `span_silent` those that
  read nothing;
- `span_coverage`: the share of the stretch's device time launched inside
  a recorded span;
- `span_busy_ms`: the device ms a `per` span (step or call) launched
  inside it, children included, beside `span_sum_ms`, the sum of the
  cell's device-ms span metrics, and the count `per_spans`.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402
from benchmark.readers import program_spans  # noqa: E402
from benchmark.readers import trace as trace_reader  # noqa: E402

ROOT = Path(__file__).resolve().parent


def span_metrics(name: str) -> list:
    """The span metrics listed for cell `name`, each with its metric file."""
    entries = harness.load_json(ROOT / "span_metrics.json")
    return [dict(m, **harness.load_json(ROOT / "metrics" /
                                        f"{m['name']}.json"))
            for m in entries if name in m["workloads"]]


def run(name: str, seed: int, *, device: str = "cuda", t0=None,
        config_over=None, params_over=None) -> dict:
    """`harness.run(name, seed, trace=True)` with the spans recorded; the
    result with the span keys added (the CPU, with the overrides, is for
    the tests)."""
    made = []

    class Recording(program_spans.Stretch):
        def __init__(self, dev):
            super().__init__(dev)
            made.append(self)

    plain = trace_reader.Stretch
    trace_reader.Stretch = Recording
    try:
        result = harness.run(name, seed, 0.0, True, device=device, t0=t0,
                             config_over=config_over,
                             params_over=params_over)
    finally:
        trace_reader.Stretch = plain
    summary = made[0].summary()
    metrics, silent = {}, []
    per, ms = None, 0.0
    for m in span_metrics(name):
        value = harness.reader(m["reader"])(m, summary, {})
        if value is None:
            silent.append(m["name"])
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        per = m["per"]
        if m["reader"] == "span_ms":
            ms += value
    kernels = summary["kernels"]
    total = sum(k[2] for k in kernels)
    inside = sum(k[2] for k, i in zip(kernels, summary["kernel_spans"])
                 if i is not None)
    result.update(span_metrics=metrics, span_silent=silent,
                  span_coverage=inside / total if total else None,
                  spans=len(summary["spans"]))
    if per is not None:
        count = program_spans.per_count(summary, per)
        ids = program_spans.credited(summary, [per], children=True)
        result.update(per_spans=count, span_sum_ms=ms,
                      span_busy_ms=program_spans.device_seconds(
                          summary, ids) * 1e3 / count)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_spans: needs a CUDA card", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, t0=T0)
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
