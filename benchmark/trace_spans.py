"""How far a cell's traced stretch is covered by the program's spans.

    python benchmark/trace_spans.py --workload <cell> --seed <n>

from the root of a checkout. Runs the cell as `run.py --trace 1` does
(`harness.run`: the span metrics are in its result line) and prints that
result line with, besides:

- `span_coverage`: the share of the stretch's device time launched inside
  a recorded span;
- `span_busy_ms`: the device ms a `per` span (step or call) of the cell's
  span metrics launched inside it, children included, over `per_spans`
  such spans: the sum the cell's device-ms span metrics should come to.
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

SPAN_READERS = ("span_ms", "span_idle")


def run(name: str, seed: int, *, device: str = "cuda", t0=None,
        **kw) -> dict:
    """`harness.run(name, seed, trace=True)` with the coverage keys added
    (the CPU, with `kw`'s overrides, is for the tests)."""
    stretch = program_spans.Stretch(device)
    result = harness.run(name, seed, 0.0, True, device=device, t0=t0,
                         stretch=stretch, **kw)
    summary = stretch.summary()
    kernels = summary["kernels"]
    total = sum(k[2] for k in kernels)
    inside = sum(k[2] for k, i in zip(kernels, summary["kernel_spans"])
                 if i is not None)
    checks = result.pop("checks")  # kept last, as in the result line
    result["span_coverage"] = inside / total if total else None
    pers = [m["per"] for m in harness.cell(name)["per_layer"]
            if m["reader"] in SPAN_READERS]
    count = program_spans.per_count(summary, pers[0]) if pers else 0
    if count:
        ids = program_spans.credited(summary, [pers[0]], children=True)
        result.update(per_spans=count, span_busy_ms=program_spans.
                      device_seconds(summary, ids) * 1e3 / count)
    result["checks"] = checks
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
    harness.report(run(args.workload, args.seed, t0=T0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
