"""The benchmark of `ldt_torch` on NVIDIA GPUs.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. Prints the compared numbers beside their
limits on standard error and one JSON result line last on standard output
(`harness.run`). Exits non-zero, with no result, without a CUDA card or
with fewer cards than the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = harness.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t0=T0)
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
