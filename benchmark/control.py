"""The readings the limits of `correct` are set from, for one cell over many
seeds in one process: the program's numbers (a short window: set-up and
`--units` units, then the check) and the control's, the reference in the
next lower precision (the traffic file's `control.precision`) put in the
program's place.

    python benchmark/control.py --workload <cell> --seeds 11 12 ...
        [--units 1] [--out control_<cell>.jsonl]

One JSON line a seed on standard output (and in `--out`). The benchmark's
own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def readings(c: dict, seed: int, units: int, device: str):
    """(runner, its check's numbers) of one short run."""
    import torch

    ctx = harness.Context(c, seed, device)
    runner = harness.runner_class(c["traffic"]["runner"])(ctx)
    runner.setup()
    for _ in range(units):
        runner.unit()
    runner.release()
    out = {n: v for n, v, _ in runner.check()}
    if device != "cpu":
        torch.cuda.empty_cache()
    return runner, out


def fault_readings(c: dict, args) -> int:
    """The check's numbers with a fault planted in the program, a line a
    seed."""
    from benchmark import faults

    obj, attr, broken = faults.plant(c["traffic"]["runner"], args.fault)
    sound = getattr(obj, attr)
    for seed in args.seeds:
        setattr(obj, attr, broken)
        try:
            _, got = readings(c, seed, args.units, args.device)
        finally:
            setattr(obj, attr, sound)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "readings": got}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", help="read this fault of `faults.py`, "
                    "planted in the program, in place of the control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    c = harness.cell(args.workload)
    if args.fault:
        return fault_readings(c, args)
    precision = c["traffic"]["control"]["precision"]
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        runner, program = readings(c, seed, args.units, args.device)
        ctl = {n: v for n, v, _ in runner.control(precision)}
        del runner
        line = {"workload": args.workload, "seed": seed, "program": program,
                "control": ctl, "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    names = list(lines[0]["program"])
    for n in names:
        lo = max(x["program"][n] for x in lines)
        up = min(x["control"][n] for x in lines)
        print(f"{n}: program max {lo!r}, control min {up!r}, "
              f"ratio {up / lo if lo else float('inf'):.3g}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
