"""Golden-eval harness: reproduce the rows of a reference `val.txt` within a
tolerance, counterpart of the repository's `golden_eval.py`.

    python -m ldt_torch.entries.golden_eval --val_txt val.txt \
        [--config test/val_config.yaml] [--sample_path smp] [--tol 0.01] \
        [--datasets airplane chair] [--norm True] [--device cpu]

reads a `val.txt` in the reference's format (`INFO:root:`-prefixed blocks
`<dataset>:<sample>.npy`, then `[val/gen/<metric>] <value>` lines, the LGAN
metrics `lgan_`-prefixed), replays every block through the port's
`val_sample` (the test loader's re-slice, `compute_CD_metrics` at batch 256,
K5 on the card) from the working directory, and holds each metric within
`--tol` (relative; absolute where the reference value is ~0). Exit code 0:
every metric within tolerance; 1: one or more outside; 2: no block parsed.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

from ldt_torch.entries import val_sample
from ldt_torch.tools.io import dict2namespace, load_yaml

# reference val.txt metric name -> compute_CD_metrics key
KEY_MAP = {
    "lgan_mmd-CD": "mmd-CD",
    "lgan_cov-CD": "cov-CD",
    "lgan_mmd_smp-CD": "mmd_smp-CD",
    "1-NN-CD-acc_t": "1-NN-CD-acc_t",
    "1-NN-CD-acc_f": "1-NN-CD-acc_f",
    "1-NN-CD-acc": "1-NN-CD-acc",
    # this repository's own val.txt rows use the un-prefixed names
    "mmd-CD": "mmd-CD",
    "cov-CD": "cov-CD",
    "mmd_smp-CD": "mmd_smp-CD",
}

_HEADER = re.compile(r"^(?:INFO:root:)?(\w[\w-]*):(.+\.npy)\s*$")
_METRIC = re.compile(
    r"^(?:INFO:root:)?\[val/gen/([\w.-]+)\]\s+([-+0-9.eE]+)\s*$")


def parse_val_txt(path: str):
    """-> list of (dataset, sample_file, {metric_key: value}) blocks; blocks
    with no known metric are left out."""
    blocks = []
    current = None
    with open(path) as f:
        for line in f:
            m = _HEADER.match(line.strip())
            if m:
                current = (m.group(1), m.group(2), {})
                blocks.append(current)
                continue
            m = _METRIC.match(line.strip())
            if m and current is not None:
                name, value = m.group(1), float(m.group(2))
                if name in KEY_MAP:
                    current[2][KEY_MAP[name]] = value
    return [b for b in blocks if b[2]]


def within(val: float, ref: float, tol: float) -> bool:
    """|val - ref| / |ref| <= tol, or |val - ref| < tol where ref ~ 0."""
    if abs(ref) < 1e-8:
        return abs(val - ref) < tol
    return abs(val - ref) / abs(ref) <= tol


def run(args) -> int:
    """Replay and check every block of `args.val_txt`; the exit code."""
    cfg = dict2namespace(load_yaml(args.config))
    blocks = parse_val_txt(args.val_txt)
    if not blocks:
        print(f"no parseable blocks in {args.val_txt}")
        return 2
    if args.datasets:
        blocks = [b for b in blocks if b[0] in args.datasets]

    failures, n_checked = [], 0
    for dataset, sample_file, want in blocks:
        va = dict2namespace(dict(
            sample=sample_file, dataset=dataset,
            sample_path=args.sample_path, norm=args.norm,
            eval_split=getattr(args, "eval_split", "val"),
            device=args.device))
        got = val_sample.main(va, cfg)
        got = {k.replace("val/gen/", ""): v for k, v in got.items()}
        for key, ref_val in want.items():
            n_checked += 1
            val = got.get(key)
            ok = val is not None and within(val, ref_val, args.tol)
            status = "ok " if ok else "FAIL"
            print(f"[{status}] {dataset}/{sample_file} {key}: "
                  f"got {val!r} want {ref_val:.8f} (tol {args.tol:.2%})")
            if not ok:
                failures.append((dataset, key, val, ref_val))
    print(f"\n{n_checked - len(failures)}/{n_checked} metrics within "
          f"{args.tol:.2%} across {len(blocks)} block(s)")
    return 1 if failures else 0


def get_parser():
    p = argparse.ArgumentParser("golden eval vs reference val.txt")
    p.add_argument("--val_txt", required=True,
                   help="reference val.txt to reproduce")
    p.add_argument("--config", default=os.path.join("test", "val_config.yaml"))
    p.add_argument("--sample_path", default="smp",
                   help="subdir under test/ holding <dataset>/<sample>.npy")
    p.add_argument("--datasets", nargs="*", default=None)
    p.add_argument("--tol", type=float, default=0.01)
    p.add_argument("--norm", type=eval, default=False, choices=[True, False])
    p.add_argument("--device", type=str, default="cuda")
    return p


if __name__ == "__main__":
    sys.exit(run(get_parser().parse_args()))
