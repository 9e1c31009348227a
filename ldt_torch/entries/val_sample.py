"""Score saved samples against the test split, counterpart of
`val_sample.py`.

    python -m ldt_torch.entries.val_sample --sample smp.npy \
        --dataset airplane [--sample_path smp] [--norm True] [--device cpu]

run from a directory holding `test/<sample_path>/<dataset>/<sample>` (a
[N, P, 3] .npy) and `test/val_config.yaml` (the `data:` section). The
samples are re-sliced into the test loader's batches, optionally both sets
normalized to the unit sphere, scored by `compute_CD_metrics` at batch 256
(K5 on the card), and the results appended to `val.txt`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ldt_torch import resolve_device
from ldt_torch.data import get_data_loaders
from ldt_torch.eval import compute_CD_metrics
from ldt_torch.tools.io import dict2namespace, load_yaml
from ldt_torch.tools.utils import normalize_point_clouds


def main(args, cfg) -> dict:
    """Score the samples; returns {'val/gen/<metric>': value}."""
    device = resolve_device(args.device)
    cfg.data.cates = [args.dataset]
    sample = np.load(os.path.join("test", args.sample_path, args.dataset,
                                  args.sample))
    test_loader = get_data_loaders(cfg.data, args)["test_loader"]
    all_ref, all_smp = [], []
    smp = sample
    for data in test_loader:
        ref_pts = data["te_points"]
        all_smp.append(smp[: ref_pts.shape[0]])
        smp = smp[ref_pts.shape[0]:]
        all_ref.append(ref_pts)
    smp = np.concatenate(all_smp)
    ref = np.concatenate(all_ref)
    if args.norm:
        smp = normalize_point_clouds(smp)
        ref = normalize_point_clouds(ref)
    gen_res = compute_CD_metrics(smp, ref, batch_size=256, device=device)
    all_res = {f"val/gen/{k}": float(v) for k, v in gen_res.items()}
    with open("val.txt", "a") as f:
        f.write(args.dataset + ":" + args.sample + "\n")
        for k, v in all_res.items():
            f.write("[%s] %.8f\n" % (k, v))
    return all_res


def get_parser():
    parser = argparse.ArgumentParser("val samples")
    parser.add_argument("--sample", type=str)
    parser.add_argument("--dataset", type=str)
    parser.add_argument("--sample_path", default="smp", type=str)
    parser.add_argument("--norm", default=False, type=eval,
                        choices=[True, False])
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def get_config():
    return dict2namespace(load_yaml(os.path.join("test", "val_config.yaml")))


if __name__ == "__main__":
    main(get_parser().parse_args(), get_config())
