"""Command-line plumbing of the entries, counterpart of `ldt_tpu/cli.py`:
`python -m ldt_torch.entries.<entry> --dataset airplane --save <dir>` reads
`<dir>/<trainer_type>/<dataset>/config.yaml` (`tools.io.load_yaml`) into
nested namespaces; the completion entries read
`<dir>/<trainer_type>/completion/<dataset>/config.yaml`. One argument more than the JAX parser's: `--device`
(default cuda; the CPU only when asked for)."""

from __future__ import annotations

import argparse
import os

from ldt_torch.tools.io import dict2namespace, load_yaml


def get_parser(trainer_type: str, description: str = "LDT (PyTorch)"):
    parser = argparse.ArgumentParser(description)
    parser.add_argument("--dataset", default="airplane", type=str)
    parser.add_argument("--trainer_type", type=str, default=trainer_type)
    parser.add_argument("--save", type=str, default="experiments")
    parser.add_argument("--resume", type=eval, default=False,
                        choices=[True, False])
    parser.add_argument("--resume_epoch", type=int, default=None)
    parser.add_argument("--load_optimizer", type=eval, default=True,
                        choices=[True, False])
    parser.add_argument("--evaluate", type=eval, default=False,
                        choices=[True, False])
    parser.add_argument("--strict", type=eval, default=True,
                        choices=[True, False])
    parser.add_argument("--finetune", type=eval, default=False,
                        choices=[True, False])
    # the category a multi-category run evaluates: CLI > cfg.common.val_cate
    # > 0
    parser.add_argument("--val_cate", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def get_config(args):
    return dict2namespace(load_yaml(os.path.join(
        args.save, args.trainer_type, args.dataset, "config.yaml")))


def get_completion_config(args):
    """The completion config `<save>/<trainer_type>/completion/<dataset>/
    config.yaml` (`experiments/*/completion/plane`)."""
    return dict2namespace(load_yaml(os.path.join(
        args.save, args.trainer_type, "completion", args.dataset,
        "config.yaml")))


def progress(iterable, desc: str = ""):
    """tqdm when it is installed, else the iterable itself."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, ncols=120)
