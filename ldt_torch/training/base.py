"""Base trainer: the epoch and iteration counters, the learning rate, the
wall-time counter, the CSV logging, the checkpoint cadence and the
validation scoring, counterpart of `ldt_tpu/training/base.py` (no mesh).

A trainer whose config's `log:` section names the CSV columns (the
experiments' config.yaml files) writes the logs of `tools.log.logger` under
`log.save_path`, and one whose section sets `save_epoch_freq` saves
(`self.save()`) at the end of every such epoch; the in-memory configs of
`ldt_torch.configs` have no `log:` section and do neither. A subclass sets
`self.device` and implements `save`."""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ldt_torch.eval.metrics import compute_all_metrics
from ldt_torch.tools.log import logger
from ldt_torch.training.state import make_lr_fn


def to_numpy(a) -> np.ndarray:
    """A test batch's array (numpy or a tensor on any device) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class BaseTrainer:
    def __init__(self, cfg):
        self.cfg = cfg
        log = getattr(cfg, "log", None)
        self.logger = logger(cfg) if hasattr(log, "traincolumns") else None
        self.itr = 0
        self.epoch = 1
        # global itr at the current epoch's first update: the gate of the
        # cosine schedule (make_lr_fn)
        self._itr_epoch_start = 0
        self.time = 0.0  # training seconds, carried across resumes
        self.tmp = time.time()
        self.base_lr = cfg.opt.lr  # the divergence watchdog halves it
        self._lr_fn = None
        self._lr_fn_base = None

    def updata_time(self):
        """(sic, the JAX package's name) Add the seconds since the last
        call to `self.time`."""
        now = time.time()
        self.time += now - self.tmp
        self.tmp = now

    def current_lr(self) -> float:
        """Warm-up, then the epoch-gated cosine (`make_lr_fn`); the closure
        is rebuilt only when `base_lr` changes."""
        if self._lr_fn_base != self.base_lr:
            self._lr_fn = make_lr_fn(self.base_lr, self.cfg.opt.warmup_iters,
                                     self.cfg.common.epochs)
            self._lr_fn_base = self.base_lr
        return self._lr_fn(self.itr, self.epoch, self._itr_epoch_start)

    def epoch_end(self):
        freq = getattr(getattr(self.cfg, "log", None), "save_epoch_freq",
                       None)
        if freq and self.epoch % freq == 0:
            self.save()
        self.epoch += 1
        self._itr_epoch_start = self.itr

    def save(self):
        raise NotImplementedError

    def write_log(self, message, mode="train"):
        self.logger.write(message, mode)

    def write_eval(self, epoch, all_res):
        """Append an eval.csv row: the configured `evalcolumns` matched by
        name against the metric dict (the key 'val/gen/mmd-CD' fills the
        column 'mmd-CD'); where the names do not cover the columns, the
        values in the dict's order after the epoch, with a note in the
        log."""
        by_name = {k.rsplit("/", 1)[-1]: v for k, v in all_res.items()}
        cols = self.logger.evalcolumns
        if all(c == "epoch" or c in by_name for c in cols):
            row = [epoch if c == "epoch" else by_name[c] for c in cols]
        else:
            missing = [c for c in cols if c != "epoch" and c not in by_name]
            self.info(f"write_eval: evalcolumns {missing} not in metric "
                      f"names {sorted(by_name)}: writing the values by "
                      "position")
            row = [epoch] + list(all_res.values())
        self.write_log(row, mode="eval")

    def info(self, message):
        if self.logger is not None:
            self.logger.info(message)
        else:
            logging.getLogger("ldt_torch").info(message)

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save_npy(self, name: str, arr: np.ndarray) -> None:
        """Save `arr` as `name` under `cfg.log.save_path`, if the config
        has one."""
        path = getattr(getattr(self.cfg, "log", None), "save_path", None)
        if path:
            np.save(os.path.join(path, name), arr)

    def eval_metrics(self, smp: np.ndarray, ref: np.ndarray,
                     batch_size: int) -> dict:
        """{'val/gen/<metric>': value} of `compute_all_metrics(smp, ref,
        batch_size)` on the trainer's device."""
        gen_res = compute_all_metrics(smp, ref, batch_size=batch_size,
                                      device=self.device)
        print(f"Validation Sample (unit) Epoch:{self.epoch} ", gen_res)
        return {f"val/gen/{k}": float(v) for k, v in gen_res.items()}
