"""Base trainer: the epoch and iteration counters, the learning rate and
the validation scoring, counterpart of `ldt_tpu/training/base.py` (no mesh,
no CSV logger and no wall-time counter; `epoch_end` does not save yet:
checkpoints are later work). A subclass sets `self.device`."""

from __future__ import annotations

import os

import numpy as np
import torch

from ldt_torch.eval.metrics import compute_all_metrics
from ldt_torch.training.state import make_lr_fn


def to_numpy(a) -> np.ndarray:
    """A test batch's array (numpy or a tensor on any device) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class BaseTrainer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.itr = 0
        self.epoch = 1
        # global itr at the current epoch's first update: the gate of the
        # cosine schedule (make_lr_fn)
        self._itr_epoch_start = 0
        self.base_lr = cfg.opt.lr
        self._lr_fn = None
        self._lr_fn_base = None

    def current_lr(self) -> float:
        """Warm-up, then the epoch-gated cosine (`make_lr_fn`); the closure
        is rebuilt only when `base_lr` changes."""
        if self._lr_fn_base != self.base_lr:
            self._lr_fn = make_lr_fn(self.base_lr, self.cfg.opt.warmup_iters,
                                     self.cfg.common.epochs)
            self._lr_fn_base = self.base_lr
        return self._lr_fn(self.itr, self.epoch, self._itr_epoch_start)

    def epoch_end(self):
        self.epoch += 1
        self._itr_epoch_start = self.itr

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
