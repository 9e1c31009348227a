"""Base trainer: the epoch and iteration counters and the learning rate,
counterpart of `ldt_tpu/training/base.py` (no mesh, no CSV logger and no
wall-time counter; `epoch_end` does not save yet: checkpoints are later
work)."""

from __future__ import annotations

from ldt_torch.training.state import make_lr_fn


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
