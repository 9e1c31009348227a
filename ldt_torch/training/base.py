"""Base trainer: the epoch and iteration counters, the learning rate, the
wall-time counter, the CSV logging, the checkpoint cadence, the validation
scoring and the mesh, counterpart of `ldt_tpu/training/base.py`.

In a multi-process run (a process group, `parallel.tp.
initialize_distributed`) the trainer builds the mesh as the JAX trainer
does: `common.model_parallel` m > 1 gives the `data x model` mesh
(`parallel.tp.make_mesh`), else the 1-D data mesh; it registers it for the
eval's pair tiles, the sequence-parallel decode and the tensor-parallel
attention, and only rank 0 logs and writes files. Every rank takes the
global batch and draws every random number at the global shape from the
same generator, then keeps its rows (`local`, `rows`), so a run's draws do
not depend on the world size; `sync_grads` sums the gradients
(`parallel.comm`), and `stats_scope` gives the train-mode BatchNorms the
global batch's statistics.

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

from ldt_torch.eval.metrics import compute_all_metrics, set_eval_mesh
from ldt_torch.parallel import comm
from ldt_torch.parallel.mesh import batch_rows, data_mesh, shard_batch
from ldt_torch.parallel.sp import set_sp_mesh
from ldt_torch.parallel.tp import (
    axis_group,
    axis_size,
    make_mesh,
    set_tp_mesh,
)
from ldt_torch.tools.log import logger
from ldt_torch.training.state import make_lr_fn


def to_numpy(a) -> np.ndarray:
    """A test batch's array (numpy or a tensor on any device) as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def build_mesh(cfg):
    """The mesh of a multi-process run (None in a single process):
    `common.model_parallel` m > 1 (the JAX package's `getattr(..., 1)`)
    gives the `data x model` mesh, else the 1-D data mesh."""
    if comm.world_size() == 1:
        return None
    mp = int(getattr(cfg.common, "model_parallel", 1) or 1)
    return make_mesh(mp) if mp > 1 else data_mesh()


def register_mesh(mesh) -> None:
    """Register `mesh` (or clear, with None) for the eval's pair tiles, the
    sequence-parallel decode and the tensor-parallel attention."""
    set_eval_mesh(mesh)
    set_sp_mesh(mesh)
    set_tp_mesh(mesh)


class BaseTrainer:
    def __init__(self, cfg, mesh=None):
        self.cfg = cfg
        self.mesh = build_mesh(cfg) if mesh is None else mesh
        if self.mesh is not None:
            register_mesh(self.mesh)
        self.is_main = comm.rank() == 0
        log = getattr(cfg, "log", None)
        self.logger = (logger(cfg) if hasattr(log, "traincolumns")
                       and self.is_main else None)
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

    # --- the mesh -----------------------------------------------------

    def data_size(self) -> int:
        return axis_size(self.mesh, "data")

    def rows(self, batch: int):
        """(start, stop) of this rank's rows of a global batch."""
        return batch_rows(self.mesh, batch)

    def local(self, tree):
        """This rank's rows of every array in `tree` (`mesh.shard_batch`)."""
        return shard_batch(self.mesh, tree)

    def sync_grads(self, params: dict, sharded=()) -> None:
        """Sum the gradients of `params` over the ranks that hold them and
        average over the world (`parallel.comm.sync_grads`); a no-op in a
        single process."""
        comm.sync_grads(params, sharded, self.mesh)

    def stats_scope(self):
        """The scope of a training forward: train-mode BatchNorms take the
        global batch's statistics (over `data`)."""
        return comm.batch_stats_over(axis_group(self.mesh, "data"))

    def decode_draws(self, compressor, batch: int, dtype):
        """(noise per decode step, seed-set draw) of one Compressor forward
        on a global batch of `batch` clouds, drawn from the generator in the
        order the forward draws them, then cut to this rank's rows."""
        cfg = compressor.cfg
        seed = compressor.init_set.draw(batch, cfg.outsize, self.generator)
        noise = [torch.randn((batch, cfg.z_scales, cfg.z_dim), dtype=dtype,
                             device=self.device, generator=self.generator)
                 for _ in range(cfg.n_layers)]
        return self.local(noise), self.local(seed)

    def global_mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean over `data` of a per-rank mean (the global batch's)."""
        d = self.data_size()
        if d == 1:
            return value
        return comm.all_reduce(value.detach().clone(),
                               axis_group(self.mesh, "data")) / d

    def global_max(self, value: torch.Tensor) -> torch.Tensor:
        """The maximum over `data` of a per-rank maximum."""
        if self.data_size() == 1:
            return value
        return comm.all_reduce(value.detach().clone(),
                               axis_group(self.mesh, "data"), op="max")

    def write_log(self, message, mode="train"):
        if self.logger is not None:
            self.logger.write(message, mode)

    def write_eval(self, epoch, all_res):
        """Append an eval.csv row: the configured `evalcolumns` matched by
        name against the metric dict (the key 'val/gen/mmd-CD' fills the
        column 'mmd-CD'); where the names do not cover the columns, the
        values in the dict's order after the epoch, with a note in the
        log."""
        if self.logger is None:
            return
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
        elif self.is_main:
            logging.getLogger("ldt_torch").info(message)

    def synchronize(self) -> None:
        """Wait for the device's queued work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save_npy(self, name: str, arr: np.ndarray) -> None:
        """Save `arr` as `name` under `cfg.log.save_path`, if the config
        has one."""
        path = getattr(getattr(self.cfg, "log", None), "save_path", None)
        if path and self.is_main:
            np.save(os.path.join(path, name), arr)

    def vis_dir(self) -> str:
        """`<cfg.log.save_path>/vis`, where `valsample(vis=True)` renders;
        raises without a save path."""
        path = getattr(getattr(self.cfg, "log", None), "save_path", None)
        if not path:
            raise ValueError("valsample(vis=True) renders under "
                             "log.save_path/vis: the config has no save_path")
        return os.path.join(path, "vis")

    def eval_metrics(self, smp: np.ndarray, ref: np.ndarray,
                     batch_size: int) -> dict:
        """{'val/gen/<metric>': value} of `compute_all_metrics(smp, ref,
        batch_size)` on the trainer's device."""
        gen_res = compute_all_metrics(smp, ref, batch_size=batch_size,
                                      device=self.device)
        if self.is_main:
            print(f"Validation Sample (unit) Epoch:{self.epoch} ", gen_res)
        return {f"val/gen/{k}": float(v) for k, v in gen_res.items()}
