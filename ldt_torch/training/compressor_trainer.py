"""Stage-1 trainer: the set-VAE Compressor, counterpart of
`ldt_tpu/training/compressor_trainer.py`.

One `update(batch)`:
  1. the Compressor's forward in train mode on the [B, N, 3] clouds: the
     grouping's and the position embedding's BatchNorms on the batch's
     statistics, K2 in every attention, the reparameterization draws from
     the trainer's generator unless pinned (`noise`, in decode order);
  2. loss = kl_weight * mean(cat(kls)) + CD + EMD of the decoded set against
     the clouds (l1 chamfer, auction EMD), in f32;
  3. backward: K4 in every attention;
  4. clip by global norm and Adam (`training.state`); no EMA (the JAX
     trainer keeps none, and the stage-1 config's ema_decay is 0); the
     BatchNorms' running statistics take the forward's update.
With several categories (`data.num_categorys` > 1) each batch's
`cate_idx` is the label of a class-conditional Compressor, through the
forward of `update` and `encode`.
`valsample` (decode the prior; no label, as the JAX trainer) and
`reconstruction` (encode-decode the test split, denormalized; with several
categories the clouds of `val_cate` with their labels) score with
`eval.metrics.compute_all_metrics` (K5 and K6 on the card). `save` writes
`checkpt_<epoch>.pt` under `cfg.log.save_path` ({"state": the TrainState's
tree}, `training.checkpoint`) and `resume` restores one, or the JAX
package's `.msgpack`, into the live parameters. `valsample(vis=True)`
(the renderer is not ported) raises.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ldt_torch import resolve_device
from ldt_torch.eval.loss import CD_loss, EMD_loss
from ldt_torch.models import Compressor
from ldt_torch.tools.utils import train_dtype
from ldt_torch.training.base import BaseTrainer, to_numpy
from ldt_torch.training.checkpoint import (
    checkpoint_file,
    checkpoint_path,
    load_checkpoint,
    resolve_checkpoint_epoch,
    restore_into,
    save_checkpoint,
)
from ldt_torch.training.state import TrainState, apply_update, make_optimizer


def compressor_objective(model: Compressor, pts: torch.Tensor,
                         kl_weight: float,
                         noise: Optional[Sequence[torch.Tensor]] = None,
                         rec_fn: Optional[Callable] = None,
                         generator: Optional[torch.Generator] = None,
                         label: Optional[torch.Tensor] = None):
    """(loss, (kl, rec, max, batch_stats)): loss = kl_weight * kl + rec,
    kl = mean(cat(kls)), rec = CD + EMD of the decoded set against `pts`
    (or `rec_fn(set, pts)`), from the forward in train mode (conditioned on
    `label`, category indices [B], if given); batch_stats are its
    BatchNorms' updated running statistics."""
    out = model(pts, noise=noise, generator=generator, train=True,
                label=label)
    kl_loss = torch.mean(torch.cat(out["kls"], dim=1))
    if rec_fn is None:
        rec_loss = CD_loss(out["set"], pts) + EMD_loss(out["set"], pts)
    else:
        rec_loss = rec_fn(out["set"], pts)
    loss = kl_weight * kl_loss + rec_loss
    return loss, (kl_loss, rec_loss, out["max"], out["batch_stats"])


def _not_ported(what: str, why: str):
    raise NotImplementedError(f"Trainer.{what} is not ported yet: {why}")


class Trainer(BaseTrainer):
    """Stage-1 trainer. `cfg` has the sections of
    `configs.compressor_trainer_cfg()`: model, opt, common, data. Runs on
    `device` ("cuda" unless the CPU is asked for); `generator` (default:
    seeded with `cfg.common.seed` on the device) draws the random weights
    and every unpinned draw; `dtype` (default:
    `tools.utils.train_dtype(cfg)`) is the Compressor's compute dtype, its
    parameters, moments and gradients f32 whatever it is (the Adam moments
    stored in `opt.moment_dtype`)."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cfg)
        self.device = resolve_device(device)
        self.dtype = train_dtype(cfg) if dtype is None else dtype
        self.generator = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(cfg.common.seed)
        self.kl_weight = cfg.opt.kl_weight
        self.tx = make_optimizer(cfg.opt.beta1, cfg.opt.beta2,
                                 cfg.opt.weight_decay,
                                 cfg.opt.grad_norm_clip_value,
                                 getattr(cfg.opt, "moment_dtype", "float32"))
        self.model: Optional[Compressor] = None
        self.state: Optional[TrainState] = None

    def _points(self, pts) -> torch.Tensor:
        return torch.as_tensor(pts, dtype=torch.float32).to(self.device)

    def _label_of(self, batch) -> Optional[torch.Tensor]:
        """The batch's category indices with several categories, else
        None."""
        if self.cfg.data.num_categorys > 1:
            return torch.as_tensor(batch["cate_idx"]).to(self.device,
                                                         torch.long)
        return None

    def maybe_init(self, batch, weights=None) -> None:
        """Build the Compressor once (f32 parameters computing in the
        trainer's dtype): random weights from the generator, then ActNorm
        from the whole first batch after train-mode BatchNorms (the JAX
        trainer's `model.init(..., train=True)` on that batch); or from a
        state_dict (`ldt_torch.weights.compressor_state_dict`)."""
        if self.state is not None:
            return
        model = Compressor(self.cfg.model, dtype=self.dtype,
                           param_dtype=torch.float32, device=self.device,
                           generator=self.generator)
        if weights is not None:
            model.load_state_dict(weights)
        else:
            model.init_actnorm(self._points(batch["tr_points"]), train=True)
        self.model = model
        self.state = TrainState.create(dict(model.named_parameters()),
                                       self.tx,
                                       batch_stats=dict(model.named_buffers()),
                                       ema=False)

    def train_step(self, pts: torch.Tensor, lr: float,
                   noise: Optional[Sequence[torch.Tensor]] = None,
                   label: Optional[torch.Tensor] = None):
        """Loss, gradients and the optimizer step on clouds `pts` (labels
        `label`); returns (loss, kl, rec, max), 0-d tensors on the
        device."""
        self.model.zero_grad(set_to_none=True)
        loss, (kl, rec, max_f, new_bs) = compressor_objective(
            self.model, pts, self.kl_weight, noise=noise,
            generator=self.generator, label=label)
        loss.backward()
        grads = {k: p.grad for k, p in self.state.params.items()}
        apply_update(self.state, grads, self.tx, lr, ema_decay=0.0,
                     new_batch_stats=new_bs)
        return tuple(t.detach() for t in (loss, kl, rec, max_f))

    def update(self, data, *,
               noise: Optional[Sequence[torch.Tensor]] = None):
        """One stage-1 step on `data['tr_points']` [B, N, 3] (and, with
        several categories, the labels `data['cate_idx']`); returns (loss,
        kl, rec, max) as the JAX trainer's `update`."""
        self.maybe_init(data)
        out = self.train_step(self._points(data["tr_points"]),
                              self.current_lr(), noise, self._label_of(data))
        self.itr += 1
        return out

    @torch.no_grad()
    def sample(self, num_samples: int, num_points: int,
               given_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Decode [num_samples, num_points, 3] clouds from `given_eps`
        [num_samples, z_scales, n_layers * z_dim], or from N(0, 1) latents
        drawn from the generator."""
        cfg = self.cfg.model
        if given_eps is None:
            given_eps = torch.randn(
                (num_samples, cfg.z_scales, cfg.n_layers * cfg.z_dim),
                device=self.device, generator=self.generator)
        return self.model.sample((num_samples, num_points),
                                 given_eps.to(self.device))

    @torch.no_grad()
    def encode(self, pts, noise: Optional[Sequence[torch.Tensor]] = None,
               label=None) -> dict:
        """The Compressor's forward (running statistics) on clouds
        [B, N, 3] with labels `label` [B] (or None): the decoded 'set',
        'all_eps', 'kls', ..."""
        if label is not None:
            label = torch.as_tensor(label).to(self.device, torch.long)
        return self.model(self._points(pts), noise=noise,
                          generator=self.generator, label=label)

    def valsample(self, test_loader, sample_points: int, vis: bool = False):
        """Decode one batch of prior samples per test batch and score them
        against the test clouds `data['te_points']`: {'val/gen/<metric>'}
        of `compute_all_metrics(smp, ref, batch_size=128)`; the samples go
        to `smp_ep<epoch>.npy` under `cfg.log.save_path` when there is
        one."""
        if vis:
            _not_ported("valsample(vis=True)", "its renderer "
                        "(tools/vis_utils) is a later slice")
        all_ref, all_smp = [], []
        use_time = 0.0
        for data in test_loader:
            ref_pts = data["te_points"]
            t0 = time.time()
            smp = self.sample(ref_pts.shape[0], sample_points)
            self.synchronize()
            use_time += time.time() - t0
            all_smp.append(smp.cpu().numpy())
            all_ref.append(to_numpy(ref_pts))
        smp = np.concatenate(all_smp)
        ref = np.concatenate(all_ref)
        print("Sample rate: %.8f " % (smp.shape[0] / max(use_time, 1e-9)))
        self.save_npy(f"smp_ep{self.epoch}.npy", smp)
        return self.eval_metrics(smp, ref, 128)

    def reconstruction(self, test_loader, val_cate: int = 0):
        """Encode-decode each test batch (with several categories, the
        clouds of `val_cate` only), denormalize the clouds and their
        reconstructions with `* scale + shift`, and score them:
        {'val/gen/<metric>'} of `compute_all_metrics(rec, ref,
        batch_size=128)`; the reconstructions go to `rec_ep<epoch>.npy`
        under `cfg.log.save_path` when there is one."""
        several = self.cfg.data.num_categorys > 1
        all_ref, all_rec = [], []
        for data in test_loader:
            pts, shift, scale = (to_numpy(data[k])
                                 for k in ("te_points", "shift", "scale"))
            labels = {}  # the labels of a class-conditional Compressor
            if several:
                cates = to_numpy(data["cate_idx"])
                idx = cates == val_cate
                if not idx.any():
                    continue
                pts, shift, scale = pts[idx], shift[idx], scale[idx]
                if self.cfg.model.class_condition:
                    labels["label"] = cates[idx]
            rec = self.encode(pts, **labels)["set"]
            shift, scale = self._points(shift), self._points(scale)
            all_ref.append((self._points(pts) * scale + shift).cpu().numpy())
            all_rec.append((rec * scale + shift).cpu().numpy())
        rec = np.concatenate(all_rec)
        ref = np.concatenate(all_ref)
        self.save_npy(f"rec_ep{self.epoch}.npy", rec)
        return self.eval_metrics(rec, ref, 128)

    # the reference's public (misspelled) method name
    reconstrustion = reconstruction

    def _need_state(self, what: str) -> None:
        if self.state is None:
            raise RuntimeError(f"Trainer.{what} needs the model: call "
                               "maybe_init(first_batch) first")

    def state_tree(self) -> dict:
        """The checkpoint's state: {"state": the TrainState's tree}."""
        self._need_state("save")
        return {"state": self.state.to_tree()}

    def save(self):
        """Save `checkpt_<epoch>.pt` under `cfg.log.save_path`."""
        tree = self.state_tree()
        save_checkpoint(checkpoint_path(self.cfg.log.save_path, self.epoch),
                        tree, cfg=self.cfg, epoch=self.epoch, itr=self.itr,
                        time=self.time)

    def resume(self, epoch: Optional[int] = None, finetune: bool = False,
               strict: bool = False, load_optim: bool = True) -> None:
        """Restore the checkpoint of `epoch` (default: the last one,
        `resolve_checkpoint_epoch`) into the live tensors. Unless
        `finetune`, the counters continue from it: epoch + 1, its itr and
        time, and the cosine's gate at its itr. `load_optim=False` (without
        `finetune`) keeps the current optimizer state."""
        self._need_state("resume")
        save_path = self.cfg.log.save_path
        epoch = resolve_checkpoint_epoch(save_path, epoch)
        ckpt = load_checkpoint(checkpoint_file(save_path, epoch))
        restored = restore_into(self.state_tree(), ckpt["state"],
                                strict=strict)
        self.state.load_tree(restored["state"],
                             load_optim=load_optim or finetune)
        if not finetune:
            self.epoch = ckpt["epoch"] + 1
            self.itr = ckpt["itr"]
            self.time = ckpt["time"]
            # a resume lands on an epoch boundary: the resumed itr starts
            # the epoch (the cosine is engaged past the warm-up)
            self._itr_epoch_start = self.itr
