"""ViPC completion, stage 2: the conditional latent DiT, counterpart of
`ldt_tpu/training/completion_latent_sde_trainer.py`.

The Score (`score.condition: True`) is conditioned on a partial cloud and a
rendered view through its `ConditionNet`; the frozen Compressor is the
completion stage 1's. Otherwise the stage-2 trainer (`latent_sde_trainer`:
the objective, optimizer, EMA, checkpoints), with:
  * `update(pc, condition)`: GT clouds [B, N, 3] (the entry's FPS to
    `num_points`) and {'img': views [B, H, W, 3], 'pts': the partial
    clouds}, or a ViPC batch dict (both clouds `fps_to` here); the Score's
    train-mode forward normalizes its ConditionNet's BatchNorms with the
    batch's statistics, and their updated running statistics go into the
    step (`apply_update(..., new_batch_stats=)`), as JAX's
    `mutable=["batch_stats"]`; the draws come from the trainer's generator
    or are pinned (`t_idx`, `eta`, `enc_noise`);
  * `sample(n, condition=)`: the condition encoded once per run (the
    trunk runs once, not once a step), the f32 EMA Score whole at each of
    `sde.sample_N` discrete steps, then the decode;
  * `valsample`: one sample per test item (at most ~1000 unless `full`),
    scored by CD x 1000 and F1 against the GT clouds; `part`, `smp` and
    `ref` `.npy` files saved;
  * `reconstruction`: the frozen Compressor's encode-decode of the GT
    clouds, scored the same way.
The int8 conditional path, the continuous (ODE) sampler and `vis=True`
raise NotImplementedError. A training step with a nonzero `score.dropout`
raises, as the JAX package's does (its conditional step passes the Score
no 'dropout' rng).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ldt_torch.generate import sample_latents
from ldt_torch.models import Compressor, Score
from ldt_torch.training.base import to_numpy
from ldt_torch.training.completion_compressor_trainer import (
    completion_scores,
    fps_to,
)
from ldt_torch.training.latent_sde_trainer import Trainer as LatentTrainer
from ldt_torch.training.latent_sde_trainer import score_objective
from ldt_torch.training.state import TrainState, apply_update

# `valsample` stops once it holds more samples than this, unless `full`
VAL_CAP = 1000


class Trainer(LatentTrainer):
    """The completion stage-2 trainer; `cfg` as the stage-2 trainer's, with
    `score.condition: True`; `device`, `generator` and `dtype` as the
    stage-2 trainer's."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cfg, device=device, generator=generator,
                         dtype=dtype)
        self.num_points = cfg.data.tr_max_sample_points

    def _condition(self, condition: dict) -> dict:
        """A {'img', 'pts'} condition as f32 tensors on the device (a numpy
        array copied: a loader's may be read-only)."""
        return {k: None if v is None else (
            v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v, np.float32))).to(self.device, torch.float32)
            for k, v in condition.items()}

    def maybe_init(self, batch, score_weights=None,
                   compressor_weights=None) -> None:
        """Build the conditional Score and the frozen Compressor once (f32
        parameters computing in the trainer's dtype), random from the
        generator (the Compressor's ActNorm from the
        batch's clouds: a ViPC batch's `pc` `fps_to` the trainer's point
        count, else its `tr_points`) or from state_dicts; the TrainState
        holds the Score's running statistics as `batch_stats`."""
        if self.state is not None:
            return
        cfg, dev = self.cfg, self.device
        score = Score(cfg.score, **self._kw())
        if score_weights is not None:
            score.load_state_dict(score_weights)
        comp = Compressor(cfg.compressor, **self._kw()).eval()
        comp.requires_grad_(False)
        if compressor_weights is not None:
            comp.load_state_dict(compressor_weights)
        else:
            pts = (fps_to(batch["pc"], self.num_points, dev) if "pc" in batch
                   else self._points(batch["tr_points"]))
            comp.init_actnorm(pts)
        self.score, self.compressor = score, comp
        stats = dict(score.named_buffers())
        self.state = TrainState.create(dict(score.named_parameters()),
                                       self.tx, batch_stats=stats or None,
                                       ema=True)

    def train_step(self, eps: torch.Tensor, lr: float, condition=None,
                   t_idx: Optional[torch.Tensor] = None,
                   eta: Optional[torch.Tensor] = None,
                   label: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Loss, gradients and the optimizer step on latents `eps` with the
        condition `condition`, the Score in train mode without dropout
        masks (a nonzero `score.dropout` raises); its BatchNorms' updated
        running statistics join the step. Returns the loss."""
        t, var, e2int, weight, eta = self.draws(eps.shape, self.discrete,
                                                t_idx, eta=eta)
        self.score.zero_grad(set_to_none=True)
        loss = score_objective(self.score, eps, t, var, e2int, weight, eta,
                               self.cfg.opt.loss_type, label, condition,
                               train=True)
        new_stats = self.score.take_batch_stats()
        loss.backward()
        grads = {k: p.grad for k, p in self.state.params.items()}
        apply_update(self.state, grads, self.tx, lr, self.ema_decay,
                     new_batch_stats=new_stats if self.state.batch_stats
                     else None)
        return loss.detach()

    def update(self, data, condition=None, *,
               t_idx: Optional[torch.Tensor] = None,
               eta: Optional[torch.Tensor] = None,
               enc_noise: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """One step on GT clouds `data` [B, N, 3] (already `fps_to` the
        point count) with `condition` {'img', 'pts'}, or on a ViPC batch
        dict (its views and both clouds `fps_to` the point count)."""
        if isinstance(data, dict):
            pts = fps_to(data["pc"], self.num_points, self.device)
            condition = {"img": data["views"],
                         "pts": fps_to(data["pc_part"], self.num_points,
                                       self.device)}
            self.maybe_init(data)
        else:
            pts = self._points(data)
            self.maybe_init({"pc": pts})
        if condition is not None:
            condition = self._condition(condition)
        eps = self.encode(pts, enc_noise)
        loss = self.train_step(eps, self.current_lr(), condition, t_idx, eta)
        self.itr += 1
        return loss

    def sample(self, num_samples: int, num_points: Optional[int] = None,
               label=None, condition=None, *, int8: bool = False):
        """(clouds [num_samples, num_points, 3], latents) for the condition
        {'img', 'pts'} (num_samples of each): the condition encoded once
        with the EMA Score's ConditionNet (running statistics), the ported
        discrete sampler (`cfg.sde`'s predictor and corrector, sample_N
        steps, draws from the generator) with the whole EMA Score each
        step, then the decode. `int8` (the conditional serving path) is
        not ported and raises."""
        if int8:
            raise NotImplementedError(
                "the int8 conditional serving path (serving/int8.py's "
                "precompute_cond_kv, denoise_cond_int8) is not ported yet")
        if label is not None:
            raise ValueError("the completion sampler takes no label")
        sde_cfg = self.cfg.sde
        if sde_cfg.sample_mode == "continuous":
            raise NotImplementedError("the ODE sampler is not ported yet")
        opts = dict(predictor=sde_cfg.predictor, corrector=sde_cfg.corrector,
                    corrector_steps=sde_cfg.corrector_steps, snr=sde_cfg.snr,
                    probability_flow=sde_cfg.probability_flow,
                    denoise=sde_cfg.denoise, generator=self.generator)
        n = self.num_points if num_points is None else num_points
        if condition is not None:
            condition = self._condition(condition)
        with self.ema_weights() as score, torch.inference_mode():
            if condition is not None:
                condition = score.encode_condition(condition)
            eps = sample_latents(score, self.sde, num_samples,
                                 sde_cfg.sample_N, device=self.device,
                                 condition=condition, **opts)
            return self.compressor.sample((num_samples, n), eps), eps

    def valsample(self, test_loader, vis: bool = False, full: bool = False):
        """One completion per test item, conditioned on its view and its
        partial cloud (`fps_to` 2048, as the GT clouds), until more than
        `VAL_CAP` are held unless `full`: {'cd', 'f1score'} against the GT
        clouds; `part_ep<epoch>.npy`, `smp_ep<epoch>.npy` and
        `ref_ep<epoch>.npy` under `cfg.log.save_path`."""
        if vis:
            raise NotImplementedError(
                "Trainer.valsample(vis=True) is not ported yet: its renderer "
                "(tools/vis_utils) is a later slice")
        all_ref, all_part, all_smp = [], [], []
        use_time = 0.0
        for data in test_loader:
            ref_pts = fps_to(data["pc"], 2048, self.device)
            pc_part = fps_to(data["pc_part"], 2048, self.device)
            t0 = time.time()
            smp, _ = self.sample(ref_pts.shape[0], condition={
                "img": data["views"], "pts": pc_part})
            self.synchronize()
            use_time += time.time() - t0
            all_smp.append(smp.cpu().numpy())
            all_ref.append(to_numpy(ref_pts))
            all_part.append(to_numpy(pc_part))
            if not full and sum(s.shape[0] for s in all_smp) > VAL_CAP:
                break
        smp = np.concatenate(all_smp)
        ref = np.concatenate(all_ref)
        part = np.concatenate(all_part)
        print("Sample rate: %.8f " % (smp.shape[0] / max(use_time, 1e-9)))
        for name, arr in (("part", part), ("smp", smp), ("ref", ref)):
            self.save_npy(f"{name}_ep{self.epoch}.npy", arr)
        all_res = completion_scores(smp, ref, self.device)
        print(f"Validation Sample (unit) Epoch:{self.epoch} ", all_res)
        return all_res

    @torch.no_grad()
    def reconstruct(self, pts: torch.Tensor) -> torch.Tensor:
        """The frozen Compressor's encode-decode of clouds [B, N, 3]."""
        return self.compressor(pts, generator=self.generator)["set"]

    def reconstruction(self, test_loader):
        """CD x 1000 and F1 of the frozen Compressor's reconstructions of
        the test split's GT clouds (`fps_to` 2048); `rec_ep<epoch>.npy`
        saved."""
        all_ref, all_rec = [], []
        for data in test_loader:
            ref_pts = fps_to(data["pc"], 2048, self.device)
            all_rec.append(self.reconstruct(ref_pts).cpu().numpy())
            all_ref.append(to_numpy(ref_pts))
        rec = np.concatenate(all_rec)
        ref = np.concatenate(all_ref)
        self.save_npy(f"rec_ep{self.epoch}.npy", rec)
        return completion_scores(rec, ref, self.device)

    reconstrustion = reconstruction
