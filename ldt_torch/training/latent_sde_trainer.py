"""Stage-2 trainer: the latent DiT on the frozen Compressor's latents,
counterpart of `ldt_tpu/training/latent_sde_trainer.py`.

One `update(batch)`:
  1. encode the [B, N, 3] clouds through the frozen Compressor, under
     `torch.no_grad()`, to the latents eps [B, z_scale, z_dim] (K2 in every
     attention);
  2. draw a discrete t (a uniform index into linspace(1, sample_time_eps,
     train_N)) and eta ~ N(0, 1) per cloud;
  3. loss = mean(|eta - Score(eps e2int(t) + sqrt(var(t)) eta, t)|^p), p 2
     (`loss_type` l2) or 1, in f32;
  4. backward: K1 forward, K3 backward in every block;
  5. clip by global norm, Adam, EMA (`training.state`).
Sampling and the validation loss use the EMA params.

Every draw can be pinned: `update(..., t_idx=, eta=, enc_noise=)` (the
reparameterization noise of the encode, in decode order); otherwise it comes
from the trainer's `torch.Generator`. Continuous-t training (the JAX
package's `iw_quantities`) is later work and raises. `valsample` samples one
batch per test batch with the EMA params and scores it with
`eval.metrics.compute_all_metrics` (K5 and K6 on the card); its
several-category branch needs class conditioning, a later slice, and
raises, as does `vis=True` (the renderer is not ported).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ldt_torch import resolve_device
from ldt_torch.diffusion import make_diffusion
from ldt_torch.diffusion.sampling import timesteps as schedule
from ldt_torch.generate import sample_latents
from ldt_torch.models import Compressor, Score
from ldt_torch.training.base import BaseTrainer, to_numpy
from ldt_torch.training.state import TrainState, apply_update, make_optimizer


def draw_train_randoms(eps_shape, *, discrete: bool, timesteps: torch.Tensor,
                       train_N: int, sde,
                       generator: Optional[torch.Generator] = None,
                       t_idx: Optional[torch.Tensor] = None,
                       eta: Optional[torch.Tensor] = None):
    """The per-step draws of the stage-2 objective: (t [B], var, e2int,
    weight [B, 1, 1], eta [eps_shape]). `t_idx` [B] (indices into
    `timesteps`) and `eta` pin the draws; else they come from `generator`."""
    if not discrete:
        raise NotImplementedError(
            "continuous-t training (iw_quantities) is not ported yet")
    dev = timesteps.device
    size = eps_shape[0]
    if t_idx is None:
        t_idx = torch.randint(0, train_N, (size,), device=dev,
                              generator=generator)
    t = timesteps[t_idx.to(dev)]
    e2int = sde.e2int_f(t)[:, None, None]
    var = sde.var(t)[:, None, None]
    weight = torch.ones((size, 1, 1), device=dev)
    if eta is None:
        eta = torch.randn(eps_shape, device=dev, generator=generator)
    return t, var, e2int, weight, eta.to(dev)


def score_objective(score, eps, t, var, e2int, weight, eta,
                    loss_type: str = "l2") -> torch.Tensor:
    """mean(|eta - score(xt, t)|^p * weight), xt = eps e2int + sqrt(var) eta;
    p = 1 for `loss_type` l1, else 2."""
    xt = eps * e2int + torch.sqrt(var) * eta
    diff = eta - score(xt, t)
    distance = torch.abs(diff) if loss_type == "l1" else torch.square(diff)
    return torch.mean(distance * weight)


class Trainer(BaseTrainer):
    """Stage-2 trainer. `cfg` has the sections of
    `configs.latent_trainer_cfg()`: score, compressor, sde, opt, common.
    Runs on `device` ("cuda" unless the CPU is asked for); `generator`
    (default: seeded with `cfg.common.seed` on the device) draws the random
    weights and every unpinned draw."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        self.device = resolve_device(device)
        self.generator = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(cfg.common.seed)
        self.sde = make_diffusion(cfg.sde, device=self.device)
        self.N = cfg.sde.train_N
        self.discrete = cfg.opt.discrete
        self.timesteps = schedule(self.N, cfg.sde.sample_time_eps).to(
            self.device)
        self.tx = make_optimizer(cfg.opt.beta1, cfg.opt.beta2,
                                 cfg.opt.weight_decay,
                                 cfg.opt.grad_norm_clip_value,
                                 getattr(cfg.opt, "moment_dtype", "float32"))
        self.ema_decay = cfg.opt.ema_decay
        self.score: Optional[Score] = None
        self.compressor: Optional[Compressor] = None
        self.state: Optional[TrainState] = None

    def _points(self, pts) -> torch.Tensor:
        return torch.as_tensor(pts, dtype=torch.float32).to(self.device)

    def maybe_init(self, batch, score_weights=None,
                   compressor_weights=None) -> None:
        """Build the f32 Score and the frozen Compressor once: random from
        the generator (the Compressor's ActNorm then takes its statistics
        from the first two clouds of `batch`, as the JAX trainer's init), or
        from state_dicts (`ldt_torch.weights`)."""
        if self.state is not None:
            return
        cfg, dev, gen = self.cfg, self.device, self.generator
        self.score = Score(cfg.score, device=dev, generator=gen)
        if score_weights is not None:
            self.score.load_state_dict(score_weights)
        comp = Compressor(cfg.compressor, device=dev, generator=gen).eval()
        comp.requires_grad_(False)
        if compressor_weights is not None:
            comp.load_state_dict(compressor_weights)
        else:
            pts = self._points(batch["tr_points"])
            comp.init_actnorm(pts[:min(2, pts.shape[0])])
        self.compressor = comp
        self.state = TrainState.create(dict(self.score.named_parameters()),
                                       self.tx, ema=True)

    @torch.no_grad()
    def encode(self, pts: torch.Tensor,
               noise: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """The frozen Compressor's latents `all_eps` of clouds [B, N, 3]."""
        return self.compressor(pts, noise=noise,
                               generator=self.generator)["all_eps"]

    def train_step(self, eps: torch.Tensor, lr: float,
                   t_idx: Optional[torch.Tensor] = None,
                   eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Loss, gradients and the optimizer step on latents `eps`; returns
        the loss (a 0-d tensor on the device)."""
        t, var, e2int, weight, eta = draw_train_randoms(
            eps.shape, discrete=self.discrete, timesteps=self.timesteps,
            train_N=self.N, sde=self.sde, generator=self.generator,
            t_idx=t_idx, eta=eta)
        self.score.zero_grad(set_to_none=True)
        loss = score_objective(self.score, eps, t, var, e2int, weight, eta,
                               self.cfg.opt.loss_type)
        loss.backward()
        grads = {k: p.grad for k, p in self.state.params.items()}
        apply_update(self.state, grads, self.tx, lr, self.ema_decay)
        return loss.detach()

    def update(self, data, *, t_idx: Optional[torch.Tensor] = None,
               eta: Optional[torch.Tensor] = None,
               enc_noise: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """One stage-2 step on `data['tr_points']` [B, N, 3]."""
        self.maybe_init(data)
        eps = self.encode(self._points(data["tr_points"]), enc_noise)
        loss = self.train_step(eps, self.current_lr(), t_idx, eta)
        self.itr += 1
        return loss

    @contextlib.contextmanager
    def ema_weights(self):
        """The Score runs with the EMA params inside (their storage is
        swapped in, not copied)."""
        ema = self.state.ema_params
        params = self.state.params
        for k in params:
            params[k].data, ema[k] = ema[k], params[k].data
        try:
            yield self.score
        finally:
            for k in params:
                params[k].data, ema[k] = ema[k], params[k].data

    @torch.no_grad()
    def val_loss(self, data, *, t_idx: Optional[torch.Tensor] = None,
                 eta: Optional[torch.Tensor] = None,
                 enc_noise: Optional[Sequence[torch.Tensor]] = None
                 ) -> torch.Tensor:
        """The objective on `data['te_points']` with the EMA params."""
        self.maybe_init({"tr_points": data["te_points"]})
        eps = self.encode(self._points(data["te_points"]), enc_noise)
        t, var, e2int, weight, eta = draw_train_randoms(
            eps.shape, discrete=True, timesteps=self.timesteps,
            train_N=self.N, sde=self.sde, generator=self.generator,
            t_idx=t_idx, eta=eta)
        with self.ema_weights() as score:
            return score_objective(score, eps, t, var, e2int, weight, eta,
                                   self.cfg.opt.loss_type)

    def sample(self, num_samples: int, num_points: Optional[int] = None):
        """(clouds [num_samples, num_points, 3], latents): the ported
        discrete sampler (`cfg.sde`'s predictor and corrector, sample_N
        steps, draws from the generator) on the EMA Score, then the
        decode."""
        sde_cfg = self.cfg.sde
        if sde_cfg.sample_mode == "continuous":
            raise NotImplementedError("the ODE sampler is not ported yet")
        opts = dict(predictor=sde_cfg.predictor, corrector=sde_cfg.corrector,
                    corrector_steps=sde_cfg.corrector_steps, snr=sde_cfg.snr,
                    probability_flow=sde_cfg.probability_flow,
                    denoise=sde_cfg.denoise, generator=self.generator)
        n = num_points if num_points is not None else \
            self.cfg.data.tr_max_sample_points
        with self.ema_weights() as score, torch.inference_mode():
            eps = sample_latents(score, self.sde, num_samples,
                                 sde_cfg.sample_N, device=self.device, **opts)
            return self.compressor.sample((num_samples, n), eps), eps

    def valsample(self, test_loader, val_cate: int = 0, vis: bool = False):
        """Sample as many clouds as each test batch holds and score them
        against the test clouds `data['te_points']`: {'val/gen/<metric>'}
        of `compute_all_metrics(smp, ref, batch_size=64)`; the samples go to
        `smp_ep<epoch>.npy` under `cfg.log.save_path` when there is one."""
        if vis:
            raise NotImplementedError(
                "Trainer.valsample(vis=True) is not ported yet: its renderer "
                "(tools/vis_utils) is a later slice")
        if self.cfg.data.num_categorys != 1:
            raise NotImplementedError(
                "Trainer.valsample with several categories is not ported "
                "yet: it samples with class labels, and class conditioning "
                "is a later slice")
        all_ref, all_smp = [], []
        use_time = 0.0
        for data in test_loader:
            ref_pts = data["te_points"]
            t0 = time.time()
            smp, _ = self.sample(num_samples=ref_pts.shape[0])
            self.synchronize()
            use_time += time.time() - t0
            all_smp.append(smp.cpu().numpy())
            all_ref.append(to_numpy(ref_pts))
        smp = np.concatenate(all_smp)
        ref = np.concatenate(all_ref)
        print("Sample rate: %.8f " % (smp.shape[0] / max(use_time, 1e-9)))
        self.save_npy(f"smp_ep{self.epoch}.npy", smp)
        return self.eval_metrics(smp, ref, 64)
