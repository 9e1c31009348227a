"""Stage-2 trainer: the latent DiT on the frozen Compressor's latents,
counterpart of `ldt_tpu/training/latent_sde_trainer.py`.

One `update(batch)`:
  1. encode the [B, N, 3] clouds through the frozen Compressor, under
     `torch.no_grad()`, to the latents eps [B, z_scale, z_dim] (K2 in every
     attention);
  2. draw t per cloud: discrete (`opt.discrete`: a uniform index into
     linspace(1, sample_time_eps, train_N), weight 1) or continuous (the
     SDE's `iw_quantities` in `sde.iw_sample_p_mode` from `sde.time_eps`,
     weight its objective weight), and eta ~ N(0, 1);
  3. loss = mean(|eta - Score(eps e2int(t) + sqrt(var(t)) eta, t)|^p
     * weight), p 2 (`loss_type` l2) or 1, in f32;
  4. backward: K1 forward, K3 backward in every block;
  5. clip by global norm, Adam, EMA (`training.state`).
The step is a `train.step` span (`tools.profiling`) of the iteration,
holding `train.batch` (build, the clouds to the device), `train.encode`
(1), `train.loss` (2-3), `train.backward` (4) and `train.optimizer` (5).
Sampling and the validation loss use the EMA params.

With several categories (`data.num_categorys` > 1) each batch's `cate_idx`
labels the clouds: through the frozen (class-conditional) encode, the
Score's conditioning c = t_emb + l_emb and the validation loss.

Both nets compute in the trainer's `dtype` (`common.train_dtype`: f32, or
bf16 with f32 parameters, EMA, moments and gradients, the JAX package's
mixed precision); the loss promotes to f32 where it meets the f32 noise.
The Adam moments are stored in `opt.moment_dtype`. The Score drops out at
`score.dropout` in the training step (`DropoutMasks` from the trainer's
generator), never in `val_loss` or `sample`.

Every draw can be pinned: `update(..., t_idx=, eta=, enc_noise=,
dropout=)` (the reparameterization noise of the encode, in decode order;
the dropout keep masks, in the Score's call order) and
`train_step(..., rho=)` (continuous t's uniform draw); otherwise it comes
from the trainer's `torch.Generator`. The validation loss always draws
discrete t, as the JAX trainer's. `sample(n, label=)`
runs the whole Score at each step with the label (the modulations are not
hoisted: c depends on the label). `valsample` samples one batch per test
batch with the EMA params, or with several categories
ceil(n_ref / test_batch_size) batches of `test_batch_size` at the label
`val_cate` cut to the n_ref test clouds of that category, and scores them
with `eval.metrics.compute_all_metrics` (K5 and K6 on the card); with
`vis=True` it renders them under `<save_path>/vis` (`tools.vis_utils`).
`cfg.sde.predictor: pndm` and `sample_mode: continuous` (the
probability-flow ODE, its counts in `ode_stats`) run the whole Score at
each evaluation and never the int8 twin.

`sample(..., serve_int8=True)` serves through the W8A8 twin
(`serving.int8`, `sample_latents(int8=True)`) where `int8_serving_active`
holds; the JAX package's environment knobs are its arguments (`serve_int8`,
`attn_int8`, `bf16_tail`, `static_act`, `static_file`, `strict`). Once per
restored checkpoint it checks the golden-gate stamp next to it (a warning,
or with `strict` an error, when no PASSED stamp matches the sampler), and
with `static_act` it loads that checkpoint's static activation scales
(`load_act_scales`, provenance checked) and passes them into each call, so a
`resume` to another checkpoint serves that checkpoint's scales.
`restored_ckpt` records the file the Score was restored from (`resume`);
`load_pretrain` restores only the frozen Compressor and leaves it as it is.

`save` writes `checkpt_<epoch>.pt` under `cfg.log.save_path` with both
nets' states, {"score": the TrainState's tree, "compressor": the frozen
Compressor's state_dict}, the Adam moments rounded to bf16 (as the JAX
trainer saves them) and the file written on a thread; `resume` restores
one, or the JAX package's `.msgpack`, into the live tensors;
`load_pretrain` takes the frozen Compressor from a stage-1 checkpoint of
either package (`cfg.compressor.pretrain_path`).

Under a mesh (`training.base`): the Score, its EMA and Adam moments are
tensor-parallel over `model` (`parallel.tp.shard_train_state`; the clip's
norm global), the Compressor replicated; each rank encodes and trains on
its rows of the global batch, every draw made at the global shape; the
gradients are summed (`sync_grads`) and the loss returned is the global
batch's. `sample` runs the whole batch on every rank (the Score
tensor-parallel, the decode sequence-parallel), so every rank holds the
same clouds; int8 serving quantizes the gathered weights. `save` gathers
the full state, which rank 0 writes in the single-process format, and
`resume` cuts a full checkpoint to the rank's shards.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ldt_torch import resolve_device
from ldt_torch.diffusion import make_diffusion
from ldt_torch.diffusion.sampling import timesteps as schedule
from ldt_torch.generate import sample_latents
from ldt_torch.models import Compressor, Score
from ldt_torch.nn.layers import DropoutMasks
from ldt_torch.parallel import tp as tp_rules
from ldt_torch.serving import int8 as int8_serving
from ldt_torch.tools import profiling
from ldt_torch.tools.utils import train_dtype
from ldt_torch.tools.vis_utils import render_3D
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


def draw_train_randoms(eps_shape, *, discrete: bool, timesteps: torch.Tensor,
                       train_N: int, sde, time_eps: Optional[float] = None,
                       iw_mode: Optional[str] = None,
                       subvp_like: bool = False,
                       generator: Optional[torch.Generator] = None,
                       t_idx: Optional[torch.Tensor] = None,
                       rho: Optional[torch.Tensor] = None,
                       eta: Optional[torch.Tensor] = None):
    """The per-step draws of the stage-2 objective: (t [B], var, e2int,
    weight [B, 1, 1], eta [eps_shape]). Discrete t: a uniform index into
    `timesteps`, weight 1; continuous t: `sde.iw_quantities(B, time_eps,
    iw_mode, subvp_like)`, weight its objective weight. `t_idx` [B] (the
    indices), `rho` [B] (continuous t's uniform draw) and `eta` pin the
    draws; else they come from `generator`."""
    dev = timesteps.device
    size = eps_shape[0]
    if discrete:
        if t_idx is None:
            t_idx = torch.randint(0, train_N, (size,), device=dev,
                                  generator=generator)
        t = timesteps[t_idx.to(dev)]
        e2int = sde.e2int_f(t)[:, None, None]
        var = sde.var(t)[:, None, None]
        weight = torch.ones((size, 1, 1), device=dev)
    else:
        t, var, e2int, weight, _, _ = sde.iw_quantities(
            size, time_eps, iw_mode, subvp_like, generator=generator,
            rho=rho)
        var, e2int, weight = var[..., None], e2int[..., None], \
            weight[..., None]
    if eta is None:
        eta = torch.randn(eps_shape, device=dev, generator=generator)
    return t, var, e2int, weight, eta.to(dev)


def score_objective(score, eps, t, var, e2int, weight, eta,
                    loss_type: str = "l2",
                    label: Optional[torch.Tensor] = None, condition=None,
                    train: bool = False,
                    dropout: Optional[DropoutMasks] = None) -> torch.Tensor:
    """mean(|eta - score(xt, t, label, condition, train, dropout)|^p *
    weight), xt = eps e2int + sqrt(var) eta; p = 1 for `loss_type` l1,
    else 2."""
    xt = eps * e2int + torch.sqrt(var) * eta
    diff = eta - score(xt, t, label, condition, train=train, dropout=dropout)
    distance = torch.abs(diff) if loss_type == "l1" else torch.square(diff)
    return torch.mean(distance * weight)


class Trainer(BaseTrainer):
    """Stage-2 trainer. `cfg` has the sections of
    `configs.latent_trainer_cfg()`: score, compressor, sde, opt, common.
    Runs on `device` ("cuda" unless the CPU is asked for); `generator`
    (default: seeded with `cfg.common.seed` on the device) draws the random
    weights and every unpinned draw; `dtype` (default:
    `tools.utils.train_dtype(cfg)`) is the nets' compute dtype."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, mesh=None):
        super().__init__(cfg, mesh)
        self.device = resolve_device(device)
        self.dtype = train_dtype(cfg) if dtype is None else dtype
        self.generator = generator if generator is not None else \
            torch.Generator(self.device).manual_seed(cfg.common.seed)
        self.sde = make_diffusion(cfg.sde, device=self.device)
        self.N = cfg.sde.train_N
        self.discrete = cfg.opt.discrete
        self.time_eps = cfg.sde.time_eps
        # an explicit `sde.iw_subvp_like_vp_sde` overrides the default
        self.subvp_like = getattr(cfg.sde, "iw_subvp_like_vp_sde",
                                  cfg.sde.sde_type == "sub_vpsde")
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
        # the Score's tensor-parallel layout ({name: Shard or None}) once
        # it is sharded over a model axis
        self.score_specs: Optional[dict] = None
        # True while the golden gate itself samples: its legs are the
        # certification run, so they check no stamp
        self.gate_exempt = False
        # the ODE sampler's counts of the last continuous `sample`
        self.ode_stats: dict = {}
        # `restored_ckpt`: the checkpoint file the Score was restored from
        # (the int8 gate stamp and static scales sit next to it)
        self._restore_recorded(None)

    def _points(self, pts) -> torch.Tensor:
        return torch.as_tensor(pts, dtype=torch.float32).to(self.device)

    def _label_of(self, batch) -> Optional[torch.Tensor]:
        """The batch's category indices with several categories, else
        None."""
        if self.cfg.data.num_categorys > 1:
            return torch.as_tensor(batch["cate_idx"]).to(self.device,
                                                         torch.long)
        return None

    def maybe_init(self, batch, score_weights=None,
                   compressor_weights=None) -> None:
        """Build the Score and the frozen Compressor once (f32 parameters,
        computing in the trainer's dtype): random from the generator (the
        Compressor's ActNorm then takes its statistics from the first two
        clouds of `batch`, as the JAX trainer's init), or from state_dicts
        (`ldt_torch.weights`)."""
        if self.state is not None:
            return
        cfg = self.cfg
        self.score = Score(cfg.score, **self._kw())
        if score_weights is not None:
            self.score.load_state_dict(score_weights)
        comp = Compressor(cfg.compressor, **self._kw()).eval()
        comp.requires_grad_(False)
        if compressor_weights is not None:
            comp.load_state_dict(compressor_weights)
        else:
            pts = self._points(batch["tr_points"])
            comp.init_actnorm(pts[:min(2, pts.shape[0])])
        self.compressor = comp
        self.state = TrainState.create(dict(self.score.named_parameters()),
                                       self.tx, ema=True)
        self._shard_score()

    def _shard_score(self) -> None:
        """Under a model axis: shard the Score and its state
        (`parallel.tp.shard_train_state`) and give the optimizer's clip
        the shards' names."""
        if not tp_rules.has_model_axis(self.mesh):
            return
        self.state, self.score_specs = tp_rules.shard_train_state(
            self.state, self.score, self.mesh)
        self.tx.shard(self.sharded_names(),
                      tp_rules.axis_group(self.mesh, "model"))

    def sharded_names(self):
        """The names of the Score's tensor-parallel shards."""
        return [k for k, v in (self.score_specs or {}).items()
                if v is not None]

    def _kw(self) -> dict:
        """The nets' construction arguments: f32 parameters computing in
        the trainer's dtype, on its device, drawn from its generator."""
        return dict(dtype=self.dtype, param_dtype=torch.float32,
                    device=self.device, generator=self.generator)

    def dropout_masks(self, masks=None) -> DropoutMasks:
        """A training step's dropout masks: pinned (`masks`, in call
        order), else drawn from the trainer's generator."""
        return DropoutMasks(self.generator, masks)

    def step_masks(self, masks, batch: int) -> DropoutMasks:
        """`dropout_masks(masks)`, under a mesh cut to this rank's rows of
        the global `batch` (drawn, or pinned, at it)."""
        out = self.dropout_masks(masks)
        if self.data_size() > 1:
            out.take_rows(*self.rows(batch), batch)
        return out

    @torch.no_grad()
    def encode(self, pts: torch.Tensor,
               noise: Optional[Sequence[torch.Tensor]] = None,
               label: Optional[torch.Tensor] = None,
               seed_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The frozen Compressor's latents `all_eps` of clouds [B, N, 3]
        (labels `label` for a class-conditional one)."""
        return self.compressor(pts, noise=noise, generator=self.generator,
                               label=label, seed_draw=seed_draw)["all_eps"]

    def encode_batch(self, pts: torch.Tensor,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     label: Optional[torch.Tensor] = None):
        """(latents, labels) of this rank's rows of a global batch of
        clouds: under a mesh the encode's draws are made at the global
        batch (or `noise` pinned at it) and cut to the rows."""
        seed = None
        if self.data_size() > 1:
            if noise is None:
                noise, seed = self.decode_draws(self.compressor,
                                                pts.shape[0], self.dtype)
            else:
                noise = self.local(list(noise))
            pts, label = self.local(pts), self.local(label)
        return self.encode(pts, noise, label, seed), label

    def draws(self, eps_shape, discrete: bool,
              t_idx: Optional[torch.Tensor] = None,
              rho: Optional[torch.Tensor] = None,
              eta: Optional[torch.Tensor] = None):
        """`draw_train_randoms` with the trainer's schedule, SDE, config
        (`sde.iw_sample_p_mode`) and generator."""
        return draw_train_randoms(
            eps_shape, discrete=discrete, timesteps=self.timesteps,
            train_N=self.N, sde=self.sde, time_eps=self.time_eps,
            iw_mode=self.cfg.sde.iw_sample_p_mode,
            subvp_like=self.subvp_like, generator=self.generator,
            t_idx=t_idx, rho=rho, eta=eta)

    def train_step(self, eps: torch.Tensor, lr: float,
                   t_idx: Optional[torch.Tensor] = None,
                   eta: Optional[torch.Tensor] = None,
                   label: Optional[torch.Tensor] = None,
                   rho: Optional[torch.Tensor] = None,
                   dropout=None, batch: Optional[int] = None
                   ) -> torch.Tensor:
        """Loss, gradients and the optimizer step on latents `eps` (labels
        `label`), t drawn as `self.discrete` says, the Score in train mode
        (its dropout masks pinned by `dropout`, else drawn); returns the
        loss (a 0-d tensor on the device). Under a mesh `eps` holds this
        rank's rows of a global batch of `batch` (default: the rows times
        the data size): the draws are made, or pinned, at the global batch
        and cut to the rows; the loss is the global batch's."""
        batch = eps.shape[0] * self.data_size() if batch is None else batch
        with profiling.span("train.loss"):
            t, var, e2int, weight, eta = self.local(self.draws(
                (batch,) + tuple(eps.shape[1:]), self.discrete, t_idx, rho,
                eta))
            self.score.zero_grad(set_to_none=True)
            loss = score_objective(self.score, eps, t, var, e2int, weight,
                                   eta, self.cfg.opt.loss_type, label,
                                   train=True,
                                   dropout=self.step_masks(dropout, batch))
        with profiling.span("train.backward"):
            loss.backward()
        with profiling.span("train.optimizer"):
            self.sync_grads(self.state.params, self.sharded_names())
            grads = {k: p.grad for k, p in self.state.params.items()}
            apply_update(self.state, grads, self.tx, lr, self.ema_decay)
        return self.global_mean(loss.detach())

    def update(self, data, *, t_idx: Optional[torch.Tensor] = None,
               eta: Optional[torch.Tensor] = None,
               enc_noise: Optional[Sequence[torch.Tensor]] = None,
               dropout=None) -> torch.Tensor:
        """One stage-2 step on `data['tr_points']` [B, N, 3] (and, with
        several categories, the labels `data['cate_idx']`)."""
        with profiling.span("train.step", self.itr):
            with profiling.span("train.batch"):
                self.maybe_init(data)
                pts = self._points(data["tr_points"])
                label = self._label_of(data)
            with profiling.span("train.encode"):
                eps, label = self.encode_batch(pts, enc_noise, label)
            loss = self.train_step(eps, self.current_lr(), t_idx, eta, label,
                                   dropout=dropout, batch=pts.shape[0])
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
        label = self._label_of(data)
        eps = self.encode(self._points(data["te_points"]), enc_noise, label)
        t, var, e2int, weight, eta = self.draws(eps.shape, True, t_idx,
                                                eta=eta)
        with self.ema_weights() as score:
            return score_objective(score, eps, t, var, e2int, weight, eta,
                                   self.cfg.opt.loss_type, label)

    def _restore_recorded(self, path: Optional[str]) -> None:
        """Record the checkpoint the Score was restored from; int8 serving
        then checks its stamp and reads its scales anew."""
        self.restored_ckpt = path
        self._int8_gate_checked = set()
        self._act_scales = self._act_scales_key = None

    def _maybe_verify_int8_gate(self, active: bool, completion: bool = False,
                                *, strict: bool = False,
                                attn_int8: bool = False, bf16_tail: int = 0,
                                static_act: bool = False) -> None:
        """Check the golden-gate stamp of the restored checkpoint before it
        is served int8: once per restored checkpoint and sampler config;
        warns, or with `strict` raises (`serving.int8.verify_gate_stamp`)."""
        key = (completion, strict, attn_int8, bf16_tail, static_act)
        if not active or self.gate_exempt or key in self._int8_gate_checked:
            return
        int8_serving.verify_gate_stamp(
            self.restored_ckpt, self.cfg, completion, strict=strict,
            attn_int8=attn_int8, bf16_tail=bf16_tail, static_act=static_act)
        self._int8_gate_checked.add(key)

    def _ensure_act_scales(self, bf16_tail: int = 0,
                           static_file: Optional[str] = None
                           ) -> torch.Tensor:
        """The static activation scales of the restored checkpoint (or of
        `static_file`), loaded and provenance-checked once per restored
        checkpoint; any problem raises (`serving.int8.load_act_scales`)."""
        key = (bf16_tail, static_file)
        if self._act_scales is None or self._act_scales_key != key:
            self._act_scales = int8_serving.load_act_scales(
                self.restored_ckpt, self.cfg.sde.sample_N,
                self.cfg.score.num_blocks, self.cfg, bf16_tail=bf16_tail,
                static_file=static_file)
            self._act_scales_key = key
        return self._act_scales

    def _sampler_opts(self) -> dict:
        """`sample_latents`' sampler options from `cfg.sde`, the draws from
        the trainer's generator: the discrete sampler's (`predictor`, ...,
        sample_time_eps), or with `sample_mode: continuous` the ODE's
        (`ode_tol`; its counts land in `ode_stats`)."""
        sde_cfg = self.cfg.sde
        opts = dict(predictor=sde_cfg.predictor, corrector=sde_cfg.corrector,
                    corrector_steps=sde_cfg.corrector_steps, snr=sde_cfg.snr,
                    probability_flow=sde_cfg.probability_flow,
                    denoise=sde_cfg.denoise, generator=self.generator,
                    time_eps=sde_cfg.sample_time_eps)
        if sde_cfg.sample_mode == "continuous":
            self.ode_stats = {}
            opts.update(sample_mode="continuous", ode_tol=sde_cfg.ode_tol,
                        ode_stats=self.ode_stats)
        return opts

    def sample(self, num_samples: int, num_points: Optional[int] = None,
               label=None, *, serve_int8: bool = False,
               attn_int8: bool = False, bf16_tail: int = 0,
               static_act: bool = False, static_file: Optional[str] = None,
               strict: bool = False):
        """(clouds [num_samples, num_points, 3], latents): the sampler of
        `cfg.sde` (the discrete one's predictor and corrector over sample_N
        steps, or with `sample_mode: continuous` the probability-flow ODE
        at `ode_tol`, its counts in `ode_stats`; draws from the generator)
        on the EMA Score, conditioned on `label` (a category index or
        [num_samples] of them) if given, then the decode (no label: the
        Compressor's `sample`).
        PNDM and the ODE run the whole Score at each evaluation.

        `serve_int8`: where `int8_serving_active` holds, each step goes
        through the W8A8 twin (its attention core K8 with `attn_int8`, the
        last `bf16_tail` blocks in bf16, with `static_act` the restored
        checkpoint's static scales, or those of `static_file`), after the
        gate stamp check (`strict` raises on a problem)."""
        active = int8_serving.int8_serving_active(
            self.cfg, self.cfg.sde.sample_mode, label, None,
            serve_int8=serve_int8)
        self._maybe_verify_int8_gate(active, strict=strict,
                                     attn_int8=attn_int8,
                                     bf16_tail=bf16_tail,
                                     static_act=static_act)
        serving = {}
        if active:
            serving = dict(int8=True, attn_int8=attn_int8,
                           bf16_tail=bf16_tail)
            if static_act:
                serving["act_scales"] = self._ensure_act_scales(
                    bf16_tail, static_file)
        opts = self._sampler_opts()
        n = num_points if num_points is not None else \
            self.cfg.data.tr_max_sample_points
        if label is not None:
            label = torch.as_tensor(label, device=self.device).long().expand(
                num_samples)
        with self.ema_weights() as score, torch.inference_mode():
            if active and self.score_specs is not None:
                # the W8A8 twin is single-shard: quantize the full weights
                serving["int8_weights"] = tp_rules.gather_params(
                    score, self.score_specs, self.mesh)
            eps = sample_latents(score, self.sde, num_samples,
                                 self.cfg.sde.sample_N, device=self.device,
                                 label=label, **serving, **opts)
            return self.compressor.sample((num_samples, n), eps), eps

    def valsample(self, test_loader, val_cate: int = 0, vis: bool = False):
        """Sample as many clouds as each test batch holds, or with several
        categories ceil(n / test_batch_size) batches of test_batch_size at
        the label `val_cate` cut to the n test clouds of `val_cate`, and
        score them against those test clouds `data['te_points']`:
        {'val/gen/<metric>'} of `compute_all_metrics(smp, ref,
        batch_size=64)`; the samples go to `smp_ep<epoch>.npy` under
        `cfg.log.save_path` when there is one, and with `vis` rendered
        under its `vis/` (`tools.vis_utils.render_3D`)."""
        vis_dir = self.vis_dir() if vis else None
        all_ref, all_smp = [], []
        use_time = 0.0
        if self.cfg.data.num_categorys == 1:
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
        else:
            for data in test_loader:
                idx = to_numpy(data["cate_idx"]) == val_cate
                all_ref.append(to_numpy(data["te_points"])[idx])
            ref = np.concatenate(all_ref)
            bsize = self.cfg.data.test_batch_size
            t0 = time.time()
            for _ in range(math.ceil(ref.shape[0] / bsize)):
                smp, _ = self.sample(num_samples=bsize, label=val_cate)
                self.synchronize()
                all_smp.append(smp.cpu().numpy())
            use_time += time.time() - t0
            smp = np.concatenate(all_smp)[:ref.shape[0]]
        print("Sample rate: %.8f " % (smp.shape[0] / max(use_time, 1e-9)))
        self.save_npy(f"smp_ep{self.epoch}.npy", smp)
        if vis:
            render_3D(vis_dir, smp)
        return self.eval_metrics(smp, ref, 64)

    def state_tree(self, full: bool = False) -> dict:
        """The checkpoint's state: {"score": the TrainState's tree,
        "compressor": the Compressor's state_dict}, live tensors; with
        `full` under a model axis the Score's tree gathered to full tensors
        (every rank must call it)."""
        if self.state is None:
            raise RuntimeError("the stage-2 Trainer needs its nets: call "
                               "maybe_init(first_batch) first")
        score = self.state.to_tree()
        if full and self.score_specs is not None:
            score = tp_rules.gather_tree(score, self.score_specs, self.mesh)
        return {"score": score,
                "compressor": dict(self.compressor.state_dict())}

    def save(self):
        """Save `checkpt_<epoch>.pt` under `cfg.log.save_path`: the Adam
        moments in bf16 (params and EMA stay f32), written on a thread
        (`checkpoint.wait_pending_saves` joins it); under a mesh the full
        state, written by rank 0."""
        tree = self.state_tree(full=True)
        if not self.is_main:
            return
        save_checkpoint(checkpoint_path(self.cfg.log.save_path, self.epoch),
                        tree, cfg=self.cfg, epoch=self.epoch, itr=self.itr,
                        time=self.time, moments_bf16=True, async_write=True)

    def resume(self, epoch: Optional[int] = None, strict: bool = False,
               load_optim: bool = True, finetune: bool = False,
               pretrain: Optional[str] = None) -> None:
        """Restore both nets from the checkpoint file `pretrain`, or from
        that of `epoch` under `cfg.log.save_path` (default: the last one).
        The optimizer state is kept when `finetune` or not `load_optim`;
        the counters restart at epoch 1, itr 0 when `finetune`, else
        continue from the checkpoint's (epoch + 1, the cosine's gate at its
        itr); the wall time is the checkpoint's."""
        ckpt, restored = self._restored(epoch, strict, pretrain)
        self.state.load_tree(self.local_score_tree(restored["score"]),
                             load_optim=load_optim and not finetune)
        self.compressor.load_state_dict(restored["compressor"])
        self._set_counters(ckpt, finetune)

    def _restored(self, epoch: Optional[int], strict: bool,
                  pretrain: Optional[str]):
        """(the checkpoint, its state restored into `state_tree()`'s
        structure) of the file `pretrain`, else of `epoch` (default: the
        last) under `cfg.log.save_path`; the file is recorded as
        `restored_ckpt`."""
        tree = self.state_tree(full=True)
        if pretrain is None:
            save_path = self.cfg.log.save_path
            pretrain = checkpoint_file(
                save_path, resolve_checkpoint_epoch(save_path, epoch))
        ckpt = load_checkpoint(pretrain)
        restored = restore_into(tree, ckpt["state"], strict=strict)
        self._restore_recorded(pretrain)
        return ckpt, restored

    def local_score_tree(self, tree: dict) -> dict:
        """A full Score tree cut to this rank's shards (itself without a
        model axis)."""
        if self.score_specs is None:
            return tree
        return tp_rules.shard_tree(tree, self.score_specs, self.mesh)

    def _set_counters(self, ckpt: dict, finetune: bool) -> None:
        """epoch 1, itr 0 when `finetune`, else the checkpoint's epoch + 1
        and itr (an epoch boundary); the checkpoint's wall time."""
        if finetune:
            self.epoch, self.itr = 1, 0
        else:
            self.epoch = ckpt["epoch"] + 1
            self.itr = ckpt["itr"]
            self._itr_epoch_start = self.itr  # an epoch boundary
        self.time = ckpt["time"]

    def load_pretrain(self) -> None:
        """Load the frozen Compressor (parameters and BatchNorm statistics)
        from the stage-1 checkpoint `cfg.compressor.pretrain_path`, a port
        `.pt` or a JAX `.msgpack`."""
        path = getattr(self.cfg.compressor, "pretrain_path", None)
        if not path:
            raise ValueError(
                "stage-2 training bootstraps its frozen compressor from a "
                "stage-1 checkpoint: set compressor.pretrain_path in "
                "config.yaml (or pass --resume to continue a stage-2 run)")
        live = self.state_tree()["compressor"]
        state = load_checkpoint(path)["state"]["state"]
        loaded = {**state["params"], **(state["batch_stats"] or {})}
        self.compressor.load_state_dict(restore_into(live, loaded))
