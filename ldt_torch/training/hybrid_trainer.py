"""Stage-3 trainer: the joint (Hybrid) finetune of the Compressor and the
Score, counterpart of `ldt_tpu/training/hybrid_trainer.py`.

One `update(batch)`:
  1. the Compressor's train-mode forward on the [B, N, 3] clouds (K2 in
     every attention; its BatchNorms on the batch's statistics) gives the
     reconstruction, the posterior sample eps [B, z_scale, z_dim] and
     log q(z) per layer;
  2. t drawn as `opt.discrete` says (discrete: an index into the
     schedule, weight g2 / (2 var); continuous: the SDE's `iw_quantities`
     in `sde.iw_sample_q_mode`), eta ~ N(0, 1), xt = eps e2int + sqrt(var)
     eta; the Score (K1 forward) predicts eta from xt with its parameters
     held fixed: log p(z) = -(|eta - pred|^2 weight + ce_const),
     ce_const = `cross_entropy_const(sde.time_eps)`;
  3. comp_loss = CD + EMD + alpha mean(log q - log p) (alpha / 10 while
     `epoch < opt.compressor_warmup`), its backward (K3 to the Score's
     input only, then K4 through the Compressor), the Compressor's own Adam
     (`opt.compressor_beta1/2`, the Score's clip, weight decay and moment
     dtype, no EMA) and the forward's BatchNorm statistics;
  4. the stage-2 score step on that eps, detached (K1, K3), with discrete
     t whatever `opt.discrete` says, the Score's dropout (`score.dropout`),
     and the Score's Adam and EMA.
Both nets compute in the trainer's dtype (`common.train_dtype`), their
parameters, moments and gradients f32, and both optimizers store their
moments in `opt.moment_dtype`. The KL term's Score forward is
deterministic (no dropout).
The KL term reads the Score's parameters before this step's score update,
and the score step trains on the KL step's eps, not on a fresh encode.

The Score is held fixed in the KL term by turning off `requires_grad` on
its parameters for that forward (`frozen`): autograd records no use of
them, K1's and K3's `autograd.Function` return the gradient of the packed
qkv only, and every Score `.grad` stays None, so no gradient of the KL term
can join the score step's Adam update (the reference computes it and
discards it with `zero_grad`).

Every draw can be pinned: `update(..., noise=, kl_t_idx=, kl_rho=, kl_eta=,
t_idx=, eta=, dropout=)` (the reparameterization noise in decode order; the
KL term's discrete index or continuous uniform draw and its eta; the score
step's index, eta and dropout masks). `valrecon` encode-decodes the test
split with the Compressor (the reference calls the Score there, which the JAX package
documents as a fault of the reference). `save` writes {"score",
"compressor_state"} (the moments in bf16, on a thread), `resume` restores
both train states from a `.pt` or a JAX `.msgpack`, and `load_pretrain`
bootstraps from a stage-2 dual checkpoint of either package; both record the
file as `restored_ckpt`, whose int8 gate stamp and static scales `sample`
reads when it serves int8 (the stage-2 trainer's serving branch).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ldt_torch.eval.loss import CD_loss, EMD_loss
from ldt_torch.training.base import to_numpy
from ldt_torch.training.checkpoint import load_checkpoint, restore_into
from ldt_torch.training.latent_sde_trainer import Trainer as LatentTrainer
from ldt_torch.training.latent_sde_trainer import draw_train_randoms
from ldt_torch.training.state import TrainState, apply_update, make_optimizer


@contextlib.contextmanager
def frozen(module: torch.nn.Module):
    """`module`'s parameters require no gradient inside; their flags are
    restored on exit."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield module
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def hybrid_comp_loss(compressor, score, pts: torch.Tensor,
                     label: Optional[torch.Tensor], t: torch.Tensor, var,
                     e2int, weight_q, ce_const, eta: torch.Tensor,
                     alpha: float, *,
                     noise: Optional[Sequence[torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None,
                     rec_fn: Optional[Callable] = None,
                     seed_draw: Optional[torch.Tensor] = None):
    """(comp_loss, (kl, rec, eps, batch_stats)) of the joint Compressor
    loss: comp_loss = rec + alpha kl, rec = CD + EMD of the reconstruction
    against `pts` (or `rec_fn(set, pts)`), kl = mean(log q(z) - log p(z)),
    log p(z) = -(|eta - score(xt, t, label)|^2 weight_q + ce_const), xt =
    eps e2int + sqrt(var) eta; the Score's parameters are held fixed
    (`frozen`). `noise` pins the reparameterization draws (decode order);
    batch_stats are the train-mode forward's running statistics."""
    out = compressor(pts, noise=noise, generator=generator, train=True,
                     label=label, seed_draw=seed_draw)
    logqz = torch.cat(out["all_logqz"], dim=-1)
    eps = out["all_eps"]
    xt = eps * e2int + torch.sqrt(var) * eta
    with frozen(score):
        pred = score(xt, t, label)
    logpz = -(torch.square(eta - pred) * weight_q + ce_const)
    kl_loss = torch.mean(logqz - logpz)
    recon = out["set"]
    if rec_fn is None:
        rec_loss = CD_loss(recon, pts) + EMD_loss(recon, pts)
    else:
        rec_loss = rec_fn(recon, pts)
    return rec_loss + kl_loss * alpha, (kl_loss, rec_loss, eps,
                                        out["batch_stats"])


class Trainer(LatentTrainer):
    """Stage-3 trainer. `cfg` has the sections of
    `configs.hybrid_trainer_cfg()`; `device` and `generator` as the
    stage-2 trainer's, and so is `dtype`."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, mesh=None):
        super().__init__(cfg, device=device, generator=generator,
                         dtype=dtype, mesh=mesh)
        self.alpha = cfg.opt.alpha
        self.compressor_warmup = cfg.opt.compressor_warmup
        self.comp_tx = make_optimizer(
            cfg.opt.compressor_beta1, cfg.opt.compressor_beta2,
            cfg.opt.weight_decay, cfg.opt.grad_norm_clip_value,
            getattr(cfg.opt, "moment_dtype", "float32"))
        self.comp_state: Optional[TrainState] = None
        # the KL term draws t as opt.discrete says; the score step always
        # draws discrete t (the reference's update_score has no other)
        self.kl_discrete = cfg.opt.discrete
        self.discrete = True
        self.ce_const = self.sde.cross_entropy_const(cfg.sde.time_eps)

    def _new_comp_state(self) -> None:
        self.comp_state = TrainState.create(
            dict(self.compressor.named_parameters()), self.comp_tx,
            batch_stats=dict(self.compressor.named_buffers()), ema=False)

    def maybe_init(self, batch, score_weights=None,
                   compressor_weights=None) -> None:
        """The stage-2 trainer's nets (the same arguments), then the
        Compressor made trainable with its own train state."""
        super().maybe_init(batch, score_weights, compressor_weights)
        if self.comp_state is None:
            self.compressor.requires_grad_(True)
            self._new_comp_state()

    def kl_draws(self, size: int, t_idx: Optional[torch.Tensor] = None,
                 rho: Optional[torch.Tensor] = None,
                 eta: Optional[torch.Tensor] = None):
        """The KL term's (t [B], var, e2int, weight_q [B, 1, 1], eta
        [B, z_scale, z_dim]): `draw_train_randoms` with t as
        `opt.discrete` says, continuous in `sde.iw_sample_q_mode`, and a
        discrete t weighted g2 / (2 var); `t_idx`, `rho` and `eta` pin the
        draws."""
        cfg = self.cfg
        t, var, e2int, weight, eta = draw_train_randoms(
            (size, cfg.score.z_scale, cfg.score.z_dim),
            discrete=self.kl_discrete, timesteps=self.timesteps,
            train_N=self.N, sde=self.sde, time_eps=self.time_eps,
            iw_mode=cfg.sde.iw_sample_q_mode, subvp_like=self.subvp_like,
            generator=self.generator, t_idx=t_idx, rho=rho, eta=eta)
        if self.kl_discrete:
            weight = self.sde.g2(t)[:, None, None] / (2 * var)
        return t, var, e2int, weight, eta

    def update(self, data, *, noise: Optional[Sequence[torch.Tensor]] = None,
               kl_t_idx: Optional[torch.Tensor] = None,
               kl_rho: Optional[torch.Tensor] = None,
               kl_eta: Optional[torch.Tensor] = None,
               t_idx: Optional[torch.Tensor] = None,
               eta: Optional[torch.Tensor] = None, dropout=None):
        """One joint step on `data['tr_points']` [B, N, 3] (and, with
        several categories, the labels `data['cate_idx']`); returns
        (loss_score, kl, rec), 0-d tensors on the device."""
        self.maybe_init(data)
        pts = self._points(data["tr_points"])
        label = self._label_of(data)
        lr = self.current_lr()
        alpha = (self.alpha / 10.0 if self.epoch < self.compressor_warmup
                 else self.alpha)
        batch = pts.shape[0]
        t, var, e2int, weight, kl_eta = self.local(self.kl_draws(
            batch, kl_t_idx, kl_rho, kl_eta))
        seed = None
        if self.data_size() > 1:  # the forward's draws at the global batch
            if noise is None:
                noise, seed = self.decode_draws(self.compressor, batch,
                                                self.dtype)
            else:
                noise = self.local(list(noise))
            pts, label = self.local(pts), self.local(label)
        self.compressor.zero_grad(set_to_none=True)
        with self.stats_scope():
            loss, (kl, rec, eps, new_bs) = hybrid_comp_loss(
                self.compressor, self.score, pts, label, t, var, e2int,
                weight, self.ce_const, kl_eta, alpha, noise=noise,
                generator=self.generator, seed_draw=seed)
        loss.backward()
        self.sync_grads(self.comp_state.params)
        grads = {k: p.grad for k, p in self.comp_state.params.items()}
        apply_update(self.comp_state, grads, self.comp_tx, lr, ema_decay=0.0,
                     new_batch_stats=new_bs)
        loss_score = self.train_step(eps.detach(), lr, t_idx, eta, label,
                                     dropout=dropout, batch=batch)
        self.itr += 1
        return (loss_score, self.global_mean(kl.detach()),
                self.global_mean(rec.detach()))

    @torch.no_grad()
    def reconstruct(self, pts: torch.Tensor,
                    label: Optional[torch.Tensor] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
        """The Compressor's encode-decode of clouds [B, N, 3] (its running
        statistics)."""
        return self.compressor(pts, noise=noise, generator=self.generator,
                               label=label)["set"]

    def valrecon(self, test_loader, val_cate: int = 0, **_):
        """Encode-decode the test split with the Compressor (with several
        categories the clouds of `val_cate`, with their labels, in chunks of
        `data.test_batch_size`), denormalize with `* scale + shift`, save
        `rec_ep<epoch>.npy` and score: {'val/gen/<metric>'} of
        `compute_all_metrics(rec, ref, batch_size=256)`."""
        all_ref, all_rec = [], []
        if self.cfg.data.num_categorys == 1:
            for data in test_loader:
                ref_pts = self._points(data["te_points"])
                rec_pts = self.reconstruct(ref_pts)
                shift = self._points(data["shift"])
                scale = self._points(data["scale"])
                all_ref.append((ref_pts * scale + shift).cpu().numpy())
                all_rec.append((rec_pts * scale + shift).cpu().numpy())
        else:
            parts = {k: [] for k in ("te_points", "shift", "scale",
                                     "cate_idx")}
            for data in test_loader:
                idx = to_numpy(data["cate_idx"]) == val_cate
                if idx.any():
                    for k in parts:
                        parts[k].append(to_numpy(data[k])[idx])
            pts, shift, scale, label = (np.concatenate(parts[k])
                                        for k in parts)
            bsize = self.cfg.data.test_batch_size
            rec_n = np.concatenate([
                self.reconstruct(
                    self._points(pts[i:i + bsize]),
                    torch.as_tensor(label[i:i + bsize]).to(
                        self.device, torch.long)).cpu().numpy()
                for i in range(0, pts.shape[0], bsize)])
            all_rec = [rec_n * scale + shift]
            all_ref = [pts * scale + shift]
        rec = np.concatenate(all_rec)
        ref = np.concatenate(all_ref)
        self.save_npy(f"rec_ep{self.epoch}.npy", rec)
        return self.eval_metrics(rec, ref, 256)

    def state_tree(self, full: bool = False) -> dict:
        """The checkpoint's state: {"score": the Score's TrainState tree,
        "compressor_state": the Compressor's}, live tensors; with `full`
        under a model axis the Score's tree gathered to full tensors."""
        if self.comp_state is None:
            raise RuntimeError("the hybrid Trainer needs its nets: call "
                               "maybe_init(first_batch) first")
        score = super().state_tree(full)["score"]
        return {"score": score,
                "compressor_state": self.comp_state.to_tree()}

    def resume(self, epoch: Optional[int] = None, strict: bool = False,
               load_optim: bool = True, finetune: bool = False,
               pretrain: Optional[str] = None) -> None:
        """Restore both train states, optimizers included (the JAX
        package's hybrid resume takes no `load_optim`), from the checkpoint
        file `pretrain` or that of `epoch` under `cfg.log.save_path`
        (default: the last one); the counters as the stage-2 trainer's."""
        ckpt, restored = self._restored(epoch, strict, pretrain)
        self.state.load_tree(self.local_score_tree(restored["score"]))
        self.comp_state.load_tree(restored["compressor_state"])
        self._set_counters(ckpt, finetune)

    def load_pretrain(self) -> None:
        """Bootstrap from the stage-2 dual checkpoint `opt.pretrain_path`
        (a port `.pt` or a JAX `.msgpack`): the Score's whole train state,
        and the Compressor's weights and statistics with a fresh train
        state."""
        path = getattr(self.cfg.opt, "pretrain_path", None)
        if not path:
            raise ValueError(
                "hybrid finetune bootstraps from a stage-2 dual checkpoint: "
                "set opt.pretrain_path in config.yaml (or pass --resume to "
                "continue this run)")
        state = load_checkpoint(path)["state"]
        if "score" not in state:
            raise ValueError(
                f"{path}: not a stage-2 DUAL checkpoint (top-level keys "
                f"{sorted(state)}); hybrid finetune needs the "
                "score+compressor checkpoint written by stage-2 training, "
                "not a stage-1 compressor one")
        self.state.load_tree(self.local_score_tree(restore_into(
            self.state_tree(full=True)["score"], state["score"])))
        self._restore_recorded(path)
        comp = state.get("compressor")
        if comp is not None:
            self.compressor.load_state_dict(restore_into(
                dict(self.compressor.state_dict()), comp))
            self._new_comp_state()
