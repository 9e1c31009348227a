"""Train state, optimizer, LR schedule and EMA, counterpart of
`ldt_tpu/training/state.py`.

The optimizer is written to optax's formulas, which the JAX package trains
with (`clip_by_global_norm` -> `add_decayed_weights` -> `scale_by_adam`),
not to `torch.optim.Adam` and `clip_grad_norm_`, which differ:

  * clip: g * (max / |g|) only when |g| >= max, with no +1e-6 in the norm;
  * weight decay (L2): g + wd * p after the clip, before the moments;
  * Adam: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v, the bias
    corrections bc = 1 - b^count in f32 and u = (m / bc1) / (sqrt(v / bc2)
    + 1e-8); then p <- p - lr * u;
  * EMA: e <- e * decay + p * (1 - decay), seeded with the post-step params
    at step 0.

Parameters, moments, EMA and BatchNorm statistics are dicts of tensors
(name -> tensor: the module's `named_parameters()` and, for the Compressor,
its running-statistic buffers), updated in place with `torch._foreach_*`
ops, where the JAX package builds new trees: one copy of each lives on the
device. The bf16-moment option (`scale_by_adam_q`) is later work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

Params = Dict[str, torch.Tensor]


@dataclass
class AdamState:
    """optax `ScaleByAdamState`: the update count and both moments."""
    count: int
    mu: Params
    nu: Params


@dataclass
class TrainState:
    """(step, params, ema_params, opt_state, batch_stats). `params` and
    `batch_stats` hold the trained module's parameters and running
    statistics themselves (updated in place)."""
    step: int
    params: Params
    ema_params: Optional[Params]
    opt_state: AdamState
    batch_stats: Optional[Params] = None

    @classmethod
    def create(cls, params: Params, tx: "Optimizer",
               batch_stats: Optional[Params] = None,
               ema: bool = True) -> "TrainState":
        ema_params = ({k: p.detach().clone() for k, p in params.items()}
                      if ema else None)
        return cls(step=0, params=dict(params), ema_params=ema_params,
                   opt_state=tx.init(params),
                   batch_stats=None if batch_stats is None
                   else dict(batch_stats))


def _values(tree: Params, keys: List[str]) -> List[torch.Tensor]:
    return [tree[k] for k in keys]


class Optimizer:
    """clip_by_global_norm(grad_clip) -> add_decayed_weights(weight_decay)
    -> scale_by_adam(b1, b2, eps=1e-8), as `make_optimizer` chains them in
    the JAX package. `update` returns the Adam direction u; the caller
    applies p - lr * u (`apply_update`)."""

    eps = 1e-8

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.0,
                 grad_clip: Optional[float] = 1.0):
        self.b1, self.b2 = beta1, beta2
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: Params) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState,
               params: Params) -> List[torch.Tensor]:
        """Advance `state` in place; returns the directions u in the order
        of `params`' keys. `grads` is consumed (clipped in place)."""
        keys = list(params)
        g = _values(grads, keys)
        dev = g[0].device
        if self.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(g)))
            keep = norm < self.grad_clip
            one = torch.ones((), device=dev)
            # optax: select(norm < max, g, (g / norm) * max)
            torch._foreach_div_(g, torch.where(keep, one, norm))
            if self.grad_clip != 1.0:
                torch._foreach_mul_(g, torch.where(
                    keep, one, torch.full((), self.grad_clip, device=dev)))
        if self.weight_decay:
            torch._foreach_add_(g, _values(params, keys),
                                alpha=self.weight_decay)
        mu, nu = _values(state.mu, keys), _values(state.nu, keys)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        state.count += 1
        bc1, bc2 = (1.0 - torch.tensor(b, dtype=torch.float32) ** state.count
                    for b in (self.b1, self.b2))
        m_hat = torch._foreach_div(mu, bc1.to(dev))
        v_hat = torch._foreach_div(nu, bc2.to(dev))
        torch._foreach_sqrt_(v_hat)
        torch._foreach_add_(v_hat, self.eps)
        torch._foreach_div_(m_hat, v_hat)
        return m_hat


def make_optimizer(beta1: float = 0.9, beta2: float = 0.999,
                   weight_decay: float = 0.0,
                   grad_clip: Optional[float] = 1.0,
                   moment_dtype: str = "float32") -> Optimizer:
    """The JAX package's `make_optimizer` with f32 moments; its bf16
    moments (`moment_dtype="bfloat16"`, `scale_by_adam_q`) are not ported
    and raise."""
    if str(moment_dtype) != "float32":
        raise NotImplementedError(
            f"Adam moments in {moment_dtype} (opt.moment_dtype) are not "
            "ported yet: only float32")
    return Optimizer(beta1, beta2, weight_decay, grad_clip)


@torch.no_grad()
def apply_update(state: TrainState, grads: Params, tx: Optimizer, lr: float,
                 ema_decay: float = 0.0,
                 new_batch_stats: Optional[Params] = None) -> TrainState:
    """One optimizer step and the EMA, in place; `new_batch_stats` (a
    train-mode forward's running statistics) replace the state's when
    given. Returns `state`."""
    keys = list(state.params)
    u = tx.update(grads, state.opt_state, state.params)
    torch._foreach_mul_(u, lr)
    params = _values(state.params, keys)
    torch._foreach_sub_(params, u)
    if state.ema_params is not None:
        ema = _values(state.ema_params, keys)
        if state.step == 0 or ema_decay <= 0:
            # seeded with the post-step params (the reference's first
            # step); with decay 0 it trails them exactly
            torch._foreach_copy_(ema, params)
        else:
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, params, alpha=1.0 - ema_decay)
    if new_batch_stats is not None:
        stats = list(state.batch_stats)
        torch._foreach_copy_(_values(state.batch_stats, stats),
                             _values(new_batch_stats, stats))
    state.step += 1
    return state


def make_lr_fn(base_lr: float, warmup_iters: int, epochs: int):
    """lr(itr, epoch, itr_epoch_start): linear warm-up per iteration, then
    cosine annealing per epoch, engaged only from the first epoch that
    starts after the warm-up (`itr_epoch_start` > warmup_iters; None =
    engaged), as `ldt_tpu.training.state.make_lr_fn`."""

    def lr_fn(itr: int, epoch: int,
              itr_epoch_start: Optional[int] = None) -> float:
        if itr < warmup_iters:
            return base_lr * min(float(itr + 1) / max(warmup_iters, 1), 1.0)
        if itr_epoch_start is not None and itr_epoch_start <= warmup_iters:
            return base_lr
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / epochs))

    return lr_fn
