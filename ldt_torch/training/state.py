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
device. `TrainState.to_tree` / `load_tree` give and take the checkpoint's
layout.

`make_optimizer(moment_dtype="bfloat16")` stores both moments in bf16, as
the JAX package's `scale_by_adam_q`: each moment is upcast, updated in f32,
and the update is computed from that f32 value before rounding; only the
stored copy is rounded (to nearest even). float32 keeps optax's
`scale_by_adam`.
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

    def to_tree(self) -> dict:
        """The state as plain dicts (the checkpoint's layout), holding the
        live tensors: {step, params, ema_params, opt_state: {count, mu,
        nu}, batch_stats}."""
        adam = self.opt_state
        return {"step": self.step, "params": self.params,
                "ema_params": self.ema_params,
                "opt_state": {"count": adam.count, "mu": adam.mu,
                              "nu": adam.nu},
                "batch_stats": self.batch_stats}

    @torch.no_grad()
    def load_tree(self, tree: dict, load_optim: bool = True) -> None:
        """Copy a tree of `to_tree`'s layout into the state's own tensors
        (so the module's parameters stay the state's); the optimizer state
        too when `load_optim`."""
        live = self.to_tree()
        pairs = [(live[k], tree[k])
                 for k in ("params", "ema_params", "batch_stats")]
        if load_optim:
            pairs += [(live["opt_state"][k], tree["opt_state"][k])
                      for k in ("mu", "nu")]
            self.opt_state.count = int(tree["opt_state"]["count"])
        for dst, src in pairs:
            for k, t in (dst or {}).items():
                t.copy_(src[k])
        self.step = int(tree["step"])


def _values(tree: Params, keys: List[str]) -> List[torch.Tensor]:
    return [tree[k] for k in keys]


MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


class Optimizer:
    """clip_by_global_norm(grad_clip) -> add_decayed_weights(weight_decay)
    -> scale_by_adam(b1, b2, eps=1e-8), as `make_optimizer` chains them in
    the JAX package, the moments stored in `moment_dtype` (bf16:
    `scale_by_adam_q`). `update` returns the Adam direction u; the caller
    applies p - lr * u (`apply_update`)."""

    eps = 1e-8

    def __init__(self, beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.0,
                 grad_clip: Optional[float] = 1.0,
                 moment_dtype: torch.dtype = torch.float32):
        self.b1, self.b2 = beta1, beta2
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.moment_dtype = moment_dtype

    def init(self, params: Params) -> AdamState:
        md = self.moment_dtype
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=md) for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=md) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState,
               params: Params) -> List[torch.Tensor]:
        """Advance `state` in place; returns the directions u in the order
        of `params`' keys. `grads` is consumed (clipped in place, and with
        bf16 moments scaled by 1 - b1)."""
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
        quantized = self.moment_dtype != torch.float32
        # the bf16 path rounds each product as optax does (wd p, then the
        # sum; b m + ((1 - b) g); b v + ((1 - b) g^2)), the f32 path keeps
        # its fused forms
        if self.weight_decay and quantized:
            torch._foreach_add_(g, torch._foreach_mul(
                _values(params, keys), self.weight_decay))
        elif self.weight_decay:
            torch._foreach_add_(g, _values(params, keys),
                                alpha=self.weight_decay)
        stored = _values(state.mu, keys), _values(state.nu, keys)
        state.count += 1
        # f32 b ** count; the bf16 path raises to the f32 count (powf, as
        # optax), the f32 path keeps its integer power (an f32 ulp off
        # optax's at some counts)
        count = (torch.tensor(float(state.count)) if quantized
                 else state.count)
        bc1, bc2 = (1.0 - torch.tensor(b, dtype=torch.float32) ** count
                    for b in (self.b1, self.b2))
        if quantized:
            # scale_by_adam_q: each moment upcast and updated in f32, the
            # update computed from the f32 values and only the stored copy
            # rounded; two f32 copies alive at a time (nu's and g^2, then
            # nu's and mu's; g is consumed)
            v_hat = [t.float() for t in stored[1]]
            torch._foreach_mul_(v_hat, self.b2)
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - self.b2)
            torch._foreach_add_(v_hat, g2)
            del g2
            torch._foreach_copy_(stored[1], v_hat)
            torch._foreach_div_(v_hat, bc2.to(dev))
            m_hat = [t.float() for t in stored[0]]
            torch._foreach_mul_(m_hat, self.b1)
            torch._foreach_mul_(g, 1.0 - self.b1)
            torch._foreach_add_(m_hat, g)
            torch._foreach_copy_(stored[0], m_hat)
            torch._foreach_div_(m_hat, bc1.to(dev))
        else:
            mu, nu = stored
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
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
    """The JAX package's `make_optimizer`: `moment_dtype` (`opt.moment_dtype`:
    "float32", "bfloat16" or "float16") is the Adam moments' storage;
    another name raises."""
    name = str(moment_dtype)
    if name not in MOMENT_DTYPES:
        raise ValueError(f"opt.moment_dtype={name!r}: expected one of "
                         f"{sorted(MOMENT_DTYPES)}")
    return Optimizer(beta1, beta2, weight_decay, grad_clip,
                     MOMENT_DTYPES[name])


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
