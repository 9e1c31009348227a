"""Plain reference of LDT's stage-2 update, frozen here; imports nothing of
the program under test.

Per step: the global gradient norm |g| over all leaves; g <- g / |g| when
|g| >= clip; Adam (b1, b2, eps 1e-8, bias-corrected, no weight decay):
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p <- p - lr (m / (1 - b1^k)) / (sqrt(v / (1 - b2^k)) + eps); the EMA is set
to the parameters after the first step and then e <- d e + (1 - d) p. The
learning rate warms up linearly: lr_k = lr (k + 1) / warmup for k <
warmup.
"""

from __future__ import annotations

import torch


def warmup_lr(base: float, warmup: int, itr: int) -> float:
    return base * min(float(itr + 1) / max(warmup, 1), 1.0)


class Adam:
    def __init__(self, params: dict, b1: float, b2: float, clip: float,
                 ema_decay: float):
        self.b1, self.b2, self.clip, self.decay = b1, b2, clip, ema_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.ema = None
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> dict:
        """Update `params` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                              for g in grads.values())).float()
        factor = self.clip / norm if norm >= self.clip else 1.0
        clipped = {k: g * factor for k, g in grads.items()}
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for k, p in params.items():
            g = clipped[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + 1e-8)
            p.sub_(lr * u)
        if self.ema is None:
            self.ema = {k: p.detach().clone() for k, p in params.items()}
        else:
            for k, p in params.items():
                self.ema[k].mul_(self.decay).add_(p, alpha=1.0 - self.decay)
        return clipped
