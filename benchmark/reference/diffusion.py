"""Plain reference of LDT's linear-beta VP-SDE: the stage-2 objective and
the 1000-step ancestral sampler, frozen here; imports nothing of the
program under test.

beta(t) = b0 + (b1 - b0) t; var(t) = 1 - exp(-b0 t - (b1 - b0) t^2 / 2);
the mean factor e2int(t) = exp(-b0 t / 2 - (b1 - b0) t^2 / 4). The
schedule is t_i = linspace(1, 1e-6, N); step i's discrete beta is
linspace(b0/N, b1/N, N)[int(t_i (N - 1))].
"""

from __future__ import annotations

import torch


class VPSDE:
    def __init__(self, beta_start: float, beta_end: float, steps: int,
                 time_eps: float, device):
        self.b0, self.b1, self.n = beta_start, beta_end, steps
        self.ts = torch.linspace(1.0, time_eps, steps, dtype=torch.float32)
        idx = (self.ts * (steps - 1)).to(torch.int32).long()
        betas = torch.linspace(beta_start / steps, beta_end / steps, steps,
                               dtype=torch.float32)[idx]
        self.ts = self.ts.to(device)
        self.betas = betas.to(device)

    def var(self, t):
        return 1.0 - torch.exp(-self.b0 * t
                               - 0.5 * (self.b1 - self.b0) * t * t)

    def e2int(self, t):
        return torch.exp(-0.5 * self.b0 * t
                         - 0.25 * (self.b1 - self.b0) * t * t)

    def std(self, t):
        return torch.sqrt(self.var(t))


def train_loss(score, sde: VPSDE, latents, t_idx, eta, label=None):
    """mean((eta - score(x_t, t))^2), x_t = e2int(t) latents + std(t) eta,
    t the schedule's times at the indices `t_idx` [B]."""
    t = sde.ts[t_idx]
    x_t = (latents * sde.e2int(t)[:, None, None]
           + torch.sqrt(sde.var(t))[:, None, None] * eta)
    return torch.mean((eta - score(x_t, t, label)) ** 2)


@torch.no_grad()
def ancestral_sample(score, sde: VPSDE, x0, noise, label=None):
    """Latents from x0 [B, ...] through the N ancestral steps:
    x_mean = (x + beta_i s) / sqrt(1 - beta_i), s = -eps_hat / std(t_i);
    x = x_mean + sqrt(beta_i) noise[i]; the last step's x_mean returned."""
    x = x0.float()
    x_mean = x
    b = x.shape[0]
    for i in range(sde.n):
        t = sde.ts[i].expand(b)
        s = -score(x, t, label).float() / sde.std(t)[:, None, None]
        beta = sde.betas[i]
        x_mean = (x + beta * s) / torch.sqrt(1.0 - beta)
        x = x_mean + torch.sqrt(beta) * noise[i].float()
    return x_mean
