"""Noise -> 2048-point clouds: the generation path of `bench.py::generate`.

1000-step (or `steps`) ancestral reverse diffusion of [B, 32, 120] latents
with the DiT, its AdaLN modulations precomputed for the whole schedule, then
the set-VAE decode to [B, outsize, 3] (2048 points). The sampler state stays f32; the
networks run in their own dtype (bf16 in serving), and the score is
-eps.float() / std(t).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ldt_torch import resolve_device
from ldt_torch.diffusion.sampling import sample_discrete, timesteps

# The schedule's last time, linspace(1, TIME_EPS, steps) (bench.py).
TIME_EPS = 1e-6


@torch.inference_mode()
def generate(score, compressor, sde, batch: int, steps: int, *,
             device="cuda", generator: Optional[torch.Generator] = None,
             x0: Optional[torch.Tensor] = None,
             noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Generate `batch` clouds [batch, compressor.cfg.outsize, 3].

    `x0` and `noise` pin the sampler's draws (see `sample_discrete`); the
    rest come from `generator`.
    """
    eps = sample_latents(score, sde, batch, steps, device=device,
                         generator=generator, x0=x0, noise=noise)
    return compressor.sample((batch, compressor.cfg.outsize), eps)


@torch.inference_mode()
def sample_latents(score, sde, batch: int, steps: int, *, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   x0: Optional[torch.Tensor] = None,
                   noise: Optional[Sequence[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """The reverse diffusion alone: [batch, z_scale, z_dim] f32 latents."""
    dev = resolve_device(device)
    cfg = score.cfg
    mods = score.precompute_mods(timesteps(steps, TIME_EPS).to(dev))

    def score_fn(t, x, step):
        p = score.denoise_with_mods(
            x, {"blocks": mods["blocks"][step], "final": mods["final"][step]})
        std = sde.std(t)[:, None, None]
        return -p.float() / std, p

    return sample_discrete(sde, score_fn, batch, (cfg.z_scale, cfg.z_dim),
                           steps, TIME_EPS, device=dev, generator=generator,
                           x0=x0, noise=noise)
