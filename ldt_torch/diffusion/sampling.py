"""Reverse-diffusion sampling, counterpart of `ldt_tpu/diffusion/sampling.py`.

`sample_discrete` (ancestral predictor, denoise=True) is the generation path: a
Python loop over the N steps of the schedule linspace(1, time_eps, N), each
calling `score_fn(t [B], x, step) -> (score, eps_prediction)` once. JAX's
random draws cannot be reproduced in PyTorch, so the initial sample `x0` and
each step's noise may be passed in; otherwise they are drawn from
`generator`. The other predictors, the correctors, PNDM and the ODE sampler
are later work.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ldt_torch import resolve_device

ScoreFn = Callable[[torch.Tensor, torch.Tensor, int],
                   Tuple[torch.Tensor, torch.Tensor]]


def timesteps(N: int, time_eps: float) -> torch.Tensor:
    """The schedule linspace(1, time_eps, N) in f32, on the CPU."""
    return torch.linspace(1.0, time_eps, N, dtype=torch.float32)


def ancestral_indices(ts: torch.Tensor, N: int) -> torch.Tensor:
    """The beta index of each step: int(t * (N - 1) / T), truncated, f32."""
    return (ts * (N - 1) / 1.0).to(torch.int32).long()


def sample_discrete(sde, score_fn: ScoreFn, num_samples: int,
                    shape: Tuple[int, ...], N: int, time_eps: float = 1e-6,
                    *, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    x0: Optional[torch.Tensor] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Ancestral reverse-SDE sampling (no corrector), returning the
    noise-free mean of the last step (`denoise=True`): [num_samples, *shape]
    f32.

    x0: the initial sample (else N(0, 1) from `generator`); noise: step i's
    draw is `noise[i]` (else N(0, 1) from `generator`).
    """
    if getattr(sde, "N", None) != N:
        raise ValueError(f"the SDE's discrete tables have "
                         f"{getattr(sde, 'N', None)} steps, the sampler {N}")
    dev = resolve_device(device)
    full_shape = (num_samples,) + tuple(shape)
    if x0 is None:
        x = torch.randn(full_shape, generator=generator, device=dev)
    else:
        x = x0.to(device=dev, dtype=torch.float32)
    ts = timesteps(N, time_eps)
    betas = sde.betas.to(dev)[ancestral_indices(ts, N).to(dev)]
    sqrt_1mb = torch.sqrt(1.0 - betas)
    sqrt_b = torch.sqrt(betas)
    ts = ts.to(dev)
    x_mean = x
    for i in range(N):
        t = ts[i].expand(num_samples)
        score, _ = score_fn(t, x, i)
        x_mean = (x + betas[i] * score) / sqrt_1mb[i]
        if noise is None:
            z = torch.randn(full_shape, generator=generator, device=dev)
        else:
            z = noise[i].to(dev)
        x = x_mean + sqrt_b[i] * z
    return x_mean
