"""Reverse-diffusion sampling, counterpart of `ldt_tpu/diffusion/sampling.py`.

`sample_discrete` is the predictor-corrector sampler: a Python loop over the
N steps of the schedule linspace(1, time_eps, N), each calling
`score_fn(t [B], x, step) -> (score, eps_prediction)` once per predictor and
once per corrector step. Predictors: `ancestral` (the generation path),
`reversediffusion`, `ddim`, `eulermaruyama`; correctors: `langevin`,
`ancestral`. JAX's random draws cannot be reproduced in PyTorch, so every
draw may be passed in (`x0`, `noise`, `corrector_noise`); otherwise it is
drawn from `generator`. PNDM, the adaptive ODE sampler and `print_steps`
are later work.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ldt_torch import resolve_device

ScoreFn = Callable[[torch.Tensor, torch.Tensor, int],
                   Tuple[torch.Tensor, torch.Tensor]]

PREDICTORS = ("reversediffusion", "ancestral", "ddim", "eulermaruyama")
CORRECTORS = ("langevin", "ancestral")


def timesteps(N: int, time_eps: float) -> torch.Tensor:
    """The schedule linspace(1, time_eps, N) in f32, on the CPU."""
    return torch.linspace(1.0, time_eps, N, dtype=torch.float32)


def ancestral_indices(ts: torch.Tensor, N: int) -> torch.Tensor:
    """The beta index of each step: int(t * (N - 1) / T), truncated, f32."""
    return (ts * (N - 1) / 1.0).to(torch.int32).long()


def sample_discrete(sde, score_fn: ScoreFn, num_samples: int,
                    shape: Tuple[int, ...], N: int, time_eps: float = 1e-6,
                    *, predictor: Optional[str] = "ancestral",
                    corrector: Optional[str] = None,
                    corrector_steps: int = 1, probability_flow: bool = False,
                    denoise: bool = True, snr: float = 0.01, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    x0: Optional[torch.Tensor] = None,
                    noise: Optional[Sequence[torch.Tensor]] = None,
                    corrector_noise: Optional[Sequence[Sequence[
                        torch.Tensor]]] = None) -> torch.Tensor:
    """Reverse-SDE predictor-corrector sampling: [num_samples, *shape] f32,
    the noise-free mean of the last step with `denoise`, else the sample.

    Pinned draws: `x0` the initial sample, `noise[i]` the predictor's draw
    at step i (`ddim` draws none), `corrector_noise[i][j]` corrector step
    j's draw at step i; every draw not pinned is N(0, 1) from `generator`.
    """
    if predictor is not None and predictor not in PREDICTORS:
        raise NotImplementedError(f"predictor not implemented: {predictor}")
    if corrector is not None and corrector not in CORRECTORS:
        raise NotImplementedError(f"corrector not implemented: {corrector}")
    if getattr(sde, "N", None) != N:
        raise ValueError(f"the SDE's discrete tables have "
                         f"{getattr(sde, 'N', None)} steps, the sampler {N}")
    dev = resolve_device(device)
    full_shape = (num_samples,) + tuple(shape)

    def draw(pinned):
        if pinned is None:
            return torch.randn(full_shape, generator=generator, device=dev)
        return pinned.to(device=dev, dtype=torch.float32)

    def per_sample(v):  # [B] -> broadcastable against x
        return v.reshape((num_samples,) + (1,) * len(shape))

    x = draw(x0)
    ts = timesteps(N, time_eps)
    idx = ancestral_indices(ts, N).to(dev)
    betas = sde.betas.to(dev)[idx]
    alphas_cump = sde.alphas_cump.to(dev)
    # at_next: alphas_cump[idx - 1], or 1 at idx 0
    at_next = torch.cat([torch.ones(1, device=dev), alphas_cump])[idx]
    # the correctors' discrete alpha: 1 - the beta table (`discrete_alpha`)
    alphas = 1.0 - betas
    ts = ts.to(dev)
    pf_scale = 0.5 if probability_flow else 1.0

    def reverse_diffusion(x, i, z):
        t = ts[i].expand(num_samples)
        dt = (1 - time_eps) / N
        f = per_sample(sde.f(t)) * x
        g2 = per_sample(sde.g2(t))
        score, _ = score_fn(t, x, i)
        dx = (f - g2 * score * pf_scale) * dt
        g = torch.zeros_like(g2) if probability_flow else torch.sqrt(g2)
        x_mean = x - dx
        return x_mean + g * z() * dt ** 0.5, x_mean

    sqrt_1mb = torch.sqrt(1.0 - betas)
    sqrt_b = torch.sqrt(betas)

    def ancestral(x, i, z):
        score, _ = score_fn(ts[i].expand(num_samples), x, i)
        x_mean = (x + betas[i] * score) / sqrt_1mb[i]
        return x_mean + sqrt_b[i] * z(), x_mean

    def ddim(x, i, z):
        at, atn = alphas_cump[idx[i]], at_next[i]
        _, params = score_fn(ts[i].expand(num_samples), x, i)
        params = params.float()
        x_mean = (torch.sqrt(atn) * (x - torch.sqrt(1 - at) * params)
                  / torch.sqrt(at) + torch.sqrt(1 - atn) * params)
        return x_mean, x_mean

    def euler_maruyama(x, i, z):
        t = ts[i].expand(num_samples)
        dt = -1.0 / N
        f = per_sample(sde.f(t)) * x
        g2 = per_sample(sde.g2(t))
        score, _ = score_fn(t, x, i)
        f = f - g2 * score * pf_scale
        x_mean = x + f * dt
        g2 = torch.zeros_like(g2) if probability_flow else g2
        return x_mean + torch.sqrt(g2) * (-dt) ** 0.5 * z(), x_mean

    def langevin(x, i, zs):
        x_mean = x
        for j in range(corrector_steps):
            grad, _ = score_fn(ts[i].expand(num_samples), x, i)
            z = zs(j)
            grad_norm = grad.reshape(num_samples, -1).norm(dim=-1).mean()
            noise_norm = z.reshape(num_samples, -1).norm(dim=-1).mean()
            step_size = (snr * noise_norm / grad_norm) ** 2 * 2 * alphas[i]
            x_mean = x + step_size * grad
            x = x_mean + torch.sqrt(step_size * 2) * z
        return x, x_mean

    def ancestral_corrector(x, i, zs):
        std = sde.std(ts[i])
        x_mean = x
        for j in range(corrector_steps):
            grad, _ = score_fn(ts[i].expand(num_samples), x, i)
            z = zs(j)
            step_size = (snr * std) ** 2 * 2 * alphas[i]
            x_mean = x + step_size * grad
            x = x_mean + z * torch.sqrt(step_size * 2)
        return x, x_mean

    pred_fn = {"reversediffusion": reverse_diffusion, "ancestral": ancestral,
               "ddim": ddim, "eulermaruyama": euler_maruyama}.get(predictor)
    corr_fn = {"langevin": langevin,
               "ancestral": ancestral_corrector}.get(corrector)
    x_mean = x
    for i in range(N):
        x_mean = x
        if pred_fn is not None:
            x, x_mean = pred_fn(
                x, i, lambda: draw(None if noise is None else noise[i]))
        if corr_fn is not None:
            x, x_mean = corr_fn(x, i, lambda j: draw(
                None if corrector_noise is None else corrector_noise[i][j]))
    return x_mean if denoise else x
