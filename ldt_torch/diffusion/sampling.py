"""Reverse-diffusion sampling, counterpart of `ldt_tpu/diffusion/sampling.py`.

`sample_discrete` is the predictor-corrector sampler: a Python loop over the
N steps of the schedule linspace(1, time_eps, N), each calling
`score_fn(t [B], x, step) -> (score, eps_prediction)` once per predictor and
once per corrector step. Predictors: `ancestral` (the generation path),
`reversediffusion`, `ddim`, `eulermaruyama`; correctors: `langevin`,
`ancestral`. JAX's random draws cannot be reproduced in PyTorch, so every
draw may be passed in (`x0`, `noise`, `corrector_noise`); otherwise it is
drawn from `generator`. Every family of `sde.make_diffusion` samples: the
VESDE starts from N(0, sigma2_max), the correctors' discrete alpha is
1 - linspace(beta_start / N, beta_end / N, N) at the step's beta index for
the VP and sub-VP SDEs and 1 otherwise; `ancestral` and `ddim` read the
VPSDE's discrete tables and raise for another family. `print_steps`
returns the trajectory's snapshots stacked.

`pndm` (the pseudo-numerical sampler: three Runge-Kutta steps of four
evaluations, then 4th-order Adams-Bashforth over a 4-slot ring, N + 9
evaluations) takes its own tables from the VPSDE's `train_N` and betas and
draws nothing after `x0`. `sample_model_ode` integrates the probability-flow
ODE with an adaptive Dormand-Prince RK45 from t=1 to `ode_eps`: a loop on
the host whose t, step and step factor are f32 tensors on the device, as
the JAX package's `lax.while_loop`; it reads t once a step (one
synchronisation) and evaluates all seven stages every step (no FSAL).
PNDM passes the enclosing step's index though it evaluates between the
steps' times, the ODE passes `step=None`: a score_fn that gathers per-step
quantities (the hoisted modulations) serves neither.

Each step of `sample_discrete`'s loop is a `sample.step` span
(`tools.profiling`) of its index.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ldt_torch import resolve_device
from ldt_torch.tools import profiling

ScoreFn = Callable[[torch.Tensor, torch.Tensor, int],
                   Tuple[torch.Tensor, torch.Tensor]]

PREDICTORS = ("reversediffusion", "ancestral", "ddim", "eulermaruyama",
              "pndm")
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
                        torch.Tensor]]] = None,
                    print_steps: Optional[int] = None) -> torch.Tensor:
    """Reverse-SDE predictor-corrector sampling: [num_samples, *shape] f32,
    the noise-free mean of the last step with `denoise`, else the sample.

    Pinned draws: `x0` the initial draw (N(0, 1); the VESDE scales it by
    sqrt(sigma2_max), except under `pndm`), `noise[i]` the predictor's draw
    at step i (`ddim` and `pndm` draw none), `corrector_noise[i][j]`
    corrector step j's draw at step i; every draw not pinned is N(0, 1)
    from `generator`. `pndm` runs no corrector.

    `print_steps`: return [K, num_samples, *shape] instead, the initial
    draw, the step's x_mean after every interval = (N - 1) //
    (print_steps - 2) steps (N // interval snapshots) and the result;
    `pndm` refuses it.
    """
    if predictor is not None and predictor not in PREDICTORS:
        raise NotImplementedError(f"predictor not implemented: {predictor}")
    if corrector is not None and corrector not in CORRECTORS:
        raise NotImplementedError(f"corrector not implemented: {corrector}")
    if predictor == "pndm":
        if print_steps is not None:
            raise ValueError("print_steps is not supported for pndm")
        return _pndm_sampling(sde, score_fn, num_samples, shape, N, time_eps,
                              resolve_device(device), generator, x0)
    interval = None
    if print_steps is not None:
        interval = (N - 1) // (print_steps - 2)
        if interval < 1:
            raise ValueError(f"print_steps {print_steps} leaves no interval "
                             f"in {N} steps")
    if predictor in ("ancestral", "ddim"):
        if not hasattr(sde, "alphas_cump"):
            raise NotImplementedError(
                f"the {predictor} predictor reads the VPSDE's discrete "
                f"tables, which {sde.sde_type} has not")
        if sde.N != N:
            raise ValueError(f"the SDE's discrete tables have {sde.N} steps, "
                             f"the sampler {N}")
    dev = resolve_device(device)
    full_shape = (num_samples,) + tuple(shape)

    def draw(pinned):
        if pinned is None:
            return torch.randn(full_shape, generator=generator, device=dev)
        return pinned.to(device=dev, dtype=torch.float32)

    def per_sample(v):  # [B] -> broadcastable against x
        return v.reshape((num_samples,) + (1,) * len(shape))

    x = draw(x0)
    if sde.sde_type == "vesde":
        x = x * torch.sqrt(torch.tensor(sde.sigma2_max, dtype=torch.float32,
                                        device=dev))
    ts = timesteps(N, time_eps)
    idx = ancestral_indices(ts, N).to(dev)
    if sde.sde_type in ("vpsde", "sub_vpsde"):
        # the correctors' discrete alpha (`discrete_alpha`); for the VPSDE
        # also the ancestral predictor's betas
        betas = torch.linspace(sde.beta_start / N, sde.beta_end / N, N,
                               dtype=torch.float32).to(dev)[idx]
        alphas = 1.0 - betas
    else:
        alphas = torch.ones(N, device=dev)
    if predictor == "ddim":
        alphas_cump = sde.alphas_cump.to(dev)
        # at_next: alphas_cump[idx - 1], or 1 at idx 0
        at_next = torch.cat([torch.ones(1, device=dev), alphas_cump])[idx]
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

    if predictor == "ancestral":
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
    first = x
    n_snaps = N // interval if interval else 0
    snaps = [None] * n_snaps
    x_mean = x
    for i in range(N):
        with profiling.span("sample.step", i):
            x_mean = x
            if pred_fn is not None:
                x, x_mean = pred_fn(
                    x, i, lambda: draw(None if noise is None else noise[i]))
            if corr_fn is not None:
                x, x_mean = corr_fn(x, i, lambda j: draw(
                    None if corrector_noise is None
                    else corrector_noise[i][j]))
        if interval and (i + 1) % interval == 0:
            snaps[min((i + 1) // interval - 1, n_snaps - 1)] = x_mean
    final = x_mean if denoise else x
    if print_steps is not None:
        return torch.stack([first, *snaps, final])
    return final


def _pndm_sampling(sde, score_fn: ScoreFn, num_samples: int,
                   shape: Tuple[int, ...], N: int, time_eps: float, dev,
                   generator: Optional[torch.Generator],
                   x0: Optional[torch.Tensor]) -> torch.Tensor:
    """PNDM: `x0` (N(0, 1), not scaled for any family) moved through the N
    steps idx = N..1 from timesteps[2 idx - 1] to timesteps[2 idx - 3] of
    timesteps = linspace(time_eps, 1, 2N); at idx 1 the index wraps to the
    table's last entry, 1.0, as the JAX package's (and the reference's
    negative index) does."""
    if not (hasattr(sde, "train_N") and hasattr(sde, "beta_start")):
        raise NotImplementedError(
            f"the pndm predictor reads the VPSDE's train_N and betas, which "
            f"{sde.sde_type} has not")
    train_N = sde.train_N
    full_shape = (num_samples,) + tuple(shape)
    x = (torch.randn(full_shape, generator=generator, device=dev)
         if x0 is None else x0.to(device=dev, dtype=torch.float32))
    ts = torch.linspace(time_eps, 1.0, 2 * N, dtype=torch.float32)
    betas = torch.linspace(sde.beta_start / train_N, sde.beta_end / train_N,
                           train_N, dtype=torch.float32)
    alphas_cump = torch.cat([torch.ones(1), torch.cumprod(1.0 - betas, 0)])

    def coeffs(t, t_next):
        """transfer's [at_next - at, its x factor, its eps factor] in f32;
        the table index int(train_N (t - time_eps) + 1), truncated in f32."""
        ti = (train_N * (t - time_eps) + 1).to(torch.int32).long()
        tni = (train_N * (t_next - time_eps) + 1).to(torch.int32).long()
        at, at_next = alphas_cump[ti], alphas_cump[tni]
        sq, sqn = torch.sqrt(at), torch.sqrt(at_next)
        fx = 1.0 / (sq * (sq + sqn))
        fe = 1.0 / (sq * (torch.sqrt((1 - at_next) * at)
                          + torch.sqrt((1 - at) * at_next)))
        return torch.stack([at_next - at, fx, fe])

    # each step's times (t1, t_mid, t3) and its transfers t1 -> t_mid and
    # t1 -> t3, made on the host and moved to `dev` once
    times = torch.stack([torch.stack([ts[2 * i - 1], ts[2 * i - 2],
                                      ts[(2 * (i - 1) - 1) % (2 * N)]])
                         for i in range(N, 0, -1)])
    mids = torch.stack([coeffs(t[0], t[1]) for t in times]).to(dev)
    ends = torch.stack([coeffs(t[0], t[2]) for t in times]).to(dev)
    times = times.to(dev)

    def transfer(x, c, et):
        return x + c[0] * (c[1] * x - c[2] * et)

    def params(t, x, step):
        _, p = score_fn(t.expand(num_samples), x, step)
        return p.float()

    ets = [torch.zeros(full_shape, device=dev)] * 4
    for step in range(N):
        t1, t_mid, t3 = times[step]
        if step > 2:  # Adams-Bashforth over the ring
            ets = ets[1:] + [params(t1, x, step)]
            et = (1.0 / 24) * (55 * ets[3] - 59 * ets[2] + 37 * ets[1]
                               - 9 * ets[0])
        else:  # Runge-Kutta
            e_1 = params(t1, x, step)
            ets = ets[1:] + [e_1]
            e_2 = params(t_mid, transfer(x, mids[step], e_1), step)
            e_3 = params(t_mid, transfer(x, mids[step], e_2), step)
            e_4 = params(t3, transfer(x, ends[step], e_3), step)
            et = (1.0 / 6) * (e_1 + 2 * e_2 + 2 * e_3 + e_4)
        x = transfer(x, ends[step], et)
    return x


# Dormand-Prince RK45's tableau (the JAX package's `_DOPRI_*`)
_DOPRI_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DOPRI_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
             187 / 2100, 1 / 40)


def sample_model_ode(sde, score_fn: ScoreFn, num_samples: int,
                     shape: Tuple[int, ...], ode_eps: float = 1e-6,
                     ode_solver_tol: float = 1e-5, *, device="cuda",
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     max_steps: int = 10000,
                     stats: Optional[dict] = None):
    """Probability-flow ODE sampling, dx/dt = f(t) x - 0.5 g2(t) score(t, x)
    from t=1 down to `ode_eps` with Dormand-Prince RK45, atol = rtol =
    `ode_solver_tol`: (samples [num_samples, *shape] f32, nfe).

    `noise`: the initial draw (else N(0, 1) from `generator`), scaled by
    sqrt(sigma2_max) for the VESDE. One step size for the whole batch (the
    error norm is the RMS over every element); h starts at
    -(1 - ode_eps) / 100 and is clamped so as not to pass `ode_eps`; a
    rejected step keeps t and x. nfe counts 6 a step tried, rejected ones
    too, though all 7 stages are evaluated. At most `max_steps` steps.
    `stats`, if given, receives {'nfe', 'steps', 'accepted', 'rejected',
    't', 'capped'}."""
    dev = resolve_device(device)
    full_shape = (num_samples,) + tuple(shape)
    x = (torch.randn(full_shape, generator=generator, device=dev)
         if noise is None else noise.to(device=dev, dtype=torch.float32))
    if sde.sde_type == "vesde":
        x = x * torch.sqrt(torch.tensor(sde.sigma2_max, dtype=torch.float32,
                                        device=dev))

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def per_sample(v):
        return v.reshape((num_samples,) + (1,) * len(shape))

    def ode_func(t, x):
        tv = t.expand(num_samples)
        score, _ = score_fn(tv, x, None)
        return (per_sample(sde.f(tv)) * x
                - 0.5 * per_sample(sde.g2(tv)) * score.float())

    t1, stop, tol = f32(ode_eps), f32(ode_eps + 1e-12), ode_solver_tol
    t, h = f32(1.0), f32(-(1.0 - ode_eps) / 100.0)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0
    while steps < max_steps and bool(t > stop):
        h_eff = torch.where(t + h < t1, t1 - t, h)
        ks = []
        for i in range(7):
            xi = x
            for j, a in enumerate(_DOPRI_A[i]):
                xi = xi + h_eff * a * ks[j]
            ks.append(ode_func(t + _DOPRI_C[i] * h_eff, xi))
        x5 = x + h_eff * sum(b * k for b, k in zip(_DOPRI_B5, ks))
        x4 = x + h_eff * sum(b * k for b, k in zip(_DOPRI_B4, ks))
        scale = tol + tol * torch.maximum(x.abs(), x5.abs())
        err = torch.sqrt(torch.mean(torch.square((x5 - x4) / scale)))
        accept = err <= 1.0
        t = torch.where(accept, t + h_eff, t)
        x = torch.where(accept, x5, x)
        factor = torch.clamp(0.9 * torch.pow(torch.clamp(err, min=1e-10),
                                             -0.2), 0.2, 5.0)
        h = h_eff * factor
        accepted += accept
        steps += 1
    nfe = 6 * steps
    if stats is not None:
        n_acc = int(accepted)
        stats.update(nfe=nfe, steps=steps, accepted=n_acc,
                     rejected=steps - n_acc, t=float(t),
                     capped=bool(t > stop))
    return x, nfe
