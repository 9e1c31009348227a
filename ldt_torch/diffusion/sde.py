"""Linear-beta VPSDE, counterpart of `ldt_tpu/diffusion/sde.py`.

Every method is a plain tensor function of `t`. The discrete tables used by
the ancestral sampler (`betas`, `alphas_cump`) are built in f32 on the CPU
(`torch.linspace` differs from `jnp.linspace` by at most an ulp or two),
and then moved to the SDE's device. `e2int_f` and `var` give the discrete-t
training objective its mean and variance. The geometric, sub-VP and VE SDEs
and the importance-sampling quantities of continuous-t training are later
work.
"""

from __future__ import annotations

import torch

from ldt_torch import resolve_device


def make_diffusion(args, *, device="cuda"):
    """Diffusion factory; only `vpsde` is ported."""
    if args.sde_type == "vpsde":
        return DiffusionVPSDE(args, device=device)
    if args.sde_type in ("geometric_sde", "sub_vpsde", "vesde"):
        raise NotImplementedError(f"{args.sde_type} is not ported yet")
    raise ValueError(f"Unrecognized sde type: {args.sde_type}")


class DiffusionVPSDE:
    """Linear-beta VPSDE: beta(t) = beta_start + (beta_end - beta_start) t."""

    def __init__(self, args, *, device="cuda"):
        self.device = resolve_device(device)
        self.sigma2_0 = args.sigma2_0
        self.beta_start = args.beta_start
        self.beta_end = args.beta_end
        if getattr(args, "sample_mode", "discrete") == "discrete":
            self.N = args.sample_N
            self.betas = torch.linspace(
                self.beta_start / self.N, self.beta_end / self.N, self.N,
                dtype=torch.float32).to(self.device)
            self.alphas_cump = torch.cumprod(1.0 - self.betas, dim=0)

    def f(self, t: torch.Tensor) -> torch.Tensor:
        return -0.5 * self.g2(t)

    def g2(self, t: torch.Tensor) -> torch.Tensor:
        return self.beta_start + (self.beta_end - self.beta_start) * t

    def var(self, t: torch.Tensor) -> torch.Tensor:
        return 1.0 - (1.0 - self.sigma2_0) * torch.exp(
            -self.beta_start * t
            - 0.5 * (self.beta_end - self.beta_start) * t * t)

    def std(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.var(t))

    def e2int_f(self, t: torch.Tensor) -> torch.Tensor:
        """exp(-integral of f from 0 to t): the mean factor of x_t."""
        return torch.exp(-0.5 * self.beta_start * t
                         - 0.25 * (self.beta_end - self.beta_start) * t * t)
