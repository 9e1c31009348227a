"""SDE families for latent diffusion, counterpart of
`ldt_tpu/diffusion/sde.py`.

Every method is a plain f32 tensor function of `t`. `make_diffusion` builds
the geometric VP, the linear-beta VP, the sub-VP and the VE SDE, each on a
device; `iw_quantities` samples the (t, var, mean factor, objective
weights, g2) of continuous-t training in each family's seven importance-
sampling modes, with rho ~ U(0, 1) from the caller's generator or pinned
(`rho=`), so that the JAX package's draws can be replayed. Its constants
(the erf normalizers of `drop_all_iw`) are Python floats, rounded to f32
where they meet a tensor, as in JAX; `drop_all_iw`'s t goes through f32
`erfinv` whose argument lies within 1e-5 of 1 for rho near 1, where an f64
path would give another t than the JAX package.

The VPSDE's discrete tables used by the ancestral and DDIM samplers
(`betas`, `alpha`, `alphas_cump`) are built in f32 on the CPU
(`torch.linspace` differs from `jnp.linspace` by at most an ulp or two),
and then moved to the SDE's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ldt_torch import resolve_device

IW_MODES = ("ll_uniform", "ll_iw", "drop_all_uniform", "drop_all_iw",
            "drop_sigma2t_iw", "drop_sigma2t_uniform", "rescale_iw")


def make_diffusion(args, *, device="cuda"):
    """Diffusion factory (`args.sde_type`: geometric_sde, vpsde, sub_vpsde
    or vesde)."""
    table = {"geometric_sde": DiffusionGeometric, "vpsde": DiffusionVPSDE,
             "sub_vpsde": DiffusionSubVPSDE, "vesde": DiffusionVESDE}
    if args.sde_type not in table:
        raise ValueError(f"Unrecognized sde type: {args.sde_type}")
    return table[args.sde_type](args, device=device)


def _erf_constants(obj) -> None:
    """The linear-beta families' constants of `drop_all_iw`."""
    obj.delta_beta_half = 0.5 * (obj.beta_end - obj.beta_start)
    obj.beta_frac = obj.beta_start / (obj.beta_end - obj.beta_start)
    obj.const_aq = ((1.0 - obj.sigma2_0) * math.exp(0.5 * obj.beta_frac)
                    * math.sqrt(0.25 * math.pi / obj.delta_beta_half))
    sqrt_dbh = math.sqrt(obj.delta_beta_half)
    obj.const_erf = math.erf(sqrt_dbh * (obj.time_eps + obj.beta_frac))
    erf_at_1 = math.erf(sqrt_dbh * (1.0 + obj.beta_frac))
    obj.const_norm = obj.const_aq * (erf_at_1 - obj.const_erf)
    obj.const_norm_2 = erf_at_1 - obj.const_erf


class DiffusionBase:
    """What the families share: `std`, `sample_q`, `cross_entropy_const`
    and `iw_quantities`."""

    def __init__(self, args, *, device="cuda"):
        self.device = resolve_device(device)
        self.sigma2_0 = args.sigma2_0
        self.sde_type = args.sde_type
        self.time_eps = args.time_eps
        self.sample_time_eps = getattr(args, "sample_time_eps", args.time_eps)

    def std(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.var(t))

    def sample_q(self, x_init, noise, var_t, m_t):
        """Diffuse to time t: m_t x0 + sqrt(var_t) noise."""
        return m_t * x_init + torch.sqrt(var_t) * noise

    def cross_entropy_const(self, ode_eps: float) -> torch.Tensor:
        """0.5 (1 + log(2 pi var(ode_eps))), a 0-d f32 tensor."""
        v = self.var(torch.tensor(ode_eps, dtype=torch.float32,
                                  device=self.device))
        return 0.5 * (1.0 + torch.log(2.0 * math.pi * v))

    def _uniform_t(self, rho, time_eps):
        return rho * (1.0 - time_eps) + time_eps

    def iw_quantities(self, size: int, time_eps: float, iw_sample_mode: str,
                      iw_subvp_like_vp_sde: bool = False, *,
                      generator: Optional[torch.Generator] = None,
                      rho: Optional[torch.Tensor] = None):
        """(t [size], var_t, m_t, obj_weight, obj_weight_ll, g2_t, each
        [size, 1]) of the weighted score-matching objective, from rho
        ~ U(0, 1) [size] (`rho` pins it; else drawn from `generator`)."""
        if rho is None:
            rho = torch.rand(size, generator=generator, device=self.device)
        rho = rho.to(self.device, torch.float32)
        if self.sde_type in ("geometric_sde", "vpsde"):
            out = self._iw_vpsdelike(rho, time_eps, iw_sample_mode)
        elif self.sde_type == "sub_vpsde":
            out = self._iw_subvpsdelike(rho, time_eps, iw_sample_mode,
                                        iw_subvp_like_vp_sde)
        else:
            out = self._iw_vesde(rho, time_eps, iw_sample_mode)
        t, rest = out[0], out[1:]
        return (t,) + tuple(torch.broadcast_to(v, (size,)).reshape(size, 1)
                            for v in rest)

    def _at(self, t):
        return self.var(t), self.e2int_f(t), self.g2(t)

    def _drop_all_iw_t(self, rho):
        """t = sqrt(1 / dbh) erfinv(rho c2 + c_erf) - beta_frac, the
        square root taken in f32 as JAX takes it of a Python float."""
        root = torch.sqrt(torch.tensor(1.0 / self.delta_beta_half,
                                       dtype=torch.float32,
                                       device=rho.device))
        return (root * torch.erfinv(rho * self.const_norm_2 + self.const_erf)
                - self.beta_frac)

    def _iw_vpsdelike(self, rho, time_eps, mode):
        ones = torch.ones_like(rho)
        if mode in ("ll_uniform", "drop_all_uniform", "drop_sigma2t_uniform",
                    "rescale_iw"):
            t = self._uniform_t(rho, time_eps)
            var_t, m_t, g2_t = self._at(t)
            obj_ll = g2_t / (2.0 * var_t)
            obj = {"ll_uniform": obj_ll,
                   "drop_all_uniform": torch.ones_like(rho),
                   "drop_sigma2t_uniform": g2_t / 2.0,
                   "rescale_iw": 0.5 / (1.0 - var_t)}[mode]
        elif mode == "ll_iw":
            s2_1, s2_eps = self.var(ones), self.var(time_eps * ones)
            log_1, log_eps = torch.log(s2_1), torch.log(s2_eps)
            var_t = torch.exp(rho * log_1 + (1 - rho) * log_eps)
            t = self.inv_var(var_t)
            m_t, g2_t = self.e2int_f(t), self.g2(t)
            obj = obj_ll = 0.5 * (log_1 - log_eps) / (1.0 - var_t)
        elif mode == "drop_all_iw":
            if self.sde_type != "vpsde":
                raise ValueError("drop_all_iw importance sampling needs the "
                                 f"regular VPSDE, not {self.sde_type}")
            t = self._drop_all_iw_t(rho)
            var_t, m_t, g2_t = self._at(t)
            obj = self.const_norm / (1.0 - var_t)
            obj_ll = obj * g2_t / (2.0 * var_t)
        elif mode == "drop_sigma2t_iw":
            s2_1, s2_eps = self.var(ones), self.var(time_eps * ones)
            var_t = rho * s2_1 + (1 - rho) * s2_eps
            t = self.inv_var(var_t)
            m_t, g2_t = self.e2int_f(t), self.g2(t)
            obj = 0.5 * (s2_1 - s2_eps) / (1.0 - var_t)
            obj_ll = obj / var_t
        else:
            raise ValueError(f"Unrecognized importance sampling type: {mode}")
        return t, var_t, m_t, obj, obj_ll, g2_t

    def _iw_subvpsdelike(self, rho, time_eps, mode, like_vp):
        ones = torch.ones_like(rho)
        if mode in ("ll_iw", "drop_all_iw", "drop_sigma2t_iw") and not like_vp:
            raise NotImplementedError(
                f"{mode} on the sub-VPSDE needs iw_subvp_like_vp_sde")
        if mode in ("ll_uniform", "drop_all_uniform", "drop_sigma2t_uniform",
                    "rescale_iw"):
            return self._iw_vpsdelike(rho, time_eps, mode)
        if mode == "ll_iw":
            s2_1 = self.var_vpsde(ones)
            s2_eps = self.var_vpsde(time_eps * ones)
            log_1, log_eps = torch.log(s2_1), torch.log(s2_eps)
            var_vp = torch.exp(rho * log_1 + (1 - rho) * log_eps)
            t = self.inv_var_vpsde(var_vp)
            var_t, m_t, g2_t = self._at(t)
            obj = obj_ll = (g2_t / (2.0 * var_t) * (log_1 - log_eps)
                            * var_vp / (1 - var_vp) / self.beta(t))
        elif mode == "drop_all_iw":
            t = self._drop_all_iw_t(rho)
            var_t, m_t, g2_t = self._at(t)
            obj = self.const_norm / (1.0 - self.var_vpsde(t))
            obj_ll = obj * g2_t / (2.0 * var_t)
        elif mode == "drop_sigma2t_iw":
            s2_1 = self.var_vpsde(ones)
            s2_eps = self.var_vpsde(time_eps * ones)
            var_vp = rho * s2_1 + (1 - rho) * s2_eps
            t = self.inv_var_vpsde(var_vp)
            var_t, m_t, g2_t = self._at(t)
            obj = (0.5 * g2_t / self.beta(t) * (s2_1 - s2_eps)
                   / (1.0 - var_vp))
            obj_ll = obj / var_t
        else:
            raise ValueError(f"Unrecognized importance sampling type: {mode}")
        return t, var_t, m_t, obj, obj_ll, g2_t

    def _iw_vesde(self, rho, time_eps, mode):
        ones = torch.ones_like(rho)
        if mode in ("ll_iw", "drop_all_iw"):
            n_1, n_eps = self.var_N(ones), self.var_N(time_eps * ones)
            s2_eps = self.var(time_eps * ones)
            log_f1 = torch.log(self.sigma2_max / n_1)
            log_feps = torch.log(n_eps / s2_eps)
            var_n = (1.0 - self.sigma2_min) / (
                1.0 - torch.exp(rho * (log_f1 + log_feps) - log_feps))
            t = self.inv_var_N(var_n)
            var_t, m_t, g2_t = self._at(t)
            obj_ll = 0.5 * (log_f1 + log_feps) * self.var_N(t) / (
                1.0 - self.sigma2_min)
            obj = obj_ll if mode == "ll_iw" else 2.0 * obj_ll / math.log(
                self.sigma2_max / self.sigma2_min)
        elif mode == "drop_sigma2t_iw":
            n_1, n_eps = self.var_N(ones), self.var_N(time_eps * ones)
            var_n = torch.exp(rho * torch.log(n_1)
                              + (1 - rho) * torch.log(n_eps))
            t = self.inv_var_N(var_n)
            var_t, m_t, g2_t = self._at(t)
            obj = 0.5 * torch.log(n_1 / n_eps) * self.var_N(t)
            obj_ll = obj / var_t
        else:
            return self._iw_vpsdelike(rho, time_eps, mode)
        return t, var_t, m_t, obj, obj_ll, g2_t


class DiffusionGeometric(DiffusionBase):
    """Geometric-variance VPSDE variant."""

    def __init__(self, args, *, device="cuda"):
        super().__init__(args, device=device)
        self.sigma2_min = args.sigma2_min
        self.sigma2_max = args.sigma2_max

    def f(self, t):
        return -0.5 * self.g2(t)

    def g2(self, t):
        sigma2_geom = self.sigma2_min * (
            (self.sigma2_max / self.sigma2_min) ** t)
        log_term = math.log(self.sigma2_max / self.sigma2_min)
        return sigma2_geom * log_term / (
            1.0 - self.sigma2_0 + self.sigma2_min - sigma2_geom)

    def var(self, t):
        return (self.sigma2_min * ((self.sigma2_max / self.sigma2_min) ** t)
                - self.sigma2_min + self.sigma2_0)

    def e2int_f(self, t):
        return torch.sqrt(1.0 + self.sigma2_min
                          * (1.0 - (self.sigma2_max / self.sigma2_min) ** t)
                          / (1.0 - self.sigma2_0))

    def inv_var(self, var):
        return (torch.log((var + self.sigma2_min - self.sigma2_0)
                          / self.sigma2_min)
                / math.log(self.sigma2_max / self.sigma2_min))


class DiffusionVPSDE(DiffusionBase):
    """Linear-beta VPSDE: beta(t) = beta_start + (beta_end - beta_start) t,
    with the discrete tables of the ancestral and DDIM samplers."""

    def __init__(self, args, *, device="cuda"):
        super().__init__(args, device=device)
        self.beta_start = args.beta_start
        self.beta_end = args.beta_end
        _erf_constants(self)
        self.train_N = getattr(args, "train_N", 1000)
        if getattr(args, "sample_mode", "discrete") == "discrete":
            self.N = args.sample_N
            self.betas = torch.linspace(
                self.beta_start / self.N, self.beta_end / self.N, self.N,
                dtype=torch.float32).to(self.device)
            self.alpha = 1.0 - self.betas
            self.alphas_cump = torch.cumprod(self.alpha, dim=0)

    def f(self, t: torch.Tensor) -> torch.Tensor:
        return -0.5 * self.g2(t)

    def g2(self, t: torch.Tensor) -> torch.Tensor:
        return self.beta_start + (self.beta_end - self.beta_start) * t

    def discrete(self, idx):
        return self.betas[idx], self.alpha[idx]

    def var(self, t: torch.Tensor) -> torch.Tensor:
        return 1.0 - (1.0 - self.sigma2_0) * torch.exp(
            -self.beta_start * t
            - 0.5 * (self.beta_end - self.beta_start) * t * t)

    def e2int_f(self, t: torch.Tensor) -> torch.Tensor:
        """exp(-integral of f from 0 to t): the mean factor of x_t."""
        return torch.exp(-0.5 * self.beta_start * t
                         - 0.25 * (self.beta_end - self.beta_start) * t * t)

    def inv_var(self, var):
        c = torch.log((1 - var) / (1 - self.sigma2_0))
        a = self.beta_end - self.beta_start
        return (-self.beta_start
                + torch.sqrt(self.beta_start ** 2 - 2 * a * c)) / a


class DiffusionSubVPSDE(DiffusionBase):
    """Sub-VPSDE; its importance sampling goes through the VPSDE's variance
    (`var_vpsde`, `inv_var_vpsde`)."""

    def __init__(self, args, *, device="cuda"):
        super().__init__(args, device=device)
        self.beta_start = args.beta_start
        self.beta_end = args.beta_end
        _erf_constants(self)

    def beta(self, t):
        return self.beta_start + (self.beta_end - self.beta_start) * t

    def f(self, t):
        return -0.5 * self.beta(t)

    def g2(self, t):
        return self.beta(t) * (1.0 - torch.exp(
            -2.0 * self.beta_start * t
            - (self.beta_end - self.beta_start) * t * t))

    def var(self, t):
        int_term = torch.exp(-self.beta_start * t
                             - 0.5 * (self.beta_end - self.beta_start) * t * t)
        return torch.square(1.0 - int_term) + self.sigma2_0 * int_term

    def e2int_f(self, t):
        return torch.exp(-0.5 * self.beta_start * t
                         - 0.25 * (self.beta_end - self.beta_start) * t * t)

    def inv_var(self, var):
        raise NotImplementedError("the sub-VPSDE's variance has no inverse "
                                  "here: its importance sampling inverts "
                                  "the VPSDE's (inv_var_vpsde)")

    def var_vpsde(self, t):
        return 1.0 - (1.0 - self.sigma2_0) * torch.exp(
            -self.beta_start * t
            - 0.5 * (self.beta_end - self.beta_start) * t * t)

    def inv_var_vpsde(self, var):
        c = torch.log((1 - var) / (1 - self.sigma2_0))
        a = self.beta_end - self.beta_start
        return (-self.beta_start
                + torch.sqrt(self.beta_start ** 2 - 2 * a * c)) / a


class DiffusionVESDE(DiffusionBase):
    """VESDE (sigma2_min must equal sigma2_0)."""

    def __init__(self, args, *, device="cuda"):
        super().__init__(args, device=device)
        self.sigma2_min = args.sigma2_min
        self.sigma2_max = args.sigma2_max
        if self.sigma2_min != self.sigma2_0:
            raise ValueError("VESDE assumes sigma2_min == sigma2_0, got "
                             f"{self.sigma2_min} and {self.sigma2_0}")

    def f(self, t):
        return torch.zeros_like(t)

    def g2(self, t):
        return (self.sigma2_min * math.log(self.sigma2_max / self.sigma2_min)
                * ((self.sigma2_max / self.sigma2_min) ** t))

    def var(self, t):
        return (self.sigma2_min * ((self.sigma2_max / self.sigma2_min) ** t)
                - self.sigma2_min + self.sigma2_0)

    def e2int_f(self, t):
        return torch.ones_like(t)

    def inv_var(self, var):
        return (torch.log((var + self.sigma2_min - self.sigma2_0)
                          / self.sigma2_min)
                / math.log(self.sigma2_max / self.sigma2_min))

    def var_N(self, t):
        return (1.0 - self.sigma2_min
                + self.sigma2_min * ((self.sigma2_max / self.sigma2_min) ** t))

    def inv_var_N(self, var):
        return (torch.log((var + self.sigma2_min - 1.0) / self.sigma2_min)
                / math.log(self.sigma2_max / self.sigma2_min))
