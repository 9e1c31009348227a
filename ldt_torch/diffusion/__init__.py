"""VPSDE and its ancestral sampler (counterpart of ldt_tpu/diffusion)."""

from ldt_torch.diffusion.sde import DiffusionVPSDE, make_diffusion

__all__ = ["DiffusionVPSDE", "make_diffusion"]
