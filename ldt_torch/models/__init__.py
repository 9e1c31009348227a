"""The latent DiT and the set-VAE (counterpart of ldt_tpu/models)."""

from ldt_torch.models.compressor import Compressor
from ldt_torch.models.score import Score

__all__ = ["Compressor", "Score"]
