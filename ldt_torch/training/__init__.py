"""Training (counterpart of ldt_tpu/training): the optimizer state, the
base trainer, the stage-1 Compressor trainer, the stage-2
latent-diffusion trainer, and their checkpoints (the port's files and the
JAX package's)."""
