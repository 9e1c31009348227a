"""Training (counterpart of ldt_tpu/training): the optimizer state, the
base trainer, the stage-1 Compressor trainer and the stage-2
latent-diffusion trainer."""
