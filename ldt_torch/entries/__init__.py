"""The port's entry points (counterparts of the repository's root scripts):
`train_compressor` (stage 1), `train_latent_diffusion` (stage 2) and
`val_sample`, each run as `python -m ldt_torch.entries.<name>`."""
