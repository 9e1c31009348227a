"""The port's entry points (counterparts of the repository's root scripts):
`train_compressor` (stage 1), `train_latent_diffusion` (stage 2),
`train_hybrid` (stage 3, the joint finetune), `train_completion_compressor`
and `train_completion_latent_diffusion` (the ViPC completion stages),
`val_sample` and `golden_eval` (a reference val.txt's rows replayed through
`val_sample`), each run as `python -m ldt_torch.entries.<name>`; the
reference-checkpoint converter runs as `python -m ldt_torch.tools.port`,
the synthetic ViPC tree's writer as `python -m ldt_torch.tools.synth_vipc`."""
