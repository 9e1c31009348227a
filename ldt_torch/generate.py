"""Noise -> 2048-point clouds: the generation path of `bench.py::generate`.

`steps`-step reverse diffusion of [B, 32, 120] latents with the DiT, its
AdaLN modulations precomputed for the whole schedule, then the set-VAE
decode to [B, outsize, 3] (2048 points). The sampler state stays f32; the
networks run in their own dtype (bf16 in serving), and the score is
-eps.float() / std(t).

The DiT step is `Score.denoise_with_mods`, or with `int8=True` the W8A8
twin `serving.int8.denoise_with_mods_int8` (bench.py's serving path), its
weights quantized once per generation, before the loop. With a `label` (or
an `AdaLN: False` Score) the conditioning is not t's alone: each step runs
the whole Score, c = t_emb + l_emb, as the JAX trainer's sampler does; the
int8 path serves the unconditional AdaLN Score only.
"""

from __future__ import annotations

from typing import Optional

import torch

from ldt_torch import resolve_device
from ldt_torch.diffusion.sampling import sample_discrete, timesteps
from ldt_torch.serving import int8 as int8_serving

# The schedule's last time, linspace(1, TIME_EPS, steps) (bench.py).
TIME_EPS = 1e-6


@torch.inference_mode()
def generate(score, compressor, sde, batch: int, steps: int, *,
             device="cuda", **kw) -> torch.Tensor:
    """Generate `batch` clouds [batch, compressor.cfg.outsize, 3]; `kw` as
    `sample_latents`."""
    eps = sample_latents(score, sde, batch, steps, device=device, **kw)
    return compressor.sample((batch, compressor.cfg.outsize), eps)


@torch.inference_mode()
def sample_latents(score, sde, batch: int, steps: int, *, device="cuda",
                   int8: bool = False, int8_weights=None,
                   attn_int8: bool = False, bf16_tail: int = 0,
                   act_scales: Optional[torch.Tensor] = None,
                   label: Optional[torch.Tensor] = None,
                   **sampler) -> torch.Tensor:
    """The reverse diffusion alone: [batch, z_scale, z_dim] f32 latents.

    `sampler`: the options of `sample_discrete` (predictor, corrector,
    corrector_steps, snr, probability_flow, denoise, and the draws:
    generator, x0, noise, corrector_noise).

    `int8`: serve each step through the W8A8 twin. Its weights are
    quantized from `int8_weights` (an f32 Score or state_dict; default
    `score`, which must then be f32); `score` gives the modulations in its
    own dtype. `attn_int8`: its attention core is K8 (else K1);
    `bf16_tail`: the last k blocks keep bf16 weights; `act_scales`: static
    activation scales [steps, num_blocks, 4] (else dynamic).

    `label` [batch]: category indices of a label-conditioned Score; each
    step then runs `score(x, t, label)`.
    """
    dev = resolve_device(device)
    if not int8 and (attn_int8 or bf16_tail or act_scales is not None
                     or int8_weights is not None):
        raise ValueError("attn_int8, bf16_tail, act_scales and int8_weights "
                         "are options of the int8 path (int8=True)")
    cfg = score.cfg
    if label is not None or not cfg.AdaLN:
        if int8:
            raise ValueError("the int8 path serves the unconditional AdaLN "
                             "Score only")
        if label is not None:
            label = label.to(dev)

        def score_fn(t, x, step):
            p = score(x, t, label)
            return -p.float() / sde.std(t)[:, None, None], p

        return sample_discrete(sde, score_fn, batch,
                               (cfg.z_scale, cfg.z_dim), steps, TIME_EPS,
                               device=dev, **sampler)
    mods = score.precompute_mods(timesteps(steps, TIME_EPS).to(dev))

    def step_mods(step):
        return {"blocks": mods["blocks"][step], "final": mods["final"][step]}

    if int8:
        q = int8_serving.quantize_score_params(
            score if int8_weights is None else int8_weights,
            cfg.num_blocks, bf16_tail, device=dev)
        if act_scales is not None:
            want = (steps, cfg.num_blocks, 4)
            if tuple(act_scales.shape) != want:
                raise ValueError(f"act_scales {tuple(act_scales.shape)}, "
                                 f"expected {want}")
            act_scales = act_scales.to(device=dev, dtype=torch.float32)

        def denoise(x, step):
            return int8_serving.denoise_with_mods_int8(
                x, step_mods(step), q, cfg.num_heads, attn_int8=attn_int8,
                act_scales=None if act_scales is None else act_scales[step])
    else:
        def denoise(x, step):
            return score.denoise_with_mods(x, step_mods(step))

    def score_fn(t, x, step):
        p = denoise(x, step)
        return -p.float() / sde.std(t)[:, None, None], p

    return sample_discrete(sde, score_fn, batch, (cfg.z_scale, cfg.z_dim),
                           steps, TIME_EPS, device=dev, **sampler)
