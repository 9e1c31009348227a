"""Noise -> 2048-point clouds: the generation path of `bench.py::generate`.

`steps`-step reverse diffusion of [B, 32, 120] latents with the DiT, its
AdaLN modulations precomputed for the whole schedule, then the set-VAE
decode to [B, outsize, 3] (2048 points). The sampler state stays f32; the
networks run in their own dtype (bf16 in serving), and the score is
-eps.float() / std(t).

The DiT step is `Score.denoise_with_mods`, or with `int8=True` the W8A8
twin `serving.int8.denoise_with_mods_int8` (bench.py's serving path), its
weights quantized once per generation, before the loop. With a `label` (or
an `AdaLN: False` Score, or a UNet) the conditioning is not t's alone: each
step runs the whole Score, c = t_emb + l_emb, as the JAX trainer's sampler
does; so does a completion `condition` (c = t_emb + the image embedding,
the point tokens cross-attended), encoded once before the loop. With
`int8=True` a condition is served by the conditional W8A8 twin
`serving.int8.denoise_cond_int8`: the schedule's time embeddings, the
quantized weights and the cross blocks' keys and values of the condition
tokens are made once, before the loop. A label, an `AdaLN: False` Score or
a UNet has no int8 path.

The PNDM predictor and the probability-flow ODE (`sample_mode=
"continuous"`) evaluate the Score between the schedule's times, so they
run the whole Score at each evaluation too (no hoisted modulations, no
int8), as the JAX trainers' samplers do.
"""

from __future__ import annotations

from typing import Optional

import torch

from ldt_torch import resolve_device
from ldt_torch.diffusion.sampling import (
    sample_discrete,
    sample_model_ode,
    timesteps,
)
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
                   condition=None, time_eps: float = TIME_EPS,
                   sample_mode: str = "discrete", ode_tol: float = 1e-5,
                   ode_stats: Optional[dict] = None,
                   **sampler) -> torch.Tensor:
    """The reverse diffusion alone: [batch, z_scale, z_dim] f32 latents.

    `sampler`: the options of `sample_discrete` (predictor, corrector,
    corrector_steps, snr, probability_flow, denoise, and the draws:
    generator, x0, noise, corrector_noise), over `steps` steps of
    linspace(1, time_eps, steps). `sample_mode="continuous"` integrates the
    probability-flow ODE instead (`sample_model_ode` to `time_eps` at
    tolerance `ode_tol`, its counts into `ode_stats` if given); of
    `sampler` it takes the draws `generator` and `x0` (the initial one)
    and ignores the discrete sampler's options.

    `int8`: serve each step through the W8A8 twin. Its weights are
    quantized from `int8_weights` (an f32 Score or state_dict; default
    `score`, which must then be f32); `score` gives the modulations in its
    own dtype. `attn_int8`: its attention core is K8 (else K1);
    `bf16_tail`: the last k blocks keep bf16 weights; `act_scales`: static
    activation scales [steps, num_blocks, 4] (else dynamic).

    `label` [batch]: category indices of a label-conditioned Score; each
    step then runs `score(x, t, label)`. `condition`: a completion
    condition ({'img', 'pts'} or the pair `Score.encode_condition` gives);
    a dict is encoded here, once, and each step runs
    `score(x, t, label, encoded)`, or with `int8` one `denoise_cond_int8`
    (its tokens must be there; no `bf16_tail` or `act_scales`).
    """
    dev = resolve_device(device)
    if not int8 and (attn_int8 or bf16_tail or act_scales is not None
                     or int8_weights is not None):
        raise ValueError("attn_int8, bf16_tail, act_scales and int8_weights "
                         "are options of the int8 path (int8=True)")
    if sample_mode not in ("discrete", "continuous"):
        raise ValueError(f"sample_mode {sample_mode!r}: 'discrete' or "
                         "'continuous'")
    cfg = score.cfg
    run = dict(batch=batch, shape=(cfg.z_scale, cfg.z_dim), steps=steps,
               dev=dev, time_eps=time_eps, sample_mode=sample_mode,
               ode_tol=ode_tol, ode_stats=ode_stats)
    # PNDM and the ODE evaluate between the schedule's times
    scheduled = sample_mode == "discrete" and \
        sampler.get("predictor") != "pndm"
    if int8 and not scheduled:
        raise ValueError("the int8 path serves the discrete schedule's "
                         "steps only: not pndm, not the ODE")
    if int8 and condition is not None and label is None and cfg.AdaLN \
            and not cfg.unet:
        return _sample_cond_int8(score, sde, condition, int8_weights,
                                 attn_int8, bf16_tail, act_scales, run,
                                 sampler)
    if label is not None or condition is not None or not cfg.AdaLN \
            or cfg.unet or not scheduled:
        if int8:
            raise ValueError("the int8 path serves the AdaLN, non-UNet "
                             "Score without a label only")
        if label is not None:
            label = label.to(dev)
        if isinstance(condition, dict):
            condition = score.encode_condition(condition)

        def score_fn(t, x, step):
            p = (score(x, t, label) if condition is None
                 else score(x, t, label, condition))
            return -p.float() / sde.std(t)[:, None, None], p

        return _run(sde, score_fn, run, sampler)
    mods = score.precompute_mods(timesteps(steps, time_eps).to(dev))

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

    return _run(sde, score_fn, run, sampler)


def _run(sde, score_fn, run: dict, sampler: dict) -> torch.Tensor:
    """`sample_discrete`, or `sample_model_ode` in continuous mode, of
    `score_fn` with `sample_latents`' options `run` and `sampler`."""
    if run["sample_mode"] == "continuous":
        pinned = [k for k in ("noise", "corrector_noise")
                  if sampler.get(k) is not None]
        if pinned:
            raise ValueError(f"the ODE draws nothing but x0: {pinned}")
        x, _ = sample_model_ode(
            sde, score_fn, run["batch"], run["shape"], run["time_eps"],
            run["ode_tol"], device=run["dev"],
            generator=sampler.get("generator"), noise=sampler.get("x0"),
            stats=run["ode_stats"])
        return x
    return sample_discrete(sde, score_fn, run["batch"], run["shape"],
                           run["steps"], run["time_eps"], device=run["dev"],
                           **sampler)


def _sample_cond_int8(score, sde, condition, int8_weights, attn_int8: bool,
                      bf16_tail: int, act_scales, run: dict,
                      sampler: dict) -> torch.Tensor:
    """`sample_latents` of a condition through `denoise_cond_int8`."""
    if bf16_tail or act_scales is not None:
        raise ValueError("the conditional int8 path has no bf16_tail and "
                         "no static act_scales")
    cfg = score.cfg
    if isinstance(condition, dict):
        condition = score.encode_condition(condition)
    tokens, img_emb = condition
    if tokens is None:
        raise ValueError("the conditional int8 path cross-attends to the "
                         "condition's point tokens: give it 'pts'")
    dev = run["dev"]
    t_embs = score.embed_times(timesteps(run["steps"],
                                         run["time_eps"]).to(dev))
    q = int8_serving.quantize_cond_score_params(
        score if int8_weights is None else int8_weights, cfg.num_blocks,
        device=dev)
    kv = int8_serving.precompute_cond_kv(q, tokens)

    def score_fn(t, x, step):
        p = int8_serving.denoise_cond_int8(x, t_embs[step], img_emb, kv, q,
                                           cfg.num_heads,
                                           attn_int8=attn_int8)
        return -p.float() / sde.std(t)[:, None, None], p

    return _run(sde, score_fn, run, sampler)
