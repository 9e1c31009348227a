"""The whole small generation, ldt_torch vs bench.py's JAX pipeline.

The JAX side is `bench.py::generate` at a small size: precomputed AdaLN
modulations, the ancestral sampler over N=64 steps with the DiT's attention
through the Pallas kernel K1 (interpret mode), then the decoder through K2.
The torch side gets JAX's own random draws.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldt_tpu.diffusion import DiffusionVPSDE as JaxVPSDE
from ldt_tpu.diffusion.sampling import sample_discrete as jax_sample
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_torch.diffusion import make_diffusion
from ldt_torch.generate import generate
from ldt_torch.models import Compressor, Score
from ldt_torch.weights import load_compressor_decoder, load_score
from test_torch_port_common import (
    DTYPES,
    SDE,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    cfgs,
    params_np,
    to_np,
)
from test_torch_port_diffusion import _jax_draws

B, STEPS = 4, 64
POINTS = SMALL_COMPRESSOR["outsize"]  # the points `generate` decodes
SEED = 11
# f32: over 64 steps the twins drift apart by ~1e-5 of the clouds' scale.
F32_REL = 1e-4
# bf16: a rounding difference in one step moves the rest of the trajectory,
# and the late steps amplify it (score = -eps / std(t), std(1e-6) ~ 3e-4),
# so JAX's own bf16 run lands ~10% (of the largest |value|) away from its
# f32 run. The torch bf16 run must stay as close to JAX's f32 run as that,
# within a factor: rms(torch_bf16 - jax_f32) <= 3 * rms(jax_bf16 - jax_f32)
# (over seeds 1-4 and 11 the measured ratio was 0.67-1.94).
BF16_RMS_FACTOR = 3.0


@functools.lru_cache(maxsize=None)
def _params():
    jscfg, _ = cfgs(SMALL_SCORE)
    jccfg, _ = cfgs(SMALL_COMPRESSOR)
    sv = jax.jit(JaxScore(jscfg).init)(
        jax.random.key(1), jnp.zeros((2, jscfg.z_scale, jscfg.z_dim)),
        jnp.ones((2,)))
    cv = jax.jit(JaxCompressor(jccfg).init)(
        {"params": jax.random.key(2), "sample": jax.random.key(3)},
        jnp.zeros((2, POINTS, 3)))
    return params_np(sv), params_np(cv)


@functools.lru_cache(maxsize=None)
def _jax_generate(dtype_name):
    dtype, rng = DTYPES[dtype_name][0], jax.random.key(SEED)
    jscfg, _ = cfgs(SMALL_SCORE)
    jccfg, _ = cfgs(SMALL_COMPRESSOR)
    sp, cp = _params()
    score = JaxScore(jscfg, dtype=dtype, fused_attention=True)
    comp = JaxCompressor(jccfg, dtype=dtype, fused_attention=True)
    sde = JaxVPSDE(cfgs(dict(SDE, sample_N=STEPS))[0])

    @jax.jit
    def run(rng):
        mods = score.apply({"params": sp}, jnp.linspace(1.0, 1e-6, STEPS),
                           method=JaxScore.precompute_mods)

        def score_fn(t, x, step):
            m = jax.tree_util.tree_map(lambda a: a[step], mods)
            p = score.apply({"params": sp}, x, m,
                            method=JaxScore.denoise_with_mods)
            return -p.astype(jnp.float32) / sde.std(t)[:, None, None], p

        eps = jax_sample(sde, score_fn, rng, B,
                         (jscfg.z_scale, jscfg.z_dim), N=STEPS,
                         predictor="ancestral", time_eps=1e-6, denoise=True)
        return comp.apply({"params": cp}, (B, POINTS), eps,
                          method=JaxCompressor.sample)

    return to_np(run(rng))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_jax_with_its_draws(dtype):
    td = DTYPES[dtype][1]
    rng = jax.random.key(SEED)
    _, tscfg = cfgs(SMALL_SCORE)
    _, tccfg = cfgs(SMALL_COMPRESSOR)
    sp, cp = _params()
    score = load_score(Score(tscfg, dtype=td, device="cpu"), sp)
    comp = Compressor(tccfg, dtype=td, device="cpu")
    load_compressor_decoder(comp, cp)
    sde = make_diffusion(cfgs(dict(SDE, sample_N=STEPS))[1], device="cpu")
    x0, noise = _jax_draws(rng, STEPS, (B, tscfg.z_scale, tscfg.z_dim))
    got = generate(score, comp, sde, B, STEPS, device="cpu",
                   x0=torch.tensor(x0), noise=torch.tensor(noise))
    assert got.shape == (B, POINTS, 3) and got.dtype == td
    got = to_np(got)
    assert np.isfinite(got).all()
    ref = _jax_generate("float32")
    if dtype == "float32":
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= F32_REL * scale, (err, scale)
    else:
        def rms(a):
            return float(np.sqrt(np.mean((a - ref) ** 2)))

        jax_bf16 = _jax_generate("bfloat16")
        assert rms(got) <= BF16_RMS_FACTOR * rms(jax_bf16), (rms(got),
                                                             rms(jax_bf16))


def test_generate_from_a_generator_is_reproducible():
    _, tscfg = cfgs(SMALL_SCORE)
    _, tccfg = cfgs(SMALL_COMPRESSOR)
    g = torch.Generator().manual_seed(0)
    score = Score(tscfg, device="cpu", generator=g)
    comp = Compressor(tccfg, device="cpu", generator=g)
    sde = make_diffusion(cfgs(dict(SDE, sample_N=STEPS))[1], device="cpu")
    outs = [generate(score, comp, sde, 2, STEPS, device="cpu",
                     generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert torch.isfinite(outs[0]).all()
