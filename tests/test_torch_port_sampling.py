"""The predictors and correctors of ldt_torch's `sample_discrete` vs
ldt_tpu's on the CPU, every draw JAX's own (pinned on the torch side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldt_tpu.diffusion.sampling import sample_discrete as jax_sample
from ldt_torch.diffusion.sampling import sample_discrete
from test_torch_port_diffusion import _sdes

N, SHAPE = 64, (3, 4, 5)
# f32, the same arithmetic in another order over 64 steps (as PR 1's
# ancestral trajectory test).
TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_pc_draws(rng, n, shape, corrector_steps):
    """The draws of jax's sample_discrete from `rng`: x0 from
    split(rng)[1]; at each step split(step_rng, 3) -> (step_rng, k1, k2),
    the predictor's draw from k1 and corrector step j's from the j-th
    split(k2 chain)[1]."""
    rng, init_rng = jax.random.split(rng)
    x0 = jax.random.normal(init_rng, shape)
    noise, cnoise, step_rng = [], [], rng
    for _ in range(n):
        step_rng, k1, k2 = jax.random.split(step_rng, 3)
        noise.append(jax.random.normal(k1, shape))
        row = []
        for _ in range(corrector_steps):
            k2, k = jax.random.split(k2)
            row.append(jax.random.normal(k, shape))
        cnoise.append(jnp.stack(row))
    return (np.asarray(x0), np.asarray(jnp.stack(noise)),
            np.asarray(jnp.stack(cnoise)))


def _score_fns(jsde, tsde, params_dtype):
    """A step-dependent score_fn for each side: eps = g_i tanh(x) std(t),
    returned in `params_dtype` as the networks return it."""
    gains = np.linspace(0.5, 1.5, N).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[params_dtype]

    def jax_fn(t, x, step):
        std = jsde.std(t)[:, None, None]
        p = (jnp.asarray(gains)[step] * jnp.tanh(x) * std).astype(jd)
        return -p.astype(jnp.float32) / std, p

    def torch_fn(t, x, step):
        std = tsde.std(t)[:, None, None]
        p = (float(gains[step]) * torch.tanh(x) * std).to(td)
        return -p.float() / std, p

    return jax_fn, torch_fn


CASES = {
    "reversediffusion": dict(predictor="reversediffusion"),
    "ancestral": dict(predictor="ancestral"),
    "ddim": dict(predictor="ddim"),
    "ddim_bf16_eps": dict(predictor="ddim", params_dtype="bfloat16"),
    "eulermaruyama": dict(predictor="eulermaruyama"),
    "reversediffusion_pf": dict(predictor="reversediffusion",
                                probability_flow=True),
    "eulermaruyama_pf": dict(predictor="eulermaruyama",
                             probability_flow=True),
    "ancestral_no_denoise": dict(predictor="ancestral", denoise=False),
    "ancestral+langevin": dict(predictor="ancestral", corrector="langevin",
                               corrector_steps=2, snr=0.16),
    "reversediffusion+ancestral": dict(predictor="reversediffusion",
                                       corrector="ancestral",
                                       corrector_steps=2, snr=0.16),
    "ddim+ancestral": dict(predictor="ddim", corrector="ancestral",
                           snr=0.16),
    "langevin_only": dict(predictor=None, corrector="langevin", snr=0.16,
                          denoise=False),
}


def _wrong_draws(case, x0, noise, cnoise):
    """One draw in the wrong place: the predictor's and the corrector's
    swapped; else the steps' draws in reverse order; else (DDIM and the
    probability flow use only x0) x0 and the first step's draw swapped."""
    if case.get("corrector"):
        return x0, cnoise[:, 0].copy(), np.concatenate(
            [noise[:, None], cnoise[:, 1:]], axis=1)
    if case["predictor"] != "ddim" and not case.get("probability_flow"):
        return x0, noise[::-1].copy(), cnoise
    return noise[0].copy(), np.concatenate([x0[None], noise[1:]]), cnoise


@pytest.mark.parametrize("name", list(CASES))
def test_sampler_matches_jax_with_its_draws(name):
    case = dict(CASES[name])
    params_dtype = case.pop("params_dtype", "float32")
    jsde, tsde = _sdes(N)
    jax_fn, torch_fn = _score_fns(jsde, tsde, params_dtype)
    rng = jax.random.key(7)
    want = np.asarray(jax_sample(jsde, jax_fn, rng, SHAPE[0], SHAPE[1:], N=N,
                                 time_eps=1e-6, **case))
    draws = _jax_pc_draws(rng, N, SHAPE, case.get("corrector_steps", 1))

    def run(x0, noise, cnoise):
        return sample_discrete(
            tsde, torch_fn, SHAPE[0], SHAPE[1:], N, 1e-6, device="cpu",
            x0=torch.tensor(x0), noise=torch.tensor(noise),
            corrector_noise=torch.tensor(cnoise), **case).numpy()

    got = run(*draws)
    assert got.shape == SHAPE and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    wrong = run(*_wrong_draws(case, *draws))
    assert not np.allclose(wrong, want, **TOL)


def test_corrector_alpha_table_within_ulps_of_jax():
    """The correctors' `discrete_alpha` is 1 - jnp.linspace(beta_start / N,
    beta_end / N, N); the port takes 1 - its own beta table."""
    jsde, tsde = _sdes(1000)
    want = 1.0 - jnp.linspace(jsde.beta_start / 1000, jsde.beta_end / 1000,
                              1000)
    np.testing.assert_array_max_ulp((1.0 - tsde.betas).numpy(),
                                    np.asarray(want), maxulp=2)


@pytest.mark.parametrize("kw", [dict(predictor="pndm"),
                                dict(corrector="heun")])
def test_unported_predictors_and_correctors_raise(kw):
    """A corrector the JAX package lacks raises; `pndm`, once refused here,
    samples (held against JAX in test_torch_port_samplers.py)."""
    _, tsde = _sdes(N)
    if kw.get("predictor") == "pndm":
        out = sample_discrete(tsde, lambda t, x, i: (-x, 0.5 * x), 1, (2,),
                              N, device="cpu", **kw)
        assert out.shape == (1, 2) and torch.isfinite(out).all()
        return
    with pytest.raises(NotImplementedError):
        sample_discrete(tsde, lambda t, x, i: (-x, x), 1, (2,), N,
                        device="cpu", **kw)


def test_generator_draws_are_reproducible_for_each_corrector():
    _, tsde = _sdes(N)
    outs = [sample_discrete(tsde, lambda t, x, i: (-x, x), 2, (3,), N,
                            device="cpu", corrector=c, corrector_steps=2,
                            generator=torch.Generator().manual_seed(4))
            for c in ("langevin", "langevin", "ancestral")]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    assert all(torch.isfinite(o).all() for o in outs)

