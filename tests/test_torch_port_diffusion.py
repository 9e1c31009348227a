"""ldt_torch VPSDE and ancestral sampler vs ldt_tpu on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldt_tpu.diffusion import DiffusionVPSDE as JaxVPSDE
from ldt_tpu.diffusion.sampling import sample_discrete as jax_sample
from ldt_torch.diffusion import DiffusionVPSDE, make_diffusion
from ldt_torch.diffusion.sampling import (
    ancestral_indices,
    sample_discrete,
    timesteps,
)
from test_torch_port_common import SDE, cfgs


def _sdes(n):
    jcfg, tcfg = cfgs(dict(SDE, sample_N=n))
    return JaxVPSDE(jcfg), make_diffusion(tcfg, device="cpu")


@pytest.mark.parametrize("n", [32, 64, 250, 1000])
def test_schedule_within_an_ulp_of_jnp_linspace(n):
    """torch's and XLA's f32 linspace round differently; the difference
    stays below one ulp of 1.0."""
    want = np.asarray(jnp.linspace(1.0, 1e-6, n))
    got = timesteps(n, 1e-6).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= np.finfo(np.float32).eps


@pytest.mark.parametrize("n", [64, 1000])
def test_vpsde_tables(n):
    jsde, tsde = _sdes(n)
    assert isinstance(tsde, DiffusionVPSDE)
    np.testing.assert_array_max_ulp(tsde.betas.numpy(),
                                    np.asarray(jsde.betas), maxulp=2)
    np.testing.assert_allclose(tsde.alphas_cump.numpy(),
                               np.asarray(jsde.alphas_cump), rtol=1e-5,
                               atol=1e-7)
    t = np.linspace(1.0, 1e-6, 17).astype(np.float32)
    for fn in ("f", "g2", "var", "std"):
        np.testing.assert_allclose(
            getattr(tsde, fn)(torch.from_numpy(t)).numpy(),
            np.asarray(getattr(jsde, fn)(jnp.asarray(t))), rtol=1e-6,
            atol=1e-7, err_msg=fn)


def test_ancestral_beta_index_sequence_at_1000_steps():
    n = 1000
    t = jnp.linspace(1.0, 1e-6, n)
    want = np.asarray((t * (n - 1) / 1.0).astype(jnp.int32))
    got = ancestral_indices(timesteps(n, 1e-6), n).numpy()
    assert np.array_equal(got, want)
    assert got[0] == n - 1 and got[-1] == 0


def _jax_draws(rng, n, shape):
    """The draws jax's sample_discrete makes from `rng`: x0 from
    split(rng)[1], step i's noise from split(step_rng, 3)[1]."""
    rng, init_rng = jax.random.split(rng)
    x0 = jax.random.normal(init_rng, shape)
    noise, step_rng = [], rng
    for _ in range(n):
        step_rng, k1, _ = jax.random.split(step_rng, 3)
        noise.append(jax.random.normal(k1, shape))
    return np.asarray(x0), np.asarray(jnp.stack(noise))


def test_pinned_noise_ancestral_trajectory():
    """N=64 (beta_end/N < 1), a step-dependent score_fn shared by both."""
    n, shape = 64, (3, 4, 5)
    jsde, tsde = _sdes(n)
    gains = np.linspace(0.5, 1.5, n).astype(np.float32)

    def jax_fn(t, x, step):
        p = jnp.asarray(gains)[step] * jnp.tanh(x) * jsde.std(t)[:, None, None]
        return -p / jsde.std(t)[:, None, None], p

    def torch_fn(t, x, step):
        p = float(gains[step]) * torch.tanh(x) * tsde.std(t)[:, None, None]
        return -p / tsde.std(t)[:, None, None], p

    rng = jax.random.key(3)
    want = jax_sample(jsde, jax_fn, rng, shape[0], shape[1:], N=n,
                      predictor="ancestral", time_eps=1e-6)
    x0, noise = _jax_draws(rng, n, shape)
    got = sample_discrete(tsde, torch_fn, shape[0], shape[1:], n,
                          time_eps=1e-6, device="cpu",
                          x0=torch.tensor(x0), noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_sampler_rejects_tables_of_another_length():
    _, tsde = _sdes(64)
    with pytest.raises(ValueError):
        sample_discrete(tsde, lambda t, x, step: (-x, x), 1, (2,), 32,
                        device="cpu")


@pytest.mark.parametrize("kind", ["sub_vpsde", "vesde", "geometric_sde"])
def test_other_sdes_are_not_ported_yet(kind):
    _, tcfg = cfgs(dict(SDE, sde_type=kind))
    with pytest.raises(NotImplementedError):
        make_diffusion(tcfg, device="cpu")
