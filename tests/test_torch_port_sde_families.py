"""The SDE families of ldt_torch against ldt_tpu on the CPU: every family
and importance-sampling mode of `iw_quantities` with the same uniform draws
rho (0, 0.5 and 1 - 2^-24 among them), `inv_var`, `cross_entropy_const`,
`sample_q`, the sampler's VE and sub-VP branches with JAX's draws, and the
continuous-t stage-2 objective against JAX's `draw_train_randoms`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.training.latent_sde_trainer as jlt
from ldt_tpu.diffusion import make_diffusion as jax_make_diffusion
from ldt_tpu.diffusion.sampling import sample_discrete as jax_sample
from ldt_tpu.models import Score as JaxScore
from ldt_torch.configs import latent_trainer_cfg
from ldt_torch.diffusion import make_diffusion
from ldt_torch.diffusion.sampling import sample_discrete
from ldt_torch.diffusion.sde import IW_MODES
from ldt_torch.models import Score
from ldt_torch.training.latent_sde_trainer import (
    Trainer,
    draw_train_randoms,
    score_objective,
)
from ldt_torch.weights import score_state_dict
from test_torch_port_common import F32_TOL, SDE, SMALL_SCORE, cfgs
from test_torch_port_sampling import _jax_pc_draws, _score_fns

FAMILIES = {
    "vpsde": {},
    "sub_vpsde": {},
    # LSGM's geometric VP: var(1) = sigma2_max - sigma2_min < 1
    "geometric_sde": dict(sigma2_min=3e-5, sigma2_max=0.999),
    # the VESDE needs sigma2_min == sigma2_0
    "vesde": dict(sigma2_0=0.01, sigma2_min=0.01, sigma2_max=50.0),
}
SIZE = 64
RHO = np.concatenate([[0.0, 0.5, 1.0 - 2.0 ** -24], np.random.default_rng(
    0).uniform(size=SIZE - 3)]).astype(np.float32)
# f32 formulas in the same order: torch's and XLA's exp, log, pow and
# erfinv differ by an ulp or so, which 1 - exp(-x) near t = time_eps
# amplifies (the sub-VP variance ~ (1 - e)^2: read 1.0e-5 relative) and the
# inverse variances pass on to t (VESDE ll_iw: 1.2e-6 absolute at t ~ 0.02).
IW_TOL = dict(rtol=3e-5, atol=1e-6)
# drop_all_iw's t through f32 erfinv, whose argument is within 1e-5 of 1
# for rho near 1: 2.4e-7 read here, 4.6e-6 over the whole of [0, 1].
DROP_ALL_T_ATOL = 1e-5


def _cfg_dict(family: str, **over) -> dict:
    return {**SDE, "sde_type": family, **FAMILIES[family], **over}


def _sdes(family: str, **over):
    jcfg, tcfg = cfgs(_cfg_dict(family, **over))
    return jax_make_diffusion(jcfg), make_diffusion(tcfg, device="cpu")


def _cases():
    for family in FAMILIES:
        for like_vp in ((False, True) if family == "sub_vpsde" else (False,)):
            for mode in IW_MODES:
                yield pytest.param(family, mode, like_vp,
                                   id=f"{family}{'-like_vp' * like_vp}-{mode}")


def _jax_iw(jsde, mode, like_vp, monkeypatch):
    """JAX's iw_quantities with its uniform draw replaced by RHO."""
    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform",
                  lambda key, shape: jnp.asarray(RHO).reshape(shape))
        return jsde.iw_quantities(jax.random.key(0), SIZE, 0.01, mode,
                                  like_vp)


@pytest.mark.parametrize("family,mode,like_vp", list(_cases()))
def test_iw_quantities_match_ldt_tpu(family, mode, like_vp, monkeypatch):
    jsde, tsde = _sdes(family)
    rho = torch.from_numpy(RHO)
    try:
        want = _jax_iw(jsde, mode, like_vp, monkeypatch)
    except (AssertionError, NotImplementedError) as e:
        # JAX asserts drop_all_iw on the geometric SDE; the port raises
        kind = NotImplementedError if isinstance(
            e, NotImplementedError) else ValueError
        with pytest.raises(kind, match=mode):
            tsde.iw_quantities(SIZE, 0.01, mode, like_vp, rho=rho)
        return
    got = tsde.iw_quantities(SIZE, 0.01, mode, like_vp, rho=rho)
    assert got[0].shape == (SIZE,)
    for name, g, w in zip(("t", "var", "m", "obj", "obj_ll", "g2"), got,
                          want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32, name
        assert np.isfinite(g).all(), name
        if name == "t" and mode == "drop_all_iw":
            np.testing.assert_allclose(g, w, rtol=0, atol=DROP_ALL_T_ATOL)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **IW_TOL)


def test_iw_quantities_draw_from_the_generator():
    _, tsde = _sdes("vpsde")
    runs = [tsde.iw_quantities(8, 0.01, "drop_all_iw",
                               generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[2][0])
    assert ((runs[0][0] >= 0.01 - 1e-4) & (runs[0][0] <= 1 + 1e-4)).all()
    with pytest.raises(ValueError, match="importance sampling"):
        tsde.iw_quantities(8, 0.01, "no_such_mode")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sde_functions_match_ldt_tpu(family):
    """f, g2, var, e2int_f, std on a t grid, inv_var where the family has
    it (the sub-VP SDE's raises in both), the VP variance pair of the
    sub-VP SDE and the VE's var_N pair, cross_entropy_const and sample_q."""
    jsde, tsde = _sdes(family)
    t = np.linspace(0.01, 1.0, 33).astype(np.float32)
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    for name in ("f", "g2", "var", "e2int_f", "std"):
        np.testing.assert_allclose(getattr(tsde, name)(tt).numpy(),
                                   np.asarray(getattr(jsde, name)(jt)),
                                   err_msg=name, **IW_TOL)
    pairs = {"vpsde": [("var", "inv_var")],
             "geometric_sde": [("var", "inv_var")],
             "vesde": [("var", "inv_var"), ("var_N", "inv_var_N")],
             "sub_vpsde": [("var_vpsde", "inv_var_vpsde")]}[family]
    for fwd, inv in pairs:
        v = getattr(jsde, fwd)(jt)
        got = getattr(tsde, inv)(torch.tensor(np.asarray(v))).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jsde, inv)(v)),
                                   err_msg=inv, **IW_TOL)
        np.testing.assert_allclose(got, t, rtol=1e-3, atol=1e-4)
    if family == "sub_vpsde":
        with pytest.raises(NotImplementedError):
            jsde.inv_var(jt)
        with pytest.raises(NotImplementedError):
            tsde.inv_var(tt)
    for eps in (0.01, 1e-5):
        got = tsde.cross_entropy_const(eps)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(),
                                   float(jsde.cross_entropy_const(eps)),
                                   **IW_TOL)
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((4, 3, 5)).astype(np.float32)
                 for _ in range(2))
    var = jsde.var(jt[:4])[:, None, None]
    m = jsde.e2int_f(jt[:4])[:, None, None]
    np.testing.assert_allclose(
        tsde.sample_q(torch.from_numpy(x0), torch.from_numpy(noise),
                      torch.tensor(np.asarray(var)),
                      torch.tensor(np.asarray(m))).numpy(),
        np.asarray(jsde.sample_q(jnp.asarray(x0), jnp.asarray(noise), var,
                                 m)), **F32_TOL)


def test_make_diffusion_builds_every_family_and_refuses_others():
    for family in FAMILIES:
        _, tsde = _sdes(family)
        assert tsde.sde_type == family
    with pytest.raises(ValueError, match="Unrecognized"):
        make_diffusion(cfgs(dict(SDE, sde_type="nope"))[1], device="cpu")
    with pytest.raises(ValueError, match="sigma2_min"):
        make_diffusion(cfgs(_cfg_dict("vesde", sigma2_0=0.0))[1],
                       device="cpu")


# The sampler at N = 16 with beta_end 10: beta_end / N stays below 1, so the
# correctors' discrete alpha stays positive. Same tolerance as the
# sampling file's (f32, the same arithmetic in another order).
SAMPLER_N, SHAPE = 16, (3, 4, 5)
SAMPLER_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family,case", [
    ("vesde", dict(predictor="reversediffusion", corrector="langevin",
                   snr=0.16)),
    ("vesde", dict(predictor="eulermaruyama", corrector="ancestral",
                   snr=0.16, denoise=False)),
    ("sub_vpsde", dict(predictor="reversediffusion", corrector="ancestral",
                       snr=0.16)),
    ("sub_vpsde", dict(predictor="eulermaruyama", corrector="langevin",
                       corrector_steps=2, snr=0.16)),
], ids=["vesde-rd-langevin", "vesde-em-ancestral", "subvp-rd-ancestral",
        "subvp-em-langevin2"])
def test_sampler_family_branches_match_jax(family, case):
    """The VESDE's N(0, sigma2_max) start and both families' corrector
    alpha (sub-VP: 1 - the beta table at the step's index; VE: 1)."""
    jsde, tsde = _sdes(family, beta_end=10.0, sample_N=SAMPLER_N)
    jax_fn, torch_fn = _score_fns(jsde, tsde, "float32")
    rng = jax.random.key(11)
    want = np.asarray(jax_sample(jsde, jax_fn, rng, SHAPE[0], SHAPE[1:],
                                 N=SAMPLER_N, time_eps=1e-6, **case))
    x0, noise, cnoise = _jax_pc_draws(rng, SAMPLER_N, SHAPE,
                                      case.get("corrector_steps", 1))

    def run(sde):
        return sample_discrete(
            sde, torch_fn, SHAPE[0], SHAPE[1:], SAMPLER_N, 1e-6,
            device="cpu", x0=torch.tensor(x0), noise=torch.tensor(noise),
            corrector_noise=torch.tensor(cnoise), **case).numpy()

    got = run(tsde)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **SAMPLER_TOL)
    # the other family's branch (start scale, corrector alpha) must miss
    other = _sdes("vpsde" if family == "vesde" else "vesde",
                  beta_end=10.0, sample_N=SAMPLER_N)[1]
    assert not np.allclose(run(other), want, **SAMPLER_TOL)


@pytest.mark.parametrize("family", ["sub_vpsde", "vesde", "geometric_sde"])
@pytest.mark.parametrize("predictor", ["ancestral", "ddim"])
def test_table_predictors_refuse_other_families(family, predictor):
    _, tsde = _sdes(family)
    with pytest.raises(NotImplementedError, match=family):
        sample_discrete(tsde, lambda t, x, i: (-x, x), 1, (2,), 64,
                        device="cpu", predictor=predictor)


# The continuous-t stage-2 objective: the JAX draws of one step replayed.
CONT_SDE = dict(SDE, iw_sample_p_mode="drop_all_iw",
                iw_sample_q_mode="drop_all_iw")
B, Z = 4, (SMALL_SCORE["z_scale"], SMALL_SCORE["z_dim"])


@pytest.mark.parametrize("family,mode", [("vpsde", "drop_all_iw"),
                                         ("sub_vpsde", "ll_iw"),
                                         ("vesde", "drop_sigma2t_iw")])
def test_continuous_train_draws_match_jax(family, mode):
    """JAX's `draw_train_randoms(discrete=False)` of one step (rho from its
    t key, eta from its eta key) replayed through the port's
    `Trainer.draws` and `draw_train_randoms`; for the VPSDE also the loss
    and every gradient of `score_objective` on them (XLA attention on the
    JAX side), and the loss of `Trainer.train_step` pinned by rho."""
    sde_d = _cfg_dict(family, iw_sample_p_mode=mode)
    jsde = jax_make_diffusion(cfgs(sde_d)[0])
    rng = jax.random.key(5)
    timesteps = jnp.linspace(1.0, SDE["sample_time_eps"], SDE["train_N"])
    subvp_like = family == "sub_vpsde"
    t, var, e2int, weight, eta, _ = jlt.draw_train_randoms(
        rng, 0, (B,) + Z, False, timesteps, SDE["train_N"], jsde, 0.01, mode,
        subvp_like)
    _, k_t, _, _ = jax.random.split(rng, 4)
    rho = torch.tensor(np.asarray(jax.random.uniform(k_t, (B,))))
    eta = torch.tensor(np.asarray(eta))

    trainer = Trainer(latent_trainer_cfg(score=SMALL_SCORE, sde=sde_d,
                                         opt=dict(discrete=False)),
                      device="cpu")
    assert trainer.subvp_like is subvp_like
    draws = trainer.draws((B,) + Z, False, rho=rho, eta=eta)
    assert torch.equal(draws[-1], eta)
    for g, w in zip(draws[:4], (t, var, e2int, weight)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **IW_TOL)
    same = draw_train_randoms(
        (B,) + Z, discrete=False, timesteps=trainer.timesteps,
        train_N=trainer.N, sde=trainer.sde, time_eps=0.01, iw_mode=mode,
        subvp_like=subvp_like, rho=rho, eta=eta)
    assert all(torch.equal(a, b) for a, b in zip(same, draws))
    if family != "vpsde":
        return

    jscore = JaxScore(cfgs(SMALL_SCORE)[0])
    params = jax.jit(jscore.init)(jax.random.key(0), jnp.zeros((2,) + Z),
                                  jnp.ones((2,)))["params"]
    eps = np.random.default_rng(2).standard_normal((B,) + Z).astype(
        np.float32)

    def loss(p):
        return jlt.score_objective(jscore, p, jnp.asarray(eps), t, var,
                                   e2int, weight, jnp.asarray(eta.numpy()),
                                   None, None, False, None, "l2")

    want, grads = jax.jit(jax.value_and_grad(loss))(params)
    score = Score(cfgs(SMALL_SCORE)[1], device="cpu")
    score.load_state_dict(score_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    got = score_objective(score, torch.from_numpy(eps), *draws)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **F32_TOL)
    # the trainer's own step on the same draws, pinned by rho
    trainer.maybe_init({"tr_points": np.zeros((2, 64, 3), np.float32)},
                       score_weights=score.state_dict())
    loss = trainer.train_step(torch.from_numpy(eps), 1e-4, rho=rho, eta=eta)
    np.testing.assert_allclose(loss.item(), float(want), **F32_TOL)
    want_g = score_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    for k, p in score.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   err_msg=k, **F32_TOL)
