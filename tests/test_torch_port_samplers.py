"""The samplers of ldt_torch's `diffusion/sampling.py` that the discrete
predictors do not cover, against ldt_tpu's on the CPU: `print_steps`, the
PNDM predictor and the adaptive RK45 probability-flow ODE
(`sample_model_ode`), first on analytic score functions, then on a 2-block
Score (weights through `ldt_torch.weights`; JAX's attention through its
Pallas kernels in interpret mode). Every draw is JAX's, pinned on the
torch side.

The ODE's step control reads an error estimate x5 - x4 that, at the
configs' ode_tol 1e-5 in f32, sits near the rounding of x itself: XLA:CPU
contracts JAX's jitted a * b + c into one FMA, so the jitted solver takes
other step sizes than the same arithmetic op by op (its first error norm
5.0e-4 against 3.0e-4 on the analytic score here). The port follows the
JAX function op by op: it is held to JAX's `sample_model_ode` with its
`lax.while_loop` run as a Python loop (each op JAX's own, the Score jitted
as one function) for the same steps, accepted steps and nfe, and to the
jitted solver, as the trainers run it, on the samples only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldt_tpu.diffusion import sampling as jsampling
from ldt_tpu.models import Score as JaxScore
from ldt_torch import weights
from ldt_torch.diffusion import sampling as tsampling
from ldt_torch.models import Score
from test_torch_port_common import SMALL_SCORE, cfgs, params_np, perturbed
from test_torch_port_diffusion import _jax_draws
from test_torch_port_sde_families import _sdes as _family_sdes

B, SHAPE = 3, (4, 5)
PNDM_N = 20
# Of the largest |value|, f32 in another order (the test_torch_port_generate
# limit 1e-4): PNDM against the jitted JAX sampler (read 2.8e-6 on the
# analytic score, 1.8e-5 on the Score: the last step's wrap to t = 1
# scales the rounding up); the ODE against JAX op by op (read 2.0e-6,
# 5.9e-6) and against the jitted solver, which takes other steps (read
# 1.9e-4 on the analytic score, 312 against 306 evaluations; 3.7e-7 on the
# Score, 234 against 258).
PNDM_REL = 1e-4
ODE_REL = 5e-5
ODE_JIT_REL = 2e-3
ODE_TOL, ODE_EPS = 1e-5, 1e-6


def _sdes(**over):
    return _family_sdes("vpsde", **over)


def _analytic(jsde, tsde):
    """eps = 0.7 (1 + t) x on each side (a smooth, t-dependent score)."""
    def jax_fn(t, x, step):
        p = 0.7 * x * (1 + t[:, None, None])
        return -p / jsde.std(t)[:, None, None], p

    def torch_fn(t, x, step):
        p = 0.7 * x * (1 + t[:, None, None])
        return -p / tsde.std(t)[:, None, None], p

    return jax_fn, torch_fn


SCORE = dict(SMALL_SCORE, num_blocks=2)


def _score_fns(jsde, tsde):
    """The 2-block Score on each side on the same perturbed weights: the
    JAX one jitted as one function."""
    jcfg, tcfg = cfgs(SCORE)
    model = JaxScore(jcfg, fused_attention=True)
    v = jax.jit(model.init)(jax.random.key(0),
                            jnp.zeros((2, SCORE["z_scale"], SCORE["z_dim"])),
                            jnp.ones((2,)))
    params = perturbed({"params": params_np(v)})["params"]
    apply = jax.jit(lambda x, t: model.apply({"params": params}, x, t))
    score = weights.load_score(Score(tcfg, device="cpu"), params)

    def jax_fn(t, x, step):
        p = apply(x, t)
        return -p / jsde.std(t)[:, None, None], p

    def torch_fn(t, x, step):
        with torch.no_grad():
            p = score(x, t)
        return -p / tsde.std(t)[:, None, None], p

    return jax_fn, torch_fn


def _shape(kind):
    return (B,) + (SHAPE if kind == "analytic" else
                   (SCORE["z_scale"], SCORE["z_dim"]))


def _fns(kind, jsde, tsde):
    return (_analytic if kind == "analytic" else _score_fns)(jsde, tsde)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


# --- print_steps -------------------------------------------------------------

@pytest.mark.parametrize("predictor", ["ancestral", "ddim"])
def test_print_steps_matches_jax(predictor):
    """The initial draw, x_mean every (N-1)//(print_steps-2) steps and the
    result, stacked [K, B, ...], at N=64 (beta_end / N below 1)."""
    n = 64
    jsde, tsde = _sdes(sample_N=n)
    jfn, tfn = _analytic(jsde, tsde)
    rng = jax.random.key(2)
    shape = (B,) + SHAPE
    x0, noise = _jax_draws(rng, n, shape)
    for print_steps in (5, 7):
        want = np.asarray(jsampling.sample_discrete(
            jsde, jfn, rng, B, SHAPE, N=n, predictor=predictor,
            time_eps=1e-6, print_steps=print_steps))
        got = tsampling.sample_discrete(
            tsde, tfn, B, SHAPE, n, 1e-6, predictor=predictor, device="cpu",
            x0=torch.from_numpy(x0), noise=torch.from_numpy(noise),
            print_steps=print_steps).numpy()
        interval = (n - 1) // (print_steps - 2)
        assert got.shape == want.shape == (n // interval + 2,) + shape
        np.testing.assert_array_equal(got[0], x0)
        assert _rel(got, want) <= PNDM_REL
        plain = tsampling.sample_discrete(
            tsde, tfn, B, SHAPE, n, 1e-6, predictor=predictor, device="cpu",
            x0=torch.from_numpy(x0), noise=torch.from_numpy(noise))
        assert torch.equal(plain, torch.from_numpy(got[-1]))


def test_print_steps_is_refused_for_pndm():
    jsde, tsde = _sdes(sample_N=PNDM_N)
    jfn, tfn = _analytic(jsde, tsde)
    with pytest.raises(AssertionError, match="print_steps"):
        jsampling.sample_discrete(jsde, jfn, jax.random.key(0), B, SHAPE,
                                  N=PNDM_N, predictor="pndm", print_steps=5)
    with pytest.raises(ValueError, match="print_steps"):
        tsampling.sample_discrete(tsde, tfn, B, SHAPE, PNDM_N,
                                  predictor="pndm", device="cpu",
                                  print_steps=5)


# --- PNDM --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["analytic", "score"])
def test_pndm_matches_jax(kind):
    """N=20 PNDM steps (3 Runge-Kutta, 17 Adams-Bashforth: 29 evaluations)
    from JAX's x0 (drawn from the key itself, unscaled), the last step's
    wrap to t = 1.0 kept; the evaluations' times, counted."""
    jsde, tsde = _sdes(sample_N=PNDM_N)
    jfn, tfn = _fns(kind, jsde, tsde)
    rng = jax.random.key(4)
    shape = _shape(kind)
    want = np.asarray(jax.jit(lambda r: jsampling.sample_discrete(
        jsde, jfn, r, B, shape[1:], N=PNDM_N, predictor="pndm",
        time_eps=1e-6))(rng))
    x0 = np.asarray(jax.random.normal(rng, shape))
    seen = []

    def counted(t, x, step):
        seen.append((float(t[0]), step))
        return tfn(t, x, step)

    got = tsampling.sample_discrete(tsde, counted, B, shape[1:], PNDM_N,
                                    1e-6, predictor="pndm", device="cpu",
                                    x0=torch.from_numpy(x0)).numpy()
    assert np.isfinite(got).all() and _rel(got, want) <= PNDM_REL
    assert len(seen) == PNDM_N + 9
    ts = np.linspace(1e-6, 1.0, 2 * PNDM_N, dtype=np.float32)
    assert seen[0] == (1.0, 0) and seen[3][0] == pytest.approx(ts[-3])
    assert seen[-1] == (pytest.approx(float(ts[1])), PNDM_N - 1)


def test_pndm_refuses_a_family_without_its_tables():
    """PNDM reads the VPSDE's train_N and betas: JAX fails on the sub-VP
    SDE (no train_N), and so does the port, by name."""
    jsde, tsde = _family_sdes("sub_vpsde")
    with pytest.raises(AttributeError, match="train_N"):
        jsampling.sample_discrete(jsde, lambda t, x, s: (-x, x),
                                  jax.random.key(0), 1, (2,), N=PNDM_N,
                                  predictor="pndm")
    with pytest.raises(NotImplementedError, match="sub_vpsde"):
        tsampling.sample_discrete(tsde, lambda t, x, s: (-x, x), 1, (2,),
                                  PNDM_N, predictor="pndm", device="cpu")


def test_pndm_draws_x0_from_the_generator():
    _, tsde = _sdes(sample_N=PNDM_N)
    runs = [tsampling.sample_discrete(
        tsde, lambda t, x, s: (-x, 0.5 * x), 2, SHAPE, PNDM_N,
        predictor="pndm", device="cpu",
        generator=torch.Generator().manual_seed(seed)) for seed in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# --- the probability-flow ODE ------------------------------------------------

def _jax_ode_op_by_op(monkeypatch, jsde, jfn, rng, shape, **kw):
    """JAX's `sample_model_ode` with its while_loop run as a Python loop
    (every op of the solver JAX's own, eagerly): (x, nfe, the t of each
    step)."""
    ts = []

    def while_loop(cond, body, state):
        while cond(state):
            state = body(state)
            ts.append(float(state[0]))
        return state

    monkeypatch.setattr(jsampling.lax, "while_loop", while_loop)
    x, nfe = jsampling.sample_model_ode(jsde, jfn, rng, shape[0], shape[1:],
                                        ode_eps=ODE_EPS,
                                        ode_solver_tol=ODE_TOL, **kw)
    monkeypatch.undo()
    return np.asarray(x), int(nfe), ts


@pytest.mark.parametrize("kind", ["analytic", "score"])
def test_ode_matches_jax_step_for_step(kind, monkeypatch):
    """Dormand-Prince RK45 from t=1 to ode_eps at atol = rtol = 1e-5: the
    same steps, accepted and rejected, and nfe (6 a step tried) as JAX's
    solver op by op, the final t at ode_eps, the samples within ODE_REL;
    against the jitted solver the samples within ODE_JIT_REL."""
    jsde, tsde = _sdes()
    jfn, tfn = _fns(kind, jsde, tsde)
    rng = jax.random.key(3)
    shape = _shape(kind)
    want, nfe, ts = _jax_ode_op_by_op(monkeypatch, jsde, jfn, rng, shape)
    noise = torch.from_numpy(np.asarray(jax.random.normal(rng, shape)))
    stats = {}
    got, got_nfe = tsampling.sample_model_ode(
        tsde, tfn, B, shape[1:], ODE_EPS, ODE_TOL, device="cpu", noise=noise,
        stats=stats)
    accepted = sum(a != b for a, b in zip([1.0] + ts, ts))
    assert (got_nfe, stats["steps"], stats["accepted"]) == \
        (nfe, len(ts), accepted), (stats, nfe, len(ts), accepted)
    assert stats["nfe"] == nfe == 6 * len(ts)
    assert stats["rejected"] == len(ts) - accepted > 0
    # the last step lands within f32 rounding of ode_eps
    stop = np.float32(ODE_EPS + 1e-12)
    assert np.float32(stats["t"]) <= stop and np.float32(ts[-1]) <= stop
    assert stats["t"] == pytest.approx(ODE_EPS, rel=1e-5)
    assert not stats["capped"]
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) <= ODE_REL
    jitted, jit_nfe = jax.jit(lambda r: jsampling.sample_model_ode(
        jsde, jfn, r, B, shape[1:], ode_eps=ODE_EPS,
        ode_solver_tol=ODE_TOL))(rng)
    assert _rel(got, jitted) <= ODE_JIT_REL


def test_ode_max_steps_and_the_vesde_prior():
    """`max_steps` caps the loop (reported as capped, t short of ode_eps);
    the VESDE scales the pinned draw by sqrt(sigma2_max) as JAX does."""
    jsde, tsde = _sdes()
    jfn, tfn = _analytic(jsde, tsde)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.key(3), (B,) + SHAPE)))
    stats = {}
    _, nfe = tsampling.sample_model_ode(tsde, tfn, B, SHAPE, device="cpu",
                                        noise=noise, max_steps=3,
                                        stats=stats)
    assert nfe == 18 and stats["capped"] and stats["t"] > 0.5
    jve, tve = _family_sdes("vesde")
    seen = {}

    def first(t, x, step):
        seen.setdefault("x", x.clone())
        return -x, x

    tsampling.sample_model_ode(tve, first, B, SHAPE, device="cpu",
                               noise=noise, max_steps=1)
    np.testing.assert_allclose(seen["x"].numpy(),
                               noise.numpy() * np.sqrt(np.float32(
                                   jve.sigma2_max)), rtol=1e-6)
