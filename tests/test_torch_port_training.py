"""Stage-2 training: ldt_torch.training against ldt_tpu.training on the CPU.

One step's loss and every gradient against JAX's `score_objective` under
`jax.value_and_grad` (the DiT's attention through the Pallas kernels K1 and
K3 in interpret mode), three optimizer steps against optax (params, both
Adam moments, EMA), the learning-rate schedule, and whole `Trainer.update`
steps (encode, draws, loss, Adam, EMA) with every draw pinned."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.state as jstate
from ldt_tpu.diffusion import make_diffusion as jax_make_diffusion
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.training.latent_sde_trainer import (
    score_objective as jax_score_objective,
)
from ldt_torch.configs import latent_trainer_cfg
from ldt_torch.diffusion import make_diffusion
from ldt_torch.models import Score
from ldt_torch.training import state as tstate
from ldt_torch.training.base import BaseTrainer
from ldt_torch.training.latent_sde_trainer import (
    Trainer,
    draw_train_randoms,
    score_objective,
)
from ldt_torch.weights import compressor_state_dict, score_state_dict
from test_torch_port_common import (
    F32_TOL,
    SDE,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    cfgs,
)

B = 4
Z = (SMALL_SCORE["z_scale"], SMALL_SCORE["z_dim"])
TRAIN_N = SDE["train_N"]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _score_params():
    jcfg, _ = cfgs(SMALL_SCORE)
    return _np(JaxScore(jcfg).init(jax.random.key(0), jnp.zeros((2,) + Z),
                                   jnp.ones((2,)))["params"])


@functools.lru_cache(maxsize=None)
def _compressor_variables():
    jcfg, _ = cfgs(SMALL_COMPRESSOR)
    return _np(jax.jit(jcm.Compressor(jcfg).init)(
        {"params": jax.random.key(1), "sample": jax.random.key(2)},
        jnp.asarray(_rand((2, 64, 3), 3))))


def _jax_model():
    jcfg, _ = cfgs(SMALL_SCORE)
    return JaxScore(jcfg, fused_attention=True)


def _jax_draws(idx):
    jsde = jax_make_diffusion(cfgs(SDE)[0])
    t = jnp.linspace(1.0, SDE["sample_time_eps"], TRAIN_N)[jnp.asarray(idx)]
    return (t, jsde.var(t)[:, None, None], jsde.e2int_f(t)[:, None, None],
            jnp.ones((len(idx), 1, 1)))


def _jax_loss_and_grads(params, eps, idx, eta, loss_type="l2"):
    t, var, e2int, weight = _jax_draws(idx)

    def loss(p):
        return jax_score_objective(_jax_model(), p, jnp.asarray(eps), t, var,
                                   e2int, weight, jnp.asarray(eta), None,
                                   None, True, jax.random.key(9), loss_type)

    return jax.value_and_grad(loss)(params)


def _assert_tree(got: dict, want_tree, **tol):
    want = score_state_dict(_np(want_tree))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   err_msg=k, **(tol or F32_TOL))


def test_sde_training_quantities_match():
    t = np.linspace(1.0, 1e-6, 17).astype(np.float32)
    jsde = jax_make_diffusion(cfgs(SDE)[0])
    sde = make_diffusion(cfgs(SDE)[1], device="cpu")
    for name in ("e2int_f", "var"):
        np.testing.assert_allclose(
            getattr(sde, name)(torch.from_numpy(t)).numpy(),
            np.asarray(getattr(jsde, name)(jnp.asarray(t))), **F32_TOL)


def test_draws_pin_and_match_the_jax_table():
    _, tcfg = cfgs(SDE)
    sde = make_diffusion(tcfg, device="cpu")
    trainer_t = Trainer(latent_trainer_cfg(sde=SDE), device="cpu").timesteps
    idx = np.array([0, 1, 500, 998, 999])
    eta = _rand((5,) + Z, 4)
    t, var, e2int, weight, got_eta = draw_train_randoms(
        eta.shape, discrete=True, timesteps=trainer_t, train_N=TRAIN_N,
        sde=sde, t_idx=torch.from_numpy(idx), eta=torch.from_numpy(eta))
    want = _jax_draws(idx)
    for g, w in zip((t, var, e2int, weight), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    assert torch.equal(got_eta, torch.from_numpy(eta))
    gen = torch.Generator().manual_seed(0)
    t, *_, eta = draw_train_randoms((64,) + Z, discrete=True,
                                    timesteps=trainer_t, train_N=TRAIN_N,
                                    sde=sde, generator=gen)
    assert eta.shape == (64,) + Z and (t >= 1e-6).all() and (t <= 1).all()
    # continuous t (held against JAX in test_torch_port_sde_families.py):
    # importance-sampled, the weight its objective weight
    t, var, e2int, weight, eta = draw_train_randoms(
        (64,) + Z, discrete=False, timesteps=trainer_t, train_N=TRAIN_N,
        sde=sde, time_eps=0.01, iw_mode="drop_all_iw", generator=gen)
    assert ((t >= 0.01 - 1e-4) & (t <= 1 + 1e-4)).all()
    assert weight.shape == var.shape == e2int.shape == (64, 1, 1)
    assert not torch.equal(weight, torch.ones_like(weight))


@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_one_step_loss_and_every_gradient_match_jax(loss_type):
    params = _score_params()
    eps, eta = _rand((B,) + Z, 5), _rand((B,) + Z, 6)
    idx = np.array([3, 250, 600, 999])
    want_loss, want_grads = _jax_loss_and_grads(params, eps, idx, eta,
                                                loss_type)
    _, tcfg = cfgs(SMALL_SCORE)
    score = Score(tcfg, device="cpu")
    score.load_state_dict(score_state_dict(params))
    sde = make_diffusion(cfgs(SDE)[1], device="cpu")
    draws = draw_train_randoms(
        eps.shape, discrete=True,
        timesteps=torch.linspace(1.0, 1e-6, TRAIN_N), train_N=TRAIN_N,
        sde=sde, t_idx=torch.from_numpy(idx), eta=torch.from_numpy(eta))
    loss = score_objective(score, torch.from_numpy(eps), *draws,
                           loss_type=loss_type)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **F32_TOL)
    _assert_tree({k: p.grad for k, p in score.named_parameters()},
                 want_grads)


def _grad_tree(seed, scale):
    """A gradient tree of the params' structure, N(0, scale^2) leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        _score_params())


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]


@pytest.mark.parametrize("weight_decay,clip", [(0.0, 1.0), (0.01, 0.5),
                                               (0.0, None)])
def test_three_optimizer_steps_match_optax(weight_decay, clip):
    """Steps 1 and 3 clip (global norm > max), step 2 does not; the EMA is
    seeded at step 0 and blends after."""
    lr, decay = 1e-3, 0.9
    params = _score_params()
    jtx = jstate.make_optimizer(0.9, 0.999, weight_decay, clip)
    js = jstate.TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                                  jtx, ema=True)
    tparams = {k: v.clone() for k, v in score_state_dict(params).items()}
    ttx = tstate.make_optimizer(0.9, 0.999, weight_decay, clip)
    ts = tstate.TrainState.create(tparams, ttx, ema=True)
    for step, scale in enumerate((0.3, 0.001, 1.0)):
        grads = _grad_tree(10 + step, scale)
        norm = np.sqrt(sum(np.sum(np.square(g)) for g in
                           jax.tree_util.tree_leaves(grads)))
        assert (norm > 1.0) == (step != 1), norm
        js = jstate.apply_update(js, jax.tree_util.tree_map(jnp.asarray,
                                                            grads),
                                 jtx, lr, ema_decay=decay)
        tstate.apply_update(ts, score_state_dict(grads), ttx, lr,
                            ema_decay=decay)
    assert ts.step == int(js.step) == 3
    adam = _adam(js.opt_state)
    assert ts.opt_state.count == int(adam.count) == 3
    _assert_tree(ts.params, js.params)
    _assert_tree(ts.ema_params, js.ema_params)
    _assert_tree(ts.opt_state.mu, adam.mu)
    # nu ~ g^2: compare relative to its scale
    _assert_tree(ts.opt_state.nu, adam.nu, rtol=1e-5, atol=1e-9)


def test_the_clip_is_optax_not_torch():
    """optax clips only at |g| >= max and divides by |g| exactly; torch's
    clip_grad_norm_ scales by max / (|g| + 1e-6) whenever that is < 1."""
    tx = tstate.make_optimizer(grad_clip=1.0)
    g = {"w": torch.full((4,), 0.5)}                  # |g| = 1.0: clipped
    state = tx.init(g)
    tx.update(g, state, {"w": torch.zeros(4)})
    assert torch.equal(state.mu["w"], torch.full((4,), 0.05))
    g = {"w": torch.full((4,), 0.4999999)}            # |g| < 1: untouched
    state = tx.init(g)
    tx.update(g, state, {"w": torch.zeros(4)})
    assert torch.equal(state.mu["w"], 0.1 * torch.full((4,), 0.4999999))


def test_lr_schedule_matches():
    jfn = jstate.make_lr_fn(1e-4, 20, 50)
    tfn = tstate.make_lr_fn(1e-4, 20, 50)
    for itr in (0, 1, 10, 19, 20, 21, 100):
        for epoch in (1, 2, 7, 50):
            for start in (None, 0, 19, 20, 21, 80):
                assert tfn(itr, epoch, start) == jfn(itr, epoch, start)


def test_base_trainer_gates_the_cosine_at_epoch_starts():
    """Warm-up over 5 iterations of 3-iteration epochs: the cosine engages
    at the first epoch that starts after the warm-up, not mid-epoch."""
    cfg = latent_trainer_cfg(opt=dict(lr=1e-3, warmup_iters=5),
                             common=dict(epochs=10))
    trainer = BaseTrainer(cfg)
    jfn = jstate.make_lr_fn(1e-3, 5, 10)
    seen = []
    for _ in range(4):
        for _ in range(3):
            lr = trainer.current_lr()
            assert lr == jfn(trainer.itr, trainer.epoch,
                             trainer._itr_epoch_start)
            seen.append(lr)
            trainer.itr += 1
        trainer.epoch_end()
    assert seen[:5] == pytest.approx([1e-3 * (i + 1) / 5 for i in range(5)])
    assert seen[5] == 1e-3 and seen[6] != 1e-3  # itr 6 starts epoch 3
    trainer.base_lr = 5e-4  # the watchdog's halving rebuilds the schedule
    assert trainer.current_lr() == jstate.make_lr_fn(5e-4, 5, 10)(
        trainer.itr, trainer.epoch, trainer._itr_epoch_start)


def _trainer_cfg():
    return latent_trainer_cfg(score=SMALL_SCORE, compressor=SMALL_COMPRESSOR,
                              sde=SDE, opt=dict(warmup_iters=1,
                                                ema_decay=0.9))


def test_trainer_updates_match_jax(monkeypatch):
    """Two `Trainer.update` steps (encode with pinned noise, pinned t and
    eta, loss, Adam at lr 1e-4, EMA seeded then blended) against the JAX
    trainer's encode and train-step pieces."""
    pts = [_rand((B, 64, 3), 20 + i) for i in range(2)]
    noise = [[_rand((B, SMALL_COMPRESSOR["z_scales"],
                     SMALL_COMPRESSOR["z_dim"]), 30 + 2 * i + j)
              for j in range(SMALL_COMPRESSOR["n_layers"])] for i in range(2)]
    idx = [np.array([7, 70, 700, 999]), np.array([0, 333, 666, 998])]
    eta = [_rand((B,) + Z, 40 + i) for i in range(2)]

    cfg = _trainer_cfg()
    trainer = Trainer(cfg, device="cpu")
    trainer.maybe_init({"tr_points": pts[0]},
                       score_weights=score_state_dict(_score_params()),
                       compressor_weights=compressor_state_dict(
                           _compressor_variables()))
    jcfg, _ = cfgs(SMALL_COMPRESSOR)
    jcomp = jcm.Compressor(jcfg, fused_attention=True)
    jtx = jstate.make_optimizer(0.9, 0.999, 0.0, 1.0)
    js = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, _score_params()), jtx, ema=True)
    for i in range(2):
        draws = iter(noise[i])
        monkeypatch.setattr(jcm, "reparameterize",
                            lambda rng, mu, logvar: mu + jnp.exp(logvar / 2)
                            * jnp.asarray(next(draws)))
        eps = jcomp.apply(_compressor_variables(), jnp.asarray(pts[i]),
                          rngs={"sample": jax.random.key(0)})["all_eps"]
        want_loss, grads = _jax_loss_and_grads(js.params, np.asarray(eps),
                                               idx[i], eta[i])
        lr = jstate.make_lr_fn(1e-4, 1, 6000)(i, 1, 0)
        js = jstate.apply_update(js, grads, jtx, lr, ema_decay=0.9)
        assert trainer.current_lr() == lr
        loss = trainer.update({"tr_points": pts[i]},
                              t_idx=torch.from_numpy(idx[i]),
                              eta=torch.from_numpy(eta[i]),
                              enc_noise=[torch.from_numpy(e)
                                         for e in noise[i]])
        np.testing.assert_allclose(loss.item(), float(want_loss), **F32_TOL)
    assert trainer.itr == trainer.state.step == 2
    st = trainer.state
    _assert_tree(st.params, js.params)
    _assert_tree(st.ema_params, js.ema_params)
    _assert_tree(st.opt_state.mu, _adam(js.opt_state).mu)
    _assert_tree(st.opt_state.nu, _adam(js.opt_state).nu, rtol=1e-5,
                 atol=1e-9)


def test_val_loss_and_sample_use_the_ema_params():
    cfg = _trainer_cfg()
    trainer = Trainer(cfg, device="cpu")
    pts = _rand((B, 64, 3), 50)
    trainer.update({"tr_points": pts})
    trainer.update({"tr_points": pts})
    before = {k: p.detach().clone() for k, p in trainer.state.params.items()}
    idx, eta = torch.tensor([1, 2, 3, 4]), torch.from_numpy(_rand((B,) + Z,
                                                                  51))
    noise = [torch.from_numpy(_rand((B, SMALL_COMPRESSOR["z_scales"],
                                     SMALL_COMPRESSOR["z_dim"]), 52 + j))
             for j in range(SMALL_COMPRESSOR["n_layers"])]
    got = trainer.val_loss({"te_points": pts}, t_idx=idx, eta=eta,
                           enc_noise=noise)
    # the same objective on a Score that holds the EMA params
    ema_score = Score(cfg.score, device="cpu")
    ema_score.load_state_dict(trainer.state.ema_params)
    eps = trainer.encode(torch.from_numpy(pts), noise)
    with torch.no_grad():
        want = score_objective(ema_score, eps, *draw_train_randoms(
            eps.shape, discrete=True, timesteps=trainer.timesteps,
            train_N=TRAIN_N, sde=trainer.sde, t_idx=idx, eta=eta))
    assert torch.equal(got, want)
    clouds, latents = trainer.sample(2)
    assert clouds.shape == (2, 64, 3) and latents.shape == (2,) + Z
    assert torch.isfinite(clouds).all()
    for k, p in trainer.state.params.items():  # the swap was undone
        assert torch.equal(p, before[k]), k


def test_trainer_random_init_takes_actnorm_from_the_first_batch():
    trainer = Trainer(_trainer_cfg(), device="cpu")
    pts = _rand((B, 64, 3), 60)
    trainer.maybe_init({"tr_points": pts})
    comp = trainer.compressor
    assert not any(p.requires_grad for p in comp.parameters())
    shift = comp.conv_in.shift.clone()
    comp.init_actnorm(torch.from_numpy(pts[:2]))
    assert torch.equal(comp.conv_in.shift, shift)
    assert comp.conv_in.shift.abs().sum() > 0
