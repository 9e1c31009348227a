"""The Score's dropout (`score.dropout`) against ldt_tpu on the CPU, and the
places where the JAX package's dropout raises.

The JAX side draws every mask: a wrapper of `flax.linen.Dropout.__call__`
(flax's own code, the keep mask recorded in call order) runs inside the
JAX package's modules, and the port takes those masks (`DropoutMasks(
masks=...)`). Nothing in ldt_tpu changes. Held: flax's formula in f32 and
bf16; the Score's train-mode forward and gradients (plain and UNet); the
stage-2 step and the hybrid score step with JAX's masks; dropout off in
`val_loss` and `sample`; the generator's masks. A Compressor trains with
no dropout in the JAX package (its train-mode forward asks for a 'dropout'
rng that no trainer passes) and neither does the conditional Score's step:
the port raises there too.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import InvalidRngError
from flax.linen.module import wrap_method_once

import ldt_tpu.training.latent_sde_trainer as jlt
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch.models import Compressor, Score
from ldt_torch.nn.layers import DropoutMasks, dropout
from ldt_torch.tools.io import dict2namespace
from ldt_torch.training import compressor_trainer as tct
from ldt_torch.training import completion_latent_sde_trainer as tclt
from ldt_torch.training import hybrid_trainer as tht
from ldt_torch.training import latent_sde_trainer as tlt
from ldt_torch.weights import (
    compressor_variables,
    score_params,
    score_state_dict,
    score_variables,
)
from test_torch_port_checkpoint import run_cfg
from test_torch_port_common import (
    F32_TOL,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
)

B, N = 2, 64
RATE = 0.1
SCORE = dict(SMALL_SCORE, num_blocks=2, dropout=RATE)
UNET = dict(SCORE, unet=True)
C = SMALL_COMPRESSOR
Z = (SCORE["z_scale"], SCORE["z_dim"])
LR = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jx(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tree)


def record_flax_masks(mp) -> list:
    """flax's `Dropout.__call__` (0.12), its keep mask appended to the
    returned list in call order; the output is flax's own."""
    masks = []

    def call(self, inputs, deterministic=None, rng=None):
        deterministic = nn.merge_param("deterministic", self.deterministic,
                                       deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep_prob = 1.0 - self.rate
        if rng is None:
            rng = self.make_rng(self.rng_collection)
        mask = jax.random.bernoulli(rng, p=keep_prob, shape=inputs.shape)
        masks.append(mask)
        return jax.lax.select(mask, inputs / keep_prob,
                              jnp.zeros_like(inputs))

    mp.setattr(nn.Dropout, "__call__", wrap_method_once(call))
    return masks


def _torch_masks(masks):
    return [torch.from_numpy(np.asarray(m)) for m in masks]


@pytest.fixture(scope="module")
def weights():
    gen = torch.Generator().manual_seed(2)
    return {name: dict(Score(dict2namespace(d), device="cpu",
                             generator=gen).state_dict())
            for name, d in (("plain", SCORE), ("unet", UNET))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_is_flax_dropout(dtype, monkeypatch):
    """where(keep, x / keep_prob, 0) with the division rounded in x's dtype
    (keep_prob rounded to it first, as JAX's weak-typed scalar), bit for
    bit; the identity without masks (deterministic) and at rate 0."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = _rand((4, 8, 32), 1)
    masks = record_flax_masks(monkeypatch)
    want = nn.Dropout(RATE).apply({}, jnp.asarray(x, jdt), False,
                                  rngs={"dropout": jax.random.key(3)})
    got = dropout(_t(x).to(tdt), RATE,
                  DropoutMasks(masks=_torch_masks(masks)))
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    xt = _t(x).to(tdt)
    assert dropout(xt, RATE, None) is xt
    assert dropout(xt, 0.0, DropoutMasks()) is xt
    assert not dropout(xt, 1.0, DropoutMasks()).any()


@pytest.mark.parametrize("name", ["plain", "unet"])
def test_score_train_forward_and_gradients_match_jax(name, weights,
                                                     monkeypatch):
    """The Score's train-mode forward with JAX's masks: 2 per block
    (after the attention's fc_o, after the MLP's activation), in the
    blocks' order, up, mid and down for the UNet; output and every
    gradient at f32 tolerance. Without masks (eval) the forward is the
    deterministic one."""
    d = UNET if name == "unet" else SCORE
    sd = weights[name]
    x, t = _rand((B,) + Z, 5), np.array([0.2, 0.8], np.float32)
    masks = record_flax_masks(monkeypatch)
    model = JaxScore(jax_ns(dict(d)))

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                          train=True, rngs={"dropout": jax.random.key(4)})
        return jnp.sum(out * jnp.asarray(_rand(out.shape, 6))), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        _jx(score_params(sd)))
    assert len(masks) == 2 * d["num_blocks"] + (2 if name == "unet" else 0)
    score = Score(dict2namespace(d), device="cpu")
    score.load_state_dict(sd)
    got = score(_t(x), _t(t), train=True,
                dropout=DropoutMasks(masks=_torch_masks(masks)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    torch.sum(got * _t(_rand(got.shape, 6))).backward()
    want_g = score_state_dict(_np(grads))
    for k, p in score.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(),
                                   err_msg=k, **F32_TOL)
    with torch.no_grad():
        plain = score(_t(x), _t(t))
    det = model.apply({"params": _jx(score_params(sd))}, jnp.asarray(x),
                      jnp.asarray(t))
    np.testing.assert_allclose(plain.numpy(), np.asarray(det), **F32_TOL)
    assert not np.allclose(plain.numpy(), got.detach().numpy(), atol=1e-3)


def test_a_train_forward_without_masks_raises(weights):
    """As flax's apply without a 'dropout' rng (InvalidRngError)."""
    with pytest.raises(InvalidRngError):
        JaxScore(jax_ns(dict(SCORE))).apply(
            {"params": _jx(score_params(weights["plain"]))},
            jnp.zeros((B,) + Z), jnp.ones((B,)), train=True)
    score = Score(dict2namespace(SCORE), device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        score(torch.zeros((B,) + Z), torch.ones(B), train=True)


def _cfg(save_path, **opt):
    d = run_cfg(save_path, score=SCORE)
    d["opt"].update(dict(lr=LR, warmup_iters=0), **opt)
    return d


def _jax_score_step(params, eps, idx, eta, masks_key=7):
    """JAX's stage-2 objective with its dropout (key `masks_key`) under
    `jax.value_and_grad` (eager: the recorded masks are concrete)."""
    jcfg = jax_ns(_cfg(""))
    sde = jlt.make_diffusion(jcfg.sde)
    t = jnp.linspace(1.0, jcfg.sde.sample_time_eps, jcfg.sde.train_N)[
        jnp.asarray(idx)]
    return jax.value_and_grad(lambda p: jlt.score_objective(
        JaxScore(jcfg.score), p, jnp.asarray(eps), t,
        sde.var(t)[:, None, None], sde.e2int_f(t)[:, None, None],
        jnp.ones((len(idx), 1, 1)), jnp.asarray(eta), None, None, True,
        jax.random.key(masks_key), "l2"))(params)


def _captured(mp, module):
    seen = []
    real = module.apply_update

    def apply_update(state, grads, *a, **kw):
        seen.append({k: g.clone() for k, g in grads.items()})
        return real(state, grads, *a, **kw)

    mp.setattr(module, "apply_update", apply_update)
    return seen


def _assert_grads(got, want_tree):
    want = score_state_dict(_np(want_tree))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **F32_TOL)


def test_stage2_step_with_dropout_matches_jax(tmp_path, weights,
                                              monkeypatch):
    """`train_step` on pinned latents, t, eta and JAX's dropout masks: the
    loss, every gradient, and the parameters after Adam."""
    sd = weights["plain"]
    eps, eta = _rand((B,) + Z, 10), _rand((B,) + Z, 11)
    idx = np.array([4, 444])
    masks = record_flax_masks(monkeypatch)
    params = _jx(score_params(sd))
    want, grads = _jax_score_step(params, eps, idx, eta)
    assert len(masks) == 2 * SCORE["num_blocks"]
    tr = tlt.Trainer(dict2namespace(_cfg(tmp_path)), device="cpu")
    tr.maybe_init({"tr_points": _rand((B, N, 3), 1)}, score_weights=sd)
    seen = _captured(monkeypatch, tlt)
    loss = tr.train_step(_t(eps), LR, t_idx=torch.from_numpy(idx),
                         eta=_t(eta), dropout=_torch_masks(masks))
    np.testing.assert_allclose(loss.item(), float(want), **F32_TOL)
    _assert_grads(seen[0], grads)
    import ldt_tpu.training.state as jstate

    tx = jstate.make_optimizer(0.9, 0.999, 0.0, 1.0)
    js = jstate.apply_update(jstate.TrainState.create(params, tx), grads,
                             tx, LR)
    want_p = score_state_dict(_np(js.params))
    for k, p in tr.state.params.items():
        # within Adam's first-step bound: an attention's key bias has no
        # gradient but f32 noise, whose sign either framework may step by
        assert float((p.detach() - want_p[k]).abs().max()) <= 2 * LR, k


def test_hybrid_score_step_uses_dropout_and_its_kl_term_does_not(
        tmp_path, weights, monkeypatch):
    """The hybrid step: its KL term's Score forward is deterministic (no
    mask taken), its score step (the stage-2 step) drops out with JAX's
    masks: loss_score and every Score gradient against JAX's objective on
    the KL term's eps."""
    sd = weights["plain"]
    d = _cfg(tmp_path)
    d["opt"].update(alpha=0.1, compressor_warmup=0, compressor_beta1=0.9,
                    compressor_beta2=0.999, discrete=True)
    tr = tht.Trainer(dict2namespace(d), device="cpu")
    pts = _rand((B, N, 3), 20, 0.5)
    tr.maybe_init({"tr_points": pts}, score_weights=sd)
    idx, eta = np.array([8, 88]), _rand((B,) + Z, 21)
    seen = _captured(monkeypatch, tlt)
    eps_seen = []
    real = tr.train_step

    def train_step(eps, *a, **kw):
        eps_seen.append(eps.clone())
        return real(eps, *a, **kw)

    monkeypatch.setattr(tr, "train_step", train_step)
    masks = record_flax_masks(monkeypatch)
    want, grads = _jax_score_step(_jx(score_params(sd)), np.zeros(
        (B,) + Z, np.float32), idx, eta)  # records the masks' shapes
    pinned = DropoutMasks(masks=_torch_masks(masks), record=True)
    monkeypatch.setattr(tr, "dropout_masks", lambda m=None: pinned)
    loss_score, _, _ = tr.update({"tr_points": pts},
                                 t_idx=torch.from_numpy(idx), eta=_t(eta))
    assert len(pinned.drawn) == len(masks) == 2 * SCORE["num_blocks"]
    masks.clear()
    want, grads = _jax_score_step(_jx(score_params(sd)),
                                  eps_seen[0].numpy(), idx, eta)
    assert len(masks) == 2 * SCORE["num_blocks"]
    for got_m, want_m in zip(pinned.drawn, masks):
        assert np.array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(loss_score.item(), float(want), **F32_TOL)
    _assert_grads(seen[0], grads)


def test_eval_paths_run_without_dropout(tmp_path, weights):
    """`val_loss` and `sample` with dropout 0.1 equal those with 0.0 on
    the same weights and draws."""
    out = []
    for rate in (RATE, 0.0):
        d = _cfg(tmp_path)
        d["score"] = dict(SCORE, dropout=rate)
        tr = tlt.Trainer(dict2namespace(d), device="cpu",
                         generator=torch.Generator().manual_seed(5))
        tr.maybe_init({"tr_points": _rand((B, N, 3), 1)},
                      score_weights=weights["plain"])
        pts = {"te_points": _rand((B, N, 3), 2)}
        noise = [_t(_rand((B, C["z_scales"], C["z_dim"]), 3 + i))
                 for i in range(C["n_layers"])]
        v = tr.val_loss(pts, t_idx=torch.tensor([1, 2]),
                        eta=_t(_rand((B,) + Z, 4)), enc_noise=noise)
        clouds, latents = tr.sample(2)
        out.append((v, clouds, latents))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_generator_masks_repeat_by_seed_and_keep_their_share(tmp_path,
                                                             weights):
    """The trainer's own draws: one seed gives one step bit for bit,
    another seed another; the kept share is within a binomial bound of
    0.9."""
    steps = []
    for seed in (0, 0, 1):
        tr = tlt.Trainer(dict2namespace(_cfg(tmp_path)), device="cpu",
                         generator=torch.Generator().manual_seed(seed))
        tr.maybe_init({"tr_points": _rand((B, N, 3), 1)},
                      score_weights=weights["plain"])
        masks = DropoutMasks(tr.generator, record=True)
        tr.dropout_masks = lambda m=None, _d=masks: _d
        loss = tr.train_step(_t(_rand((B,) + Z, 2)), LR,
                             t_idx=torch.tensor([3, 300]),
                             eta=_t(_rand((B,) + Z, 3)))
        steps.append((loss, dict(tr.state.params), masks.drawn))
    (l0, p0, m0), (l1, p1, m1), (l2, p2, m2) = steps
    assert torch.equal(l0, l1) and not torch.equal(l0, l2)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    kept = torch.cat([m.flatten() for m in m0]).float()
    n = kept.numel()
    bound = 5 * np.sqrt(0.9 * 0.1 / n)
    assert abs(kept.mean().item() - 0.9) <= bound, (kept.mean(), n)


@pytest.mark.parametrize("key", ["encoder_dropout_p", "decoder_dropout_p"])
def test_compressor_dropout_evaluates_and_refuses_training(key, tmp_path):
    """A Compressor with a nonzero rate: eval and sampling run and equal
    the rate-0 net's on the same weights (deterministic); a train-mode
    forward raises in both packages (JAX: no 'dropout' rng), and so does
    the stage-1 trainer's step."""
    cfg = dict(C, **{key: RATE})
    pts = _rand((B, N, 3), 7)
    gen = torch.Generator().manual_seed(3)
    zero = Compressor(dict2namespace(C), device="cpu", generator=gen)
    zero.init_actnorm(_t(pts))
    comp = Compressor(dict2namespace(cfg), device="cpu")
    comp.load_state_dict(zero.state_dict())
    noise = [_t(_rand((B, C["z_scales"], C["z_dim"]), 8 + i))
             for i in range(C["n_layers"])]
    with torch.no_grad():
        a = comp(_t(pts), noise=noise)
        b = zero(_t(pts), noise=noise)
        assert torch.equal(a["set"], b["set"])
        eps = a["all_eps"]
        assert torch.equal(comp.sample((B, N), eps), zero.sample((B, N),
                                                                 eps))
    v = _jx(compressor_variables(dict(zero.state_dict())))
    jmodel = JaxCompressor(jax_ns(cfg))
    jmodel.apply(v, jnp.asarray(pts), rngs={"sample": jax.random.key(0)})
    with pytest.raises(InvalidRngError):
        jmodel.apply(v, jnp.asarray(pts), train=True,
                     rngs={"sample": jax.random.key(0)},
                     mutable=["batch_stats"])
    with pytest.raises(ValueError, match="dropout"):
        comp(_t(pts), noise=noise, train=True)
    with pytest.raises(ValueError, match="dropout"):
        comp.init_actnorm(_t(pts), train=True)
    d = run_cfg(tmp_path)
    d["model"] = cfg
    with pytest.raises(ValueError, match="dropout"):
        tct.Trainer(dict2namespace(d), device="cpu").update(
            {"tr_points": pts})


def test_the_conditional_step_with_dropout_raises(tmp_path):
    """The completion stage 2: the JAX step's train-mode apply passes no
    'dropout' rng and raises; the port's step raises too."""
    cond_score = dict(SCORE, condition=True)
    img = np.random.default_rng(0).uniform(0, 1, (B, 16, 16, 3)).astype(
        np.float32)
    cond = {"img": img, "pts": _rand((B, N, 3), 1, 0.5)}
    sd = dict(Score(dict2namespace(cond_score), device="cpu").state_dict())
    v = _jx(score_variables(sd))
    with pytest.raises(InvalidRngError):
        JaxScore(jax_ns(cond_score)).apply(
            v, jnp.zeros((B,) + Z), jnp.ones((B,)), None,
            {k: jnp.asarray(x) for k, x in cond.items()}, train=True,
            mutable=["batch_stats"])
    d = _cfg(tmp_path)
    d["score"] = cond_score
    tr = tclt.Trainer(dict2namespace(d), device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        tr.update(_rand((B, N, 3), 2), cond)
