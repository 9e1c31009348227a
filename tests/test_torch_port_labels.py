"""Label conditioning, ldt_torch against ldt_tpu on the CPU: the
LabelEmbedding, the label-conditioned Score (its forward and the sampler
that runs it whole at every step), the class-conditional Compressor (its
forward with labels and its label-free `sample`), one update of each trainer
with labels, and the multi-category `valsample` (stage 2) and
`reconstruction` (stage 1). Every draw is pinned to JAX's; the JAX nets run
their attention through the Pallas kernels in interpret mode. Tolerances are
the neighbouring tests' for the same computations: f32 forwards 1e-5
(test_torch_port_layers), bf16 a few ulps of the largest value, the 64-step
sampler 1e-4 of the largest value (test_torch_port_generate), a train step's
loss and gradients rtol 1e-4 (test_torch_port_stage1.STEP_TOL,
test_torch_port_training), the evaluations as test_torch_port_eval_trainers.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.nn.layers as jl
import ldt_tpu.training.compressor_trainer as jct
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_torch.training.base as tbase
import ldt_torch.training.compressor_trainer as tct
import ldt_torch.training.latent_sde_trainer as tlt
from chip_smoke import synthetic_shapes
from ldt_tpu.diffusion import DiffusionVPSDE as JaxVPSDE
from ldt_tpu.diffusion.sampling import sample_discrete as jax_sample
from ldt_tpu.models import Score as JaxScore
from ldt_torch import weights
from ldt_torch.configs import compressor_trainer_cfg, latent_trainer_cfg
from ldt_torch.diffusion import make_diffusion
from ldt_torch.generate import sample_latents
from ldt_torch.models import Compressor, Score
from ldt_torch.nn import layers as tl
from ldt_torch.training.compressor_trainer import Trainer as Stage1
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from test_torch_port_common import (
    DTYPES,
    SDE,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    assert_close,
    cfgs,
    compressor_variables,
    params_np,
    perturbed,
    pin_reparameterize,
    to_np,
    trees_equal,
)
from test_torch_port_diffusion import _jax_draws
from test_torch_port_eval_trainers import (
    CLOUD_TOL,
    SAMPLE_REL,
    _assert_scores_match,
    _jax_cfg,
    _loader,
    _recorder,
)

CATS = 5
SCORE_L = dict(SMALL_SCORE, num_categorys=CATS)
COMP_L = dict(SMALL_COMPRESSOR, class_condition=True, num_categorys=CATS)
B, N = 4, SMALL_COMPRESSOR["outsize"]
LABELS = np.array([0, 3, 4, 3])
STEPS = 64      # the label sampler's steps (beta_end / N below 1)
F32_REL = 1e-4  # test_torch_port_generate's f32 limit
STEP_TOL = dict(rtol=1e-4, atol=1e-6)  # test_torch_port_stage1.STEP_TOL


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_label_embedding_matches_and_converts(dtype):
    jd, td = DTYPES[dtype]
    jm = jl.LabelEmbedding(CATS, 8, 16, dtype=jd)
    v = _np(jm.init(jax.random.key(0), jnp.asarray(LABELS)))
    want = jm.apply(v, jnp.asarray(LABELS))
    tm = tl.LabelEmbedding(CATS, 8, 16, dtype=td)
    sd = {}
    weights._label_embedding(sd, "m", v["params"], "m")
    tm.load_state_dict({k[2:]: t for k, t in sd.items()})
    got = tm(torch.from_numpy(LABELS))
    assert got.dtype == td and got.shape == (B, 16)
    assert_close(got, want, dtype)
    if dtype == "float32":
        e = weights._Entries(dict(tm.state_dict()))
        e.sd = {f"m.{k}": t for k, t in e.sd.items()}
        assert trees_equal(weights._label_embedding_inv(e, "m"),
                           v["params"])
        e.done()


def test_label_embedding_init_is_standard_normal():
    tm = tl.LabelEmbedding(64, 32, 8)
    tl.init_weights_(tm, torch.Generator().manual_seed(0))
    w = tm.embed.weight.detach()
    assert abs(w.mean().item()) < 0.1 and abs(w.std().item() - 1) < 0.1


@functools.lru_cache(maxsize=None)
def _score_params():
    jcfg, _ = cfgs(SCORE_L)
    v = jax.jit(JaxScore(jcfg).init)(
        jax.random.key(1), jnp.zeros((2, jcfg.z_scale, jcfg.z_dim)),
        jnp.ones((2,)), jnp.asarray(LABELS[:2]))
    return params_np(v)


def _score(dtype=torch.float32):
    return weights.load_score(Score(cfgs(SCORE_L)[1], dtype=dtype,
                                    device="cpu"), _score_params())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_with_labels_matches(dtype):
    """c = t_emb + LabelEmbedding(label); without a label c = t_emb."""
    jd, td = DTYPES[dtype]
    x = _rand((B, SMALL_SCORE["z_scale"], SMALL_SCORE["z_dim"]), 2)
    t = np.linspace(0.9, 0.05, B).astype(np.float32)
    jm = JaxScore(cfgs(SCORE_L)[0], dtype=jd, fused_attention=True)
    score = _score(td)
    for label in (LABELS, None):
        want = jm.apply({"params": _score_params()}, jnp.asarray(x),
                        jnp.asarray(t),
                        None if label is None else jnp.asarray(label))
        with torch.no_grad():
            got = score(_t(x), _t(t),
                        None if label is None else torch.from_numpy(label))
        assert_close(got, want, dtype)
    with torch.no_grad():
        other = score(_t(x), _t(t), torch.from_numpy((LABELS + 1) % CATS))
    assert np.abs(to_np(other) - to_np(got)).max() > 1e-2


def test_score_with_labels_converts_both_ways():
    sd = weights.score_state_dict(_score_params())
    assert "label_embedding.embed.weight" in sd
    assert sd["label_embedding.embed.weight"].shape == (CATS,
                                                        SCORE_L["t_dim"])
    assert trees_equal(weights.score_params(_score().state_dict()),
                       _score_params())


def test_a_label_needs_a_label_embedding():
    score = Score(cfgs(SMALL_SCORE)[1], device="cpu")
    x = torch.zeros(2, SMALL_SCORE["z_scale"], SMALL_SCORE["z_dim"])
    with pytest.raises(ValueError, match="num_categorys"):
        score(x, torch.ones(2), torch.zeros(2, dtype=torch.long))


def _jax_label_sampler(rng, label):
    """The JAX trainer's sampler with a label (`fast_mods` off): the whole
    Score at every step, ancestral, denoised."""
    jcfg, _ = cfgs(SCORE_L)
    model = JaxScore(jcfg, fused_attention=True)
    sde = JaxVPSDE(cfgs(dict(SDE, sample_N=STEPS))[0])
    params = _score_params()

    def score_fn(t, x, step=None):
        p = model.apply({"params": params}, x, t, label)
        return -p / sde.std(t)[:, None, None], p

    return jax.jit(lambda r: jax_sample(
        sde, score_fn, r, B, (jcfg.z_scale, jcfg.z_dim), N=STEPS,
        predictor="ancestral", time_eps=1e-6, denoise=True))(rng)


def test_label_sampler_matches_jax_and_runs_the_whole_score(monkeypatch):
    rng = jax.random.key(5)
    want = to_np(_jax_label_sampler(rng, jnp.asarray(LABELS)))
    score = _score()
    sde = make_diffusion(cfgs(dict(SDE, sample_N=STEPS))[1], device="cpu")
    x0, noise = _jax_draws(rng, STEPS, want.shape)
    calls = []
    real = Score.forward

    def forward(self, x, t, label=None):
        calls.append(label)
        return real(self, x, t, label)

    def no_mods(*a, **k):
        raise AssertionError("a label-conditioned run hoists no modulations")

    monkeypatch.setattr(Score, "forward", forward)
    monkeypatch.setattr(Score, "precompute_mods", no_mods)
    got = to_np(sample_latents(score, sde, B, STEPS, device="cpu",
                               label=torch.from_numpy(LABELS),
                               x0=torch.tensor(x0),
                               noise=torch.tensor(noise)))
    assert len(calls) == STEPS
    assert all(torch.equal(c, torch.from_numpy(LABELS)) for c in calls)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= F32_REL * scale, (err, scale)
    with pytest.raises(ValueError, match="int8"):
        sample_latents(score, sde, B, STEPS, device="cpu", int8=True,
                       label=torch.from_numpy(LABELS))


@functools.lru_cache(maxsize=None)
def _comp_variables():
    return perturbed(compressor_variables(COMP_L, _rand((B, N, 3), 0),
                                          LABELS))


def _compressor():
    return weights.load_compressor(
        Compressor(cfgs(COMP_L)[1], device="cpu").eval(), _comp_variables())


def _noise(seed, b=B):
    return [_rand((b, COMP_L["z_scales"], COMP_L["z_dim"]), seed + i)
            for i in range(COMP_L["n_layers"])]


def test_class_conditional_compressor_forward_matches(monkeypatch):
    """The label embedding joins the position embedding and conditions
    every decoder block (AdaLN), with pinned reparameterization noise."""
    pts, noise, v = _rand((B, N, 3), 6), _noise(10), _comp_variables()
    pin_reparameterize(monkeypatch, noise)
    want = jcm.Compressor(cfgs(COMP_L)[0], fused_attention=True).apply(
        v, jnp.asarray(pts), label=jnp.asarray(LABELS),
        rngs={"sample": jax.random.key(0)})
    model = _compressor()
    with torch.no_grad():
        got = model(_t(pts), noise=[_t(e) for e in noise],
                    label=torch.from_numpy(LABELS))
        unlabelled = model(_t(pts), noise=[_t(e) for e in noise])
    for key in ("set", "all_eps", "max"):
        assert_close(got[key], want[key], "float32")
    for g, w in zip(got["kls"], want["kls"]):
        assert_close(g, w, "float32")
    assert not torch.allclose(unlabelled["all_eps"], got["all_eps"],
                              atol=1e-3)
    assert all(hasattr(model.decoder[i].att1, "adaLN")
               for i in range(COMP_L["n_layers"]))


def test_class_conditional_sample_runs_the_unconditioned_decoder():
    """`sample` passes no label (the reference's and the JAX package's):
    the decoder blocks run their unconditioned branch, non-affine norms and
    all."""
    eps = _rand((B, COMP_L["z_scales"], COMP_L["n_layers"] * COMP_L["z_dim"]),
                12)
    want = jcm.Compressor(cfgs(COMP_L)[0], fused_attention=True).apply(
        _comp_variables(), (B, N), jnp.asarray(eps),
        method=jcm.Compressor.sample)
    model = _compressor()
    with torch.no_grad():
        got = model.sample((B, N), _t(eps))
        o = model.init_set(B, N)
        z = COMP_L["z_dim"]
        for idx in range(COMP_L["n_layers"]):
            blk = model.decoder[COMP_L["n_layers"] - 1 - idx].att1
            y = model.decoder[COMP_L["n_layers"] - 1 - idx].ln(
                _t(eps[..., idx * z:(idx + 1) * z]))
            q = blk.act(blk.norm1(o))
            o = o + blk.attn(q, y)
            o = o + blk.mlp(blk.act(blk.norm2(o)))
    assert_close(got, want, "float32")
    assert torch.equal(got, model.output_dense(o))
    assert model.decoder[0].att1.norm1.weight is None  # non-affine


def test_class_conditional_compressor_converts_both_ways():
    v = _comp_variables()
    model = _compressor()
    assert set(weights.compressor_state_dict(v)) == set(model.state_dict())
    back = weights.compressor_variables(model.state_dict())
    assert trees_equal(back["params"], v["params"])
    assert trees_equal(back["batch_stats"], v["batch_stats"])
    assert "label_embedding" in back["params"]
    assert "adaLN" in back["params"]["decoder_0"]["att1"]


def _params_of(tree, stats):
    sd = weights.compressor_state_dict({"params": _np(tree),
                                        "batch_stats": stats})
    return {k: v for k, v in sd.items() if "running_" not in k}


def _captured_grads(monkeypatch, module):
    """The gradients each trainer hands the optimizer (before its clip)."""
    seen = {}
    real = module.apply_update

    def apply_update(state, grads, *a, **kw):
        seen.update({k: g.clone() for k, g in grads.items()})
        return real(state, grads, *a, **kw)

    monkeypatch.setattr(module, "apply_update", apply_update)
    return seen


def _stub_rec(s, p, xp):
    """A reconstruction term both frameworks compute alike (the real chamfer
    + EMD are held by test_torch_port_stage1)."""
    return xp.mean(xp.square(s - p))


def test_stage1_update_with_labels_matches_jax(monkeypatch):
    """One `Trainer.update` on a batch with `cate_idx`: the labels reach
    the forward (loss and every gradient against `compressor_objective`
    with the label under `jax.value_and_grad`)."""
    v0 = compressor_variables(COMP_L, _rand((B, N, 3), 0), LABELS,
                              train=True)
    pts, noise = _rand((B, N, 3), 20), _noise(30)
    pin_reparameterize(monkeypatch, noise)
    model = jcm.Compressor(cfgs(COMP_L)[0], fused_attention=True)

    def loss_fn(p):
        return jct.compressor_objective(
            model, p, v0["batch_stats"], jnp.asarray(pts),
            jnp.asarray(LABELS), jax.random.key(0), 1e-3,
            rec_fn=lambda s, q: _stub_rec(s, q, jnp))

    (want, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, v0["params"]))
    cfg = compressor_trainer_cfg(model=COMP_L, opt=dict(kl_weight=1e-3),
                                 data=dict(num_categorys=CATS))
    trainer = Stage1(cfg, device="cpu")
    trainer.maybe_init({"tr_points": pts},
                       weights=weights.compressor_state_dict(v0))
    monkeypatch.setattr(tct, "CD_loss", lambda s, q: _stub_rec(s, q, torch))
    monkeypatch.setattr(tct, "EMD_loss", lambda s, q: 0.0)
    tgrads = _captured_grads(monkeypatch, tct)
    got = trainer.update({"tr_points": pts, "cate_idx": LABELS},
                         noise=[_t(e) for e in noise])[0]
    np.testing.assert_allclose(got.item(), float(want), **STEP_TOL)
    jgrads = _params_of(grads, v0["batch_stats"])
    assert set(tgrads) == set(jgrads)
    for k, g in jgrads.items():
        scale = max(float(g.abs().max()), 1e-3)
        err = float((tgrads[k] - g).abs().max())
        assert err <= 1e-4 * scale, (k, err, scale)
    assert tgrads["label_embedding.embed.weight"].abs().max() > 1e-6
    assert trainer.state.step == 1


def test_stage2_update_with_labels_matches_jax(monkeypatch):
    """One `Trainer.update` on a batch with `cate_idx`: the labels reach the
    frozen class-conditional encode and the Score (c = t_emb + l_emb);
    loss and every gradient against the JAX trainer's pieces."""
    cv, sp = _comp_variables(), _score_params()
    pts, noise = _rand((B, N, 3), 40), _noise(50)
    z = (SCORE_L["z_scale"], SCORE_L["z_dim"])
    t_idx = np.array([3, 500, 999, 42])
    eta = _rand((B,) + z, 60)
    pin_reparameterize(monkeypatch, noise)
    jcomp = jcm.Compressor(cfgs(COMP_L)[0], fused_attention=True)
    eps = jcomp.apply(cv, jnp.asarray(pts), label=jnp.asarray(LABELS),
                      rngs={"sample": jax.random.key(0)})["all_eps"]
    cfg = latent_trainer_cfg(score=SCORE_L, compressor=COMP_L, sde=SDE,
                             data=dict(num_categorys=CATS))
    trainer = Stage2(cfg, device="cpu")
    trainer.maybe_init({"tr_points": pts},
                       score_weights=weights.score_state_dict(sp),
                       compressor_weights=weights.compressor_state_dict(cv))
    sde = JaxVPSDE(cfgs(SDE)[0])
    t = jnp.linspace(1.0, 1e-6, 1000)[t_idx]
    var = sde.var(t)[:, None, None]
    e2int = sde.e2int_f(t)[:, None, None]
    model = JaxScore(cfgs(SCORE_L)[0], fused_attention=True)
    want, grads = jax.value_and_grad(
        lambda p: jlt.score_objective(
            model, p, eps, t, var, e2int, jnp.ones((B, 1, 1)),
            jnp.asarray(eta), jnp.asarray(LABELS), None, False, None,
            "l2"))(jax.tree_util.tree_map(jnp.asarray, sp))
    tgrads = _captured_grads(monkeypatch, tlt)
    got = trainer.update({"tr_points": pts, "cate_idx": LABELS},
                         t_idx=torch.from_numpy(t_idx), eta=_t(eta),
                         enc_noise=[_t(e) for e in noise])
    np.testing.assert_allclose(got.item(), float(want), **STEP_TOL)
    jgrads = weights.score_state_dict(_np(grads))
    for k, g in jgrads.items():
        np.testing.assert_allclose(tgrads[k].numpy(), g.numpy(), err_msg=k,
                                   **STEP_TOL)
    assert jgrads["label_embedding.embed.weight"].abs().max() > 1e-6


def _stage1_labelled_pair(tmp_path):
    """A class-conditional JAX stage-1 trainer after its init and the
    port's on its weights (two categories)."""
    (tmp_path / "jax").mkdir(exist_ok=True)
    jcfg = _jax_cfg(tmp_path, 2, class_condition=True)
    jcfg.model.num_categorys = 2
    jtr = jct.Trainer(jcfg, jcm.Compressor(jcfg.model))
    first = {"tr_points": _rand((B, N, 3), 1),
             "cate_idx": np.array([0, 1, 0, 1], np.int32)}
    jtr.maybe_init(first)
    tcfg = compressor_trainer_cfg(
        model=dict(SMALL_COMPRESSOR, class_condition=True, num_categorys=2),
        data=dict(num_categorys=2, batch_size=B),
        log=dict(save_path=str(tmp_path)))
    ttr = Stage1(tcfg, device="cpu")
    ttr.maybe_init(first, weights=weights.compressor_state_dict(
        {"params": _np(jtr.state.params),
         "batch_stats": _np(jtr.state.batch_stats)}))
    return jtr, ttr


def test_stage1_multicategory_reconstruction_with_labels(tmp_path,
                                                         monkeypatch):
    """The clouds of `val_cate` only, encoded with their labels by a
    class-conditional Compressor, decoded, denormalized, scored: against
    the JAX trainer's `reconstruction` with the same noise."""
    jtr, ttr = _stage1_labelled_pair(tmp_path)
    loader = _loader(2, batches=3, categories=2)
    loader[1]["cate_idx"][:] = 0  # a batch with no cloud of category 1
    keep = [d["cate_idx"] == 1 for d in loader]
    noise = [_noise(10 * b, int(k.sum())) for b, k in enumerate(keep)
             if k.any()]
    draws = {}
    monkeypatch.setattr(jcm, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                        * next(draws["it"]))

    @jax.jit
    def encode(variables, pts, eps, label):
        draws["it"] = iter(eps)
        return jtr.model.apply(variables, pts, label=label,
                               rngs={"sample": jax.random.key(0)})

    jbatches, labels = iter(noise), []
    monkeypatch.setattr(jtr, "_encode_step", lambda v, pts, rng, label:
                        encode(v, pts, tuple(next(jbatches)), label))
    tdraws = iter(noise)

    def tencode(pts, label=None):
        labels.append(label)
        return Stage1.encode(ttr, pts, label=label,
                             noise=[_t(e) for e in next(tdraws)])

    monkeypatch.setattr(ttr, "encode", tencode)
    jcalls, tcalls = [], []
    _recorder(monkeypatch, jct, jcalls)
    _recorder(monkeypatch, tbase, tcalls)
    want = jtr.reconstruction(loader, val_cate=1)
    got = ttr.reconstruction(loader, val_cate=1)
    (jrec, jref, _), (rec, ref, _) = jcalls[0], tcalls[0]
    assert rec.shape == (sum(int(k.sum()) for k in keep), N, 3)
    assert all(np.all(lab == 1) for lab in labels) and len(labels) == 2
    np.testing.assert_allclose(ref, jref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rec, jrec, **CLOUD_TOL)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_stage2_multicategory_valsample(tmp_path, monkeypatch):
    """ceil(n / test_batch_size) batches of test_batch_size samples at the
    label `val_cate`, cut to the n test clouds of `val_cate`: against the
    JAX trainer's `valsample` with its own draws."""
    (tmp_path / "jax").mkdir()
    jcfg = _jax_cfg(tmp_path, 3)
    jcfg.score.num_categorys = 3
    jtr = jlt.Trainer(jcfg, JaxScore(jcfg.score),
                      jcm.Compressor(jcfg.compressor))
    first = {"tr_points": _rand((B, N, 3), 4),
             "cate_idx": np.array([0, 1, 2, 1], np.int32)}
    jtr.maybe_init(first)
    out = jtr.comp_vars["params"]["output_dense"]
    # clouds ~1 across (see test_torch_port_eval_trainers)
    jtr.comp_vars["params"]["output_dense"] = jax.tree_util.tree_map(
        lambda a: a * 0.01, out)
    tcfg = latent_trainer_cfg(score=dict(SMALL_SCORE, num_categorys=3),
                              compressor=SMALL_COMPRESSOR,
                              sde=dict(SDE, sample_N=32),
                              data=dict(tr_max_sample_points=N,
                                        num_categorys=3, test_batch_size=B))
    ttr = Stage2(tcfg, device="cpu")
    ttr.maybe_init(first, score_weights=weights.score_state_dict(
        _np(jtr.state.ema_params)),
        compressor_weights=weights.compressor_state_dict(
            _np(jtr.comp_vars)))
    loader = _loader(5, batches=3, categories=3)
    rng = np.random.default_rng(6)
    for data, cates in zip(loader, ([2, 2, 0, 1], [2, 1, 2, 0],
                                    [0, 2, 1, 1])):
        data["te_points"] = synthetic_shapes(B, N, rng)
        data["cate_idx"] = np.array(cates, np.int32)
    val_cate = 2
    n_ref = sum(int((d["cate_idx"] == val_cate).sum()) for d in loader)
    assert n_ref > B  # two sampling batches, the second cut
    # a key whose samples beat every runner-up by MARGIN (the argmin-derived
    # metrics are compared exactly only there)
    jtr.rng = jax.random.key(1)
    rng, draws = jtr.rng, []
    shape = (B, SMALL_SCORE["z_scale"], SMALL_SCORE["z_dim"])
    for _ in range(-(-n_ref // B)):
        rng, k = jax.random.split(rng)
        draws.append(_jax_draws(jax.random.split(k)[0], 32, shape))
    pinned, seen = iter(draws), []
    real = tlt.sample_latents

    def pinned_latents(*args, **kw):
        seen.append(kw["label"])
        x0, noise = next(pinned)
        return real(*args, **dict(kw, x0=torch.tensor(x0),
                                  noise=torch.tensor(noise)))

    monkeypatch.setattr(tlt, "sample_latents", pinned_latents)
    jcalls, tcalls = [], []
    _recorder(monkeypatch, jlt, jcalls)
    _recorder(monkeypatch, tbase, tcalls)
    want = jtr.valsample(loader, val_cate=val_cate)
    got = ttr.valsample(loader, val_cate=val_cate)
    (jsmp, jref, _), (smp, ref, bs) = jcalls[0], tcalls[0]
    assert bs == 64 and smp.shape == (n_ref, N, 3)
    assert len(seen) == -(-n_ref // B)
    assert all(torch.equal(lab, torch.full((B,), val_cate)) for lab in seen)
    np.testing.assert_array_equal(ref, jref)
    err = np.abs(smp - jsmp).max()
    assert err <= SAMPLE_REL * np.abs(jsmp).max(), err
    _assert_scores_match(got, want, smp, ref)


def jax_file_round_trip(tmp_path, trainer, sharded):
    """The trainer's state written as a JAX checkpoint: (the JAX package's
    read of it, the port's read of it)."""
    import ldt_tpu.training.checkpoint as jckpt
    from ldt_torch.training import jax_checkpoint as jc

    path = str(tmp_path / "checkpt_1.msgpack")
    jc.save_jax_checkpoint(path, trainer.state_tree(), trainer.tx,
                           cfg=trainer.cfg, epoch=1, itr=1,
                           shard_threshold=1 if sharded
                           else jc.DEFAULT_SHARD_THRESHOLD)
    assert os.path.exists(path + ".shard0") == sharded
    return (jckpt.load_checkpoint(path)["state"],
            jc.load_jax_checkpoint(path)["state"])


def same_structure(a, b) -> bool:
    return (jax.tree_util.tree_structure(_np(a))
            == jax.tree_util.tree_structure(_np(b)))


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("stage", [1, 2])
def test_labelled_state_crosses_the_jax_file_bridge(tmp_path, stage,
                                                    sharded):
    """Both trainers' states with the label tables (and the class-
    conditional decoder's AdaLN heads) as JAX checkpoints: the JAX package
    reads the JAX init's names, and the port reads back every leaf bit for
    bit, in the single-file and the sharded format."""
    pts = _rand((B, N, 3), 70)
    if stage == 1:
        trainer = Stage1(compressor_trainer_cfg(
            model=COMP_L, data=dict(num_categorys=CATS)), device="cpu")
        trainer.maybe_init({"tr_points": pts}, weights=weights.
                           compressor_state_dict(_comp_variables()))
        trainer.update({"tr_points": pts, "cate_idx": LABELS})
    else:
        trainer = Stage2(latent_trainer_cfg(
            score=SCORE_L, compressor=COMP_L, sde=SDE,
            data=dict(num_categorys=CATS)), device="cpu")
        trainer.maybe_init(
            {"tr_points": pts},
            score_weights=weights.score_state_dict(_score_params()),
            compressor_weights=weights.compressor_state_dict(
                _comp_variables()))
        trainer.update({"tr_points": pts, "cate_idx": LABELS})
    jax_state, back = jax_file_round_trip(tmp_path, trainer, sharded)
    if stage == 1:
        assert same_structure(jax_state["state"]["params"],
                              _comp_variables()["params"])
        assert same_structure(jax_state["state"]["batch_stats"],
                              _comp_variables()["batch_stats"])
    else:
        assert same_structure(jax_state["score"]["params"], _score_params())
        assert same_structure(jax_state["compressor"], _comp_variables())
    assert trees_equal(back, trainer.state_tree())
