"""The layer and Compressor branches that no shipped config sets, against
ldt_tpu on the CPU: the group and batch norms of `make_norm`, the
AdaLN=False block, a block whose output width differs from its input's
(`shortcut`, `adaLN1` + `adaLN2`, `compute_mods`), `rescale`, the plain
FinalLayer, and the Compressor's `pre_group`, MLP position embedding,
AdaLN=False encoder, norms and both `InitialSet` branches (with JAX's
permutation and eps fed in). Each converts both ways through
`ldt_torch.weights`. The JAX blocks run their attention through the Pallas
kernels in interpret mode (`fused_attention=True`); a Score with group or
batch norms converts both ways too. The tolerances are the
neighbouring layer tests' (`test_torch_port_layers.py`): f32 1e-5, bf16 a few
ulps of the largest value."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.nn.layers as jl
from ldt_tpu.models import Score as JaxScore
from ldt_torch import weights
from ldt_torch.models import Compressor, Score
from ldt_torch.models import compressor as tcm
from ldt_torch.nn import layers as tl
from test_torch_port_common import (
    DTYPES,
    F32_TOL,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    assert_close,
    cfgs,
    compressor_variables,
    perturbed,
    pin_reparameterize,
    to_np,
    trees_equal,
)

B, N, M, D, H, DC = 2, 16, 8, 32, 4, 16
D_OUT = 64


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _block_sd(v):
    """One block's flax variables -> its state_dict, and back."""
    sd = {}
    weights._residual_block(sd, "m", v["params"], "m",
                            v.get("batch_stats"))
    return {k[2:]: t for k, t in sd.items()}


def _block_back(sd, norm):
    stats = {}
    e = weights._Entries({f"m.{k}": t for k, t in sd.items()})
    params = weights._residual_block_inv(e, "m", stats, norm)
    e.done()
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(B, N, D), (B, N, D_OUT), (3, D)],
                         ids=["tokens", "16groups", "2d"])
def test_group_norm_matches_flax(shape, dtype):
    """Statistics per set over its tokens and each group's channels
    (min(C // 4, 16) groups, eps 1e-6), then scale and bias."""
    jd, td = DTYPES[dtype]
    c = shape[-1]
    x = _rand(shape, 1, scale=2.0) + 0.5
    jm = jl.make_norm("group_norm", c, dtype=jd)
    rng = np.random.default_rng(2)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    want = jm.apply({"params": p}, jnp.asarray(x).astype(jd))
    tm = tl.make_norm("group_norm", c, affine=False, dtype=td)
    assert tm.num_groups == min(c // 4, 16)
    tm.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"])})
    got = tm(torch.from_numpy(x).to(td))
    assert got.dtype == td
    assert_close(got, want, dtype)
    # not torch's channel-first GroupNorm, nor a per-token norm
    if len(shape) == 3:
        per_token = torch.nn.functional.layer_norm(_t(x), (c,), eps=1e-6)
        assert np.abs(to_np(per_token) - to_np(got)).max() > 0.1


def test_batch_norm_norm_always_reads_its_running_statistics():
    """make_norm's batch norm: affine whatever `affine` says, and in eval
    and in training alike normalized by its running statistics (flax
    `use_running_average=True`)."""
    x = _rand((B, N, D), 3, scale=2.0)
    rng = np.random.default_rng(4)
    p = {"scale": rng.uniform(0.5, 1.5, D).astype(np.float32),
         "bias": rng.standard_normal(D).astype(np.float32)}
    st = {"mean": rng.standard_normal(D).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, D).astype(np.float32)}
    jm = jl.make_norm("batch_norm", D)
    want = jm.apply({"params": p, "batch_stats": st}, jnp.asarray(x))
    tm = tl.make_norm("batch_norm", D, affine=False)
    tm.load_state_dict({"weight": _t(p["scale"]), "bias": _t(p["bias"]),
                        "running_mean": _t(st["mean"]),
                        "running_var": _t(st["var"])})
    tm.train()
    assert_close(tm(_t(x)), want, "float32")
    for affine in (False, True):
        assert tl.make_norm("group_norm", D, affine).weight is not None
        assert (tl.make_norm("layer_norm", D, affine).weight
                is not None) == affine


# block variants: (ldt_tpu ResidualBlock kwargs, call: "c", "mods", "none"
# or "cross")
BLOCKS = {
    "adaln_off": (dict(dim_c=DC, AdaLN=False, act="silu"), "c"),
    "adaln_off_cross": (dict(dim_c=DC, AdaLN=False), "cross"),
    "dim_out_c": (dict(dim_c=DC, dim_out=D_OUT), "c"),
    "dim_out_mods": (dict(dim_c=DC, dim_out=D_OUT), "mods"),
    "dim_out_uncond": (dict(dim_out=D_OUT, act="gelu"), "none"),
    "dim_out_adaln_off": (dict(dim_c=DC, dim_out=D_OUT, AdaLN=False), "c"),
    "rescale": (dict(dim_c=DC, rescale=True), "c"),
    "rescale_uncond": (dict(rescale=True), "cross"),
    "group_norm": (dict(dim_c=DC, norm="group_norm"), "c"),
    "group_norm_uncond": (dict(norm="group_norm", dim_out=D_OUT), "none"),
    "batch_norm": (dict(dim_c=DC, norm="batch_norm"), "c"),
    "batch_norm_dim_out": (dict(norm="batch_norm", dim_out=D_OUT), "none"),
}
_TORCH_KW = {"dim_out", "AdaLN", "rescale", "act", "norm"}


def _block_case(name, dtype):
    jd, td = DTYPES[dtype]
    kw, call = BLOCKS[name]
    x, y, c = _rand((B, N, D), 5), _rand((B, M, D), 6), _rand((B, DC), 7)
    jb = jl.ResidualBlock(D, num_heads=H, fused_attention=True, dtype=jd,
                          **kw)
    args = {"c": (x, None, c), "mods": (x, None, c), "none": (x,),
            "cross": (x, y, c if "dim_c" in kw else None)}[call]
    v = jb.init(jax.random.key(8), *[None if a is None else jnp.asarray(a)
                                     for a in args])
    v = perturbed(jax.tree_util.tree_map(np.asarray, dict(v)))
    tb = tl.ResidualBlock(D, kw.get("dim_c"), num_heads=H, dtype=td,
                          **{k: kw[k] for k in _TORCH_KW if k in kw})
    tb.load_state_dict(_block_sd(v))
    return jb, v, tb, call, args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_residual_block_branch_matches(name, dtype):
    jb, v, tb, call, args = _block_case(name, dtype)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    with torch.no_grad():
        if call == "mods":
            mods = jb.apply(v, jargs[2][:1],
                            method=jl.ResidualBlock.compute_mods)
            tmods = tb.compute_mods(targs[2][:1])
            assert tmods.shape[-1] == 2 * D + 4 * D_OUT
            assert_close(tmods, mods, dtype)
            want = jb.apply(v, jargs[0], mods=mods[0])
            got = tb(targs[0], mods=tmods[0])
        else:
            want = jb.apply(v, *jargs)
            got = tb(*targs)
    assert got.shape == want.shape
    assert_close(got, want, dtype)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_residual_block_branch_converts_both_ways(name):
    _, v, tb, _, _ = _block_case(name, "float32")
    kw = BLOCKS[name][0]
    back = _block_back(tb.state_dict(), kw.get("norm", "layer_norm"))
    assert trees_equal(back["params"], v["params"])
    assert trees_equal(back["batch_stats"], v.get("batch_stats", {}))
    assert set(_block_sd(v)) == set(tb.state_dict())


def test_block_without_adaln_adds_the_projected_condition_to_the_normed_x():
    """AdaLN=False: the residual starts from act(norm1(x)) + pos, not from
    the input x (the reference's quirk, kept)."""
    _, v, tb, _, (x, _, c) = _block_case("adaln_off", "float32")
    with torch.no_grad():
        tb.attn.fc_o.weight.zero_()
        tb.attn.fc_o.bias.zero_()
        tb.mlp.dense_1.weight.zero_()
        tb.mlp.dense_1.bias.zero_()
        got = tb(_t(x), None, _t(c))
        pos = tb.pos_embedding(torch.nn.functional.silu(_t(c)))[:, None]
        want = tb.act(tb.norm1(_t(x))) + pos
    np.testing.assert_allclose(to_np(got), to_np(want), **F32_TOL)


@pytest.mark.parametrize("norm", ["layer_norm", "group_norm", "batch_norm"])
def test_final_layer_without_conditioning(norm):
    """dim_c None: ln(norm(x)) with an affine norm."""
    x = _rand((B, N, D), 9)
    jf = jl.FinalLayer(8, dim_c=None, norm=norm)
    v = perturbed(jax.tree_util.tree_map(
        np.asarray, dict(jf.init(jax.random.key(5), jnp.asarray(x)))))
    want = jf.apply(v, jnp.asarray(x))
    tf = tl.FinalLayer(D, 8, dim_c=None, norm=norm)
    sd = {}
    weights._final_layer(sd, "m", v["params"], "m", v.get("batch_stats"))
    tf.load_state_dict({k[2:]: t for k, t in sd.items()})
    assert not hasattr(tf, "adaLN")
    with torch.no_grad():
        assert_close(tf(_t(x)), want, "float32")
    stats = {}
    e = weights._Entries({f"m.{k}": t for k, t in tf.state_dict().items()})
    assert trees_equal(weights._final_layer_inv(e, "m", stats, norm),
                       v["params"])
    e.done()
    assert trees_equal(stats, v.get("batch_stats", {}))


# Compressor variants: the config over SMALL_COMPRESSOR and the points per
# cloud (pre_group takes 256 groups of 32 neighbours first)
VARIANTS = {
    "pre_group": (dict(pre_group=True), 512),
    "pos_mlp": (dict(pos_embedding="mlp"), 64),
    "encoder_adaln_off": (dict(AdaLN=False), 64),
    "group_norm": (dict(norm="group_norm"), 64),
    "batch_norm": (dict(norm="batch_norm"), 64),
    "mixture_seeds": (dict(max_outputs=None), 64),
}


@functools.lru_cache(maxsize=None)
def _variant_variables(name):
    """The variant's config, clouds and perturbed JAX variables, built once
    a process (the JAX init compiles the whole Compressor); the tests only
    read them."""
    over, n = VARIANTS[name]
    d = dict(SMALL_COMPRESSOR, **over)
    pts = _rand((B, n, 3), 10)
    return d, pts, perturbed(compressor_variables(d, pts))


def _variant(name):
    d, pts, v = _variant_variables(name)
    model = weights.load_compressor(
        Compressor(cfgs(d)[1], device="cpu").eval(), v)
    return d, pts, v, model


def _mixture_eps(d, seed=11):
    return _rand((B, d["outsize"], 4, d["hidden_dim"]), seed)


# A batch-norm block normalizes nothing (its running statistics are fixed),
# so a whole Compressor's activations grow with depth until the posterior
# heads saturate at their clips: the block-level tests above hold that norm
# against ldt_tpu, and the Compressor's converts both ways below.
FORWARD = sorted(n for n in VARIANTS if n != "batch_norm")


@pytest.mark.parametrize("name", FORWARD)
def test_compressor_variant_forward_matches(name, monkeypatch):
    """The whole forward (encode, posteriors, decode) with pinned
    reparameterization noise (and, for the mixture of Gaussians, its
    eps)."""
    d, pts, v, model = _variant(name)
    noise = [_rand((B, d["z_scales"], d["z_dim"]), 20 + i)
             for i in range(d["n_layers"])]
    pin_reparameterize(monkeypatch, noise)
    seed_draw = None
    if d["max_outputs"] is None:
        seed_draw = _mixture_eps(d)
        real = jax.random.normal

        def normal(key, shape, dtype=jnp.float32):
            if tuple(shape) == seed_draw.shape:
                return jnp.asarray(seed_draw)
            return real(key, shape, dtype)

        monkeypatch.setattr(jax.random, "normal", normal)
    want = jcm.Compressor(cfgs(d)[0], fused_attention=True).apply(
        v, jnp.asarray(pts), rngs={"sample": jax.random.key(0)})
    with torch.no_grad():
        got = model(_t(pts), noise=[_t(e) for e in noise],
                    seed_draw=None if seed_draw is None else _t(seed_draw))
    for key in ("set", "all_eps", "max"):
        assert_close(got[key], want[key], "float32")
    for (_, mu, logvar), (_, jmu, jlogvar) in zip(got["posteriors"][1:],
                                                  want["posteriors"][1:]):
        assert_close(mu, jmu, "float32")
        assert_close(logvar, jlogvar, "float32")
    # the KL divides by exp(logvar) with logvar near its clip at -30 (values
    # up to ~3e7), so its relative error is logvar's absolute one: held at
    # the stage-1 step's relative limit (test_torch_port_stage1.STEP_TOL)
    for g, w in zip(got["kls"], want["kls"]):
        np.testing.assert_allclose(to_np(g), to_np(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_compressor_variant_converts_both_ways(name):
    d, _, v, model = _variant(name)
    sd = weights.compressor_state_dict(v)
    assert set(sd) == set(model.state_dict())
    back = weights.compressor_variables(model.state_dict(), d["norm"])
    assert trees_equal(back["params"], v["params"])
    assert trees_equal(back["batch_stats"], v["batch_stats"])


def test_pre_group_runs_a_second_grouper_first():
    d, pts, _, model = _variant("pre_group")
    calls = []
    for name in ("pre_grouper", "group"):
        real = getattr(model, name).forward

        def spy(xyz, feat, groups, k, train=False, real=real, name=name):
            calls.append((name, xyz.shape[1], groups, k))
            return real(xyz, feat, groups, k, train)

        getattr(model, name).forward = spy
    with torch.no_grad():
        model.bottom_up(_t(pts))
    assert calls == [("pre_grouper", 512, 256, 32),
                     ("group", 256, d["z_scales"], 256 // d["z_scales"] * 2)]


def _jax_draws(module, variables, batch, num_points):
    """The rng the JAX InitialSet draws from on a fresh apply, and its
    draws: the subset's rows [B, num_points] or the mixture's eps."""
    bound = module.bind(variables, rngs={"sample": jax.random.key(7)})
    rng = bound.make_rng("sample")
    if module.max_outputs is not None:
        keys = jax.random.split(rng, batch)
        return np.asarray(jax.vmap(lambda k: jax.random.permutation(
            k, module.max_outputs)[:num_points])(keys))
    return np.asarray(jax.random.normal(
        rng, (batch, num_points, module.n_mixtures, module.dim_seed)))


@pytest.mark.parametrize("max_outputs", [64, None],
                         ids=["random_subset", "mixture"])
def test_initial_set_branches_match_with_jax_draws(max_outputs):
    jm = jcm.InitialSet(D, max_outputs)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        {"params": jax.random.key(1), "sample": jax.random.key(2)}, B, 24)))
    # jnp leaves: the subset's gather runs under vmap
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, v), B, 24,
                    rngs={"sample": jax.random.key(7)})
    draw = _jax_draws(jm, v, B, 24)
    tm = tcm.InitialSet(D, max_outputs, device="cpu")
    sd = {}
    weights._init_set(sd, {"init_set": v["params"]})
    tm.load_state_dict({k[len("init_set."):]: t for k, t in sd.items()})
    with torch.no_grad():
        got = tm(B, 24, draw=torch.from_numpy(draw))
    assert got.shape == (B, 24, D)
    assert_close(got, want, "float32")
    # unpinned: drawn from the generator, repeatably
    g = [torch.Generator().manual_seed(5) for _ in range(2)]
    with torch.no_grad():
        a, b = tm(B, 24, generator=g[0]), tm(B, 24, generator=g[1])
    assert torch.equal(a, b) and not torch.equal(a, got)
    if max_outputs is not None:
        rows = [set(map(tuple, r.tolist())) for r in a]
        assert all(len(r) == 24 for r in rows)  # rows without repeats


def test_initial_set_init_draws_as_jax():
    """The table U(0, 1); the mixture's logits 1, mu N(0, 1), sig
    |N(0, 1)| / sqrt(4)."""
    table = tcm.InitialSet(D, 64, device="cpu")
    mix = tcm.InitialSet(D, None, device="cpu")
    g = torch.Generator().manual_seed(0)
    table.init_(g)
    mix.init_(g)
    assert 0.0 <= table.prior.min() and table.prior.max() <= 1.0
    assert torch.equal(mix.logits, torch.ones(4))
    assert mix.sig.min() >= 0 and mix.sig.max() < 3.0
    assert abs(mix.mu.std().item() - 1.0) < 0.25


def test_sample_takes_a_random_subset_of_the_seed_set():
    """num_points < max_outputs: the decode starts from the rows `seed_draw`
    pins (JAX's, by permutation) and agrees with ldt_tpu's sample."""
    d, _, v, model = _variant("pos_mlp")
    n = 24
    eps = _rand((B, d["z_scales"], d["n_layers"] * d["z_dim"]), 30)
    jm = jcm.Compressor(cfgs(d)[0], fused_attention=True)
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, v), (B, n),
                    jnp.asarray(eps), method=jcm.Compressor.sample,
                    rngs={"sample": jax.random.key(3)})
    bound = jm.bind(v, rngs={"sample": jax.random.key(3)})
    keys = jax.random.split(bound.init_set.make_rng("sample"), B)
    draw = np.asarray(jax.vmap(lambda k: jax.random.permutation(
        k, d["max_outputs"])[:n])(keys))
    with torch.no_grad():
        got = model.sample((B, n), _t(eps), seed_draw=torch.from_numpy(draw))
    assert got.shape == (B, n, 3)
    assert_close(got, want, "float32")


@pytest.mark.parametrize("norm", ["group_norm", "batch_norm"])
def test_score_with_other_norms_matches_and_converts_both_ways(norm):
    """A Score whose blocks and head use the group or the batch norm: its
    forward, and `score_state_dict(params, batch_stats)` /
    `score_variables(sd, norm)` both ways."""
    d = dict(SMALL_SCORE, norm=norm)
    jcfg, tcfg = cfgs(d)
    x = _rand((B, d["z_scale"], d["z_dim"]), 40)
    t = np.array([0.8, 0.3], np.float32)
    jm = JaxScore(jcfg, fused_attention=True)
    v = perturbed(jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.key(2), jnp.asarray(x), jnp.asarray(t)))))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t))
    tm = Score(tcfg, device="cpu")
    tm.load_state_dict(weights.score_state_dict(v["params"],
                                                v.get("batch_stats")))
    with torch.no_grad():
        assert_close(tm(_t(x), _t(t)), want, "float32")
    back = weights.score_variables(tm.state_dict(), norm)
    assert trees_equal(back["params"], v["params"])
    assert trees_equal(back["batch_stats"], v.get("batch_stats", {}))
    if norm == "batch_norm":
        with pytest.raises(ValueError, match="score_variables"):
            weights.score_params(tm.state_dict(), norm)
