"""The Compressor's encode half: each module of ldt_torch against its
ldt_tpu counterpart on the CPU (JAX's attention through the Pallas kernel K2
in interpret mode), `Compressor.forward`'s `all_eps` with pinned
reparameterization noise, and the weight converter of the whole Compressor
(params and batch_stats)."""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
from ldt_tpu.nn.layers import ActNorm as JaxActNorm
from ldt_torch.models import Compressor
from ldt_torch.models import compressor as tcm
from ldt_torch.nn.layers import ActNorm, BatchNorm
from ldt_torch.weights import (
    compressor_state_dict,
    is_decode_key,
    load_compressor,
)
from test_torch_port_common import SMALL_COMPRESSOR, assert_close, cfgs

B, N = 2, 64
C = SMALL_COMPRESSOR
S, H = C["z_scales"], C["hidden_dim"]
K = N // S * 2  # the grouping's neighbours


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _init_variables():
    jcfg, _ = cfgs(C)
    return _np(jax.jit(jcm.Compressor(jcfg).init)(
        {"params": jax.random.key(1), "sample": jax.random.key(2)},
        jnp.asarray(_rand((B, N, 3), 0))))


@functools.lru_cache(maxsize=None)
def _variables():
    """JAX-initialised variables with every leaf moved off its initial value
    (running statistics, norm scales and biases, ActNorm), so each mapping
    is exercised."""
    rng = np.random.default_rng(3)

    def params(a):
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)

    def stats(path, a):
        if path[-1].key == "var":
            return (a * rng.uniform(0.5, 2.0, a.shape)).astype(np.float32)
        return (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)

    v = _init_variables()
    return {"params": jax.tree_util.tree_map(params, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stats, v["batch_stats"])}


def _sub(name):
    v = _variables()
    out = {"params": v["params"][name]}
    if name in v["batch_stats"]:
        out["batch_stats"] = v["batch_stats"][name]
    return out


@functools.lru_cache(maxsize=None)
def _torch_model():
    _, tcfg = cfgs(C)
    return load_compressor(Compressor(tcfg, device="cpu").eval(),
                           _variables())


def _t(a):
    return torch.from_numpy(np.array(a))


def test_weight_converter_maps_every_leaf():
    sd = compressor_state_dict(_variables())
    model = _torch_model()
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape, k
    # BatchNorm running statistics come from batch_stats
    assert torch.equal(
        model.pos_embedding.bn1.running_var,
        _t(_variables()["batch_stats"]["pos_embedding"]["bn1"]["var"]))
    assert any(not is_decode_key(k) for k in sd)


@pytest.mark.parametrize("col,path", [
    ("params", ("encoder_1", "att0", "extra", "kernel")),
    ("params", ("group", "extraction", "op0", "net1_bn", "extra")),
    ("batch_stats", ("pos_embedding", "bn1", "extra")),
    ("batch_stats", ("group", "extraction", "op0", "net1_bn", "extra")),
])
def test_weight_converter_raises_on_an_unmapped_leaf(col, path):
    v = jax.tree_util.tree_map(lambda a: a, _variables())  # a copy
    node = v[col]
    for key in path[:-1]:
        node[key] = dict(node.get(key, {}))
        node = node[key]
    node[path[-1]] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        compressor_state_dict(v)


def test_mini_pointnet_matches():
    x = _rand((B, 16, 3), 4)
    want = jcm.MiniPointnet(C["p_dim"]).apply(_sub("pos_embedding"),
                                              jnp.asarray(x))
    with torch.no_grad():
        got = _torch_model().pos_embedding(_t(x))
    assert got.shape == (B, C["p_dim"])
    assert_close(got, want, "float32")


def test_pre_extraction_and_its_residual_block_match():
    ext = {col: t["extraction"] for col, t in _sub("group").items()}
    x = _rand((B, S, K, 2 * H + 3), 5)
    want = jcm.PreExtraction(H).apply(ext, jnp.asarray(x))
    op = {col: t["op0"] for col, t in ext.items()}
    y = _rand((B * S, K, H), 6)
    want_op = jcm.ConvBNReLURes1D(H).apply(op, jnp.asarray(y))
    with torch.no_grad():
        got = _torch_model().group.extraction(_t(x))
        got_op = _torch_model().group.extraction.ops[0](_t(y))
    assert_close(got, want, "float32")
    assert_close(got_op, want_op, "float32")


@pytest.mark.parametrize("normalize", ["anchor", "center", None])
def test_local_grouper_matches(normalize):
    xyz, feat = _rand((B, N, 3), 7), _rand((B, N, H), 8)
    sub = _sub("group")
    if normalize is None:
        sub = {"params": {"extraction": sub["params"]["extraction"]},
               "batch_stats": sub["batch_stats"]}
    jm = jcm.LocalGrouper(H, True, normalize=normalize)
    want_xyz, want = jm.apply(sub, jnp.asarray(xyz), jnp.asarray(feat), S, K)
    tm = tcm.LocalGrouper(H, normalize=normalize, device="cpu")
    tm.load_state_dict({k[len("group."):]: v for k, v in
                        compressor_state_dict(_variables()).items()
                        if k.startswith("group.") and (
                            normalize or "affine" not in k)})
    with torch.no_grad():
        got_xyz, got = tm(_t(xyz), _t(feat), S, K)
    assert torch.equal(got_xyz, _t(want_xyz))
    assert_close(got, want, "float32")


@pytest.mark.parametrize("feature_type", ["token", "set"])
def test_actnorm_data_init_and_apply_match(feature_type):
    x = _rand((4, S, H), 9, scale=3.0) + 1.0
    jm = JaxActNorm(H, S, feature_type=feature_type)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    tm = ActNorm(H, S, feature_type=feature_type, device="cpu")
    tm.data_init(_t(x))
    assert_close(tm.shift, v["params"]["shift"], "float32")
    assert_close(tm.log_scale, v["params"]["log_scale"], "float32")
    y = _rand((2, S, H), 10)
    with torch.no_grad():
        assert_close(tm(_t(y)), jm.apply(v, jnp.asarray(y)), "float32")


def test_batch_norm_matches_flax_inference():
    rng = np.random.default_rng(11)
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.2, 3.0, 6).astype(np.float32)}
    params = {"scale": rng.standard_normal(6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    x = _rand((3, 5, 6), 12)
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    tm = BatchNorm(6, device="cpu")
    tm.load_state_dict({"weight": _t(params["scale"]),
                        "bias": _t(params["bias"]),
                        "running_mean": _t(stats["mean"]),
                        "running_var": _t(stats["var"])})
    assert_close(tm(_t(x)), want, "float32")


def test_encoder_matches():
    x, pos = _rand((B, S, H), 13), _rand((B, C["p_dim"]), 14)
    jm = jcm.Encoder(H, C["p_dim"], C["num_heads"], norm=C["norm"],
                     mlp_ratio=C["mlp_ratio"], num_layers=C["encoder_layers"],
                     fused_attention=True)
    want_x, want_o = jm.apply(_sub("encoder_0"), jnp.asarray(x),
                              jnp.asarray(pos))
    with torch.no_grad():
        got_x, got_o = _torch_model().encoder[0](_t(x), _t(pos))
    assert_close(got_x, want_x, "float32")
    assert_close(got_o, want_o, "float32")


@pytest.mark.parametrize("over_set", [False, True],
                         ids=["self", "over_decoded_set"])
def test_compute_posterior_matches(over_set):
    x, o = _rand((B, S, H), 15), _rand((B, N, H), 16)
    jm = jcm.DecoderBlock(H, C["z_dim"], C["num_heads"], norm=C["norm"],
                          mlp_ratio=C["mlp_ratio"], min_sigma=C["min_sigma"],
                          fused_attention=True)
    want = jm.apply(_sub("decoder_1"), jnp.asarray(x),
                    jnp.asarray(o) if over_set else None,
                    method=jcm.DecoderBlock.compute_posterior)
    with torch.no_grad():
        got = _torch_model().decoder[1].compute_posterior(
            _t(x), _t(o) if over_set else None)
    for g, w in zip(got, want):
        assert_close(g, w, "float32")


def test_log_densities_match():
    s, mu, lv = (_rand((3, 4), i) for i in (17, 18, 19))
    assert_close(tcm.log_p_var_normal(_t(s), _t(mu), _t(lv)),
                 jcm.log_p_var_normal(jnp.asarray(s), jnp.asarray(mu),
                                      jnp.asarray(lv)), "float32")
    assert_close(tcm.log_p_normal(_t(s)), jcm.log_p_normal(jnp.asarray(s)),
                 "float32")


def _noise(seed=20):
    return [_rand((B, S, C["z_dim"]), seed + i) for i in range(C["n_layers"])]


def _jax_forward(pts, noise, monkeypatch):
    draws = iter(noise)
    monkeypatch.setattr(jcm, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                        * jnp.asarray(next(draws)))
    jcfg, _ = cfgs(C)
    return jcm.Compressor(jcfg, fused_attention=True).apply(
        _variables(), jnp.asarray(pts), rngs={"sample": jax.random.key(0)})


def test_bottom_up_matches():
    pts = _rand((B, N, 3), 21)
    jcfg, _ = cfgs(C)
    want = jcm.Compressor(jcfg, fused_attention=True).apply(
        _variables(), jnp.asarray(pts), method=jcm.Compressor.bottom_up)
    with torch.no_grad():
        got = _torch_model().bottom_up(_t(pts))
    assert len(got["outputs"]) == C["n_layers"]
    for g, w in zip(got["outputs"], want["outputs"]):
        assert_close(g, w, "float32")
    assert_close(got["max"], want["max"], "float32")


def test_forward_all_eps_matches_with_pinned_noise(monkeypatch):
    pts, noise = _rand((B, N, 3), 22), _noise()
    want = _jax_forward(pts, noise, monkeypatch)
    with torch.no_grad():
        got = _torch_model()(_t(pts), noise=[_t(e) for e in noise])
    assert got["all_eps"].shape == (B, S, C["n_layers"] * C["z_dim"])
    assert_close(got["all_eps"], want["all_eps"], "float32")
    assert_close(got["set"], want["set"], "float32")
    for g, w in zip(got["kls"], want["kls"]):
        assert_close(g, w, "float32")
    # a draw out of place moves the latents
    with torch.no_grad():
        swapped = _torch_model()(_t(pts), noise=[_t(e) for e in noise[::-1]])
    assert not torch.allclose(swapped["all_eps"], got["all_eps"], atol=1e-3)


def test_init_actnorm_matches_the_jax_init():
    """With every other weight the JAX init's, `init_actnorm` on the init
    batch gives JAX's data-dependent ActNorm."""
    _, tcfg = cfgs(C)
    v = _init_variables()
    model = load_compressor(Compressor(tcfg, device="cpu"), v)
    with torch.no_grad():
        model.conv_in.shift.zero_()
        model.conv_in.log_scale.zero_()
    model.init_actnorm(_t(_rand((B, N, 3), 0)))
    assert_close(model.conv_in.shift, v["params"]["conv_in"]["shift"],
                 "float32")
    # log(std + 1e-6) of two clouds: where they nearly agree the std
    # cancels, and an f32 rounding upstream moves log_scale by up to 2e-5
    # relative (read 1.6e-5)
    np.testing.assert_allclose(model.conv_in.log_scale.detach().numpy(),
                               v["params"]["conv_in"]["log_scale"],
                               rtol=1e-4, atol=1e-5)


def test_unported_encode_options_raise():
    for over in (dict(pre_group=True), dict(pos_embedding="mlp")):
        _, tcfg = cfgs(dict(C, **over))
        with pytest.raises(NotImplementedError):
            Compressor(tcfg, device="cpu")
