"""The reference's head merge (`ref_merge=True`): ldt_torch's attention,
Score and Compressor against ldt_tpu's with `ref_merge=True`, forward and
gradient, on the CPU. The JAX package computes the scrambled merge in XLA
(its Pallas core is off under `ref_merge`); the port keeps its kernels' path
(K1/K2 forward, K3/K4 backward through `PackedSelfAttention` and
`CrossAttention`, their plain twins here) and permutes their output. The
standard merge on the same weights must miss. Tolerances: f32 forward 1e-5
(test_torch_port_layers), gradients rtol 1e-4 (test_torch_port_training's
gradient limit)."""

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
from ldt_torch.nn import layers as tl
from ldt_torch.ops import attention as attn_ops
from test_torch_port_common import (
    F32_TOL,
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    assert_close,
    cfgs,
    compressor_variables,
    params_np,
    pin_reparameterize,
    to_np,
)

B, N, M, D, H = 2, 16, 8, 32, 4
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_ref_merge_is_the_reshape_without_the_transpose():
    """[B, N, H, dh] standard merge -> the [B, H, N, dh] tensor's bytes read
    as [B, N, D]."""
    att = torch.arange(B * N * D, dtype=torch.float32).reshape(B, N, D)
    heads = att.reshape(B, N, H, D // H).transpose(1, 2)  # [B, H, N, dh]
    assert torch.equal(tl.ref_merge(att, H), heads.reshape(B, N, D))
    assert not torch.equal(tl.ref_merge(att, H), att)


class _Spy:
    """Counts the autograd Functions of the kernels' path."""

    def __init__(self, monkeypatch):
        self.calls = {"self": 0, "cross": 0}
        for name, key in (("PackedSelfAttention", "self"),
                          ("CrossAttention", "cross")):
            real = getattr(attn_ops, name).apply

            def apply(*a, real=real, key=key):
                self.calls[key] += 1
                return real(*a)

            monkeypatch.setattr(getattr(attn_ops, name), "apply", apply)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention_forward_and_gradient(cross, monkeypatch):
    x, y, g = _rand((B, N, D), 1), _rand((B, M, D), 2), _rand((B, N, D), 3)
    jm = jl.Attention(D, H, ref_merge=True)
    yy = y if cross else x
    v = params_np(jm.init(jax.random.key(0), jnp.asarray(x),
                          jnp.asarray(yy)))

    def jloss(p, xx):  # self-attention: x is the keys' input too
        return jnp.sum(jm.apply({"params": p}, xx,
                                jnp.asarray(y) if cross else xx) * g)

    want = jm.apply({"params": v}, jnp.asarray(x), jnp.asarray(yy))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(v, jnp.asarray(x))
    sd = {}
    weights._residual_block(sd, "m", {
        "attn": v, "mlp": {f"Dense_{i}": {"kernel": np.zeros((D, D)),
                                          "bias": np.zeros(D)}
                           for i in (0, 1)}}, "m")
    sd = {k[len("m.attn."):]: t for k, t in sd.items() if ".attn." in k}
    spy = _Spy(monkeypatch)
    tm = tl.Attention(D, H, ref_merge=True)
    tm.load_state_dict(sd)
    tx = _t(x).requires_grad_(True)
    got = tm(tx, _t(y) if cross else None)
    (got * _t(g)).sum().backward()
    assert spy.calls == {"self": int(not cross), "cross": int(cross)}
    assert_close(got, want, "float32")
    grads = {"qkv.weight": tm.qkv.weight.grad,
             "fc_o.weight": tm.fc_o.weight.grad}
    jq = np.concatenate([np.asarray(gp["fc_q"]["kernel"]).T,
                         np.asarray(gp["fc_kv"]["kernel"]).T])
    np.testing.assert_allclose(to_np(grads["qkv.weight"]), jq, **GRAD_TOL)
    np.testing.assert_allclose(to_np(grads["fc_o.weight"]),
                               np.asarray(gp["fc_o"]["kernel"]).T,
                               **GRAD_TOL)
    np.testing.assert_allclose(to_np(tx.grad), np.asarray(gx), **GRAD_TOL)
    std = tl.Attention(D, H)
    std.load_state_dict(sd)
    with torch.no_grad():
        other = std(_t(x), _t(y) if cross else None)
    assert np.abs(to_np(other) - np.asarray(want)).max() > 1e-2


@functools.lru_cache(maxsize=None)
def _score_params():
    jcfg, _ = cfgs(SMALL_SCORE)
    return params_np(jax.jit(JaxScore(jcfg).init)(
        jax.random.key(4), jnp.zeros((2, jcfg.z_scale, jcfg.z_dim)),
        jnp.ones((2,))))


def test_score_forward_and_gradient(monkeypatch):
    x = _rand((B, SMALL_SCORE["z_scale"], SMALL_SCORE["z_dim"]), 5)
    g = _rand(x.shape, 6)
    t = np.array([0.7, 0.1], np.float32)
    jm = JaxScore(cfgs(SMALL_SCORE)[0], ref_merge=True)
    p = jax.tree_util.tree_map(jnp.asarray, _score_params())
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
    jgrads = weights.score_state_dict(params_np({"params": jax.grad(
        lambda q: jnp.sum(jm.apply({"params": q}, jnp.asarray(x),
                                   jnp.asarray(t)) * g))(p)}))
    spy = _Spy(monkeypatch)
    tm = weights.load_score(Score(cfgs(SMALL_SCORE)[1], device="cpu",
                                  ref_merge=True), _score_params())
    got = tm(_t(x), _t(t))
    (got * _t(g)).sum().backward()
    assert spy.calls["self"] == SMALL_SCORE["num_blocks"]
    assert_close(got, want, "float32")
    for k, p_ in tm.named_parameters():
        np.testing.assert_allclose(to_np(p_.grad), to_np(jgrads[k]),
                                   err_msg=k, **GRAD_TOL)
    std = weights.load_score(Score(cfgs(SMALL_SCORE)[1], device="cpu"),
                             _score_params())
    with torch.no_grad():
        other = std(_t(x), _t(t))
    assert np.abs(to_np(other) - np.asarray(want)).max() > 1e-3


@functools.lru_cache(maxsize=None)
def _comp_variables():
    """JAX's init (its weights' scale: gradients through the grouper's
    eval-mode BatchNorms stay at the stage-1 test's conditioning)."""
    return compressor_variables(SMALL_COMPRESSOR, _rand((B, 64, 3), 7))


def test_compressor_forward_and_gradient(monkeypatch):
    """Every block (encoder, posterior, decoder) with the reference's
    merge; eval-mode forward with pinned noise and the gradient of a
    weighted sum of the decoded set."""
    v = _comp_variables()
    pts, w = _rand((B, 64, 3), 8), _rand((B, 64, 3), 9)
    noise = [_rand((B, SMALL_COMPRESSOR["z_scales"],
                    SMALL_COMPRESSOR["z_dim"]), 10 + i)
             for i in range(SMALL_COMPRESSOR["n_layers"])]
    jm = jcm.Compressor(cfgs(SMALL_COMPRESSOR)[0], ref_merge=True)
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def jloss(p):
        pin_reparameterize(monkeypatch, noise)
        out = jm.apply({"params": p, "batch_stats": jv["batch_stats"]},
                       jnp.asarray(pts), rngs={"sample": jax.random.key(0)})
        return jnp.sum(out["set"] * w), out["set"]

    (_, want), gp = jax.value_and_grad(jloss, has_aux=True)(jv["params"])
    jgrads = {k: t for k, t in weights.compressor_state_dict(
        {"params": params_np({"params": gp}),
         "batch_stats": v["batch_stats"]}).items() if "running_" not in k}
    spy = _Spy(monkeypatch)
    tm = weights.load_compressor(
        Compressor(cfgs(SMALL_COMPRESSOR)[1], device="cpu",
                   ref_merge=True).eval(), v)
    got = tm(_t(pts), noise=[_t(e) for e in noise])["set"]
    (got * _t(w)).sum().backward()
    layers = SMALL_COMPRESSOR["n_layers"]
    assert spy.calls == {"self": 0, "cross": layers * (
        SMALL_COMPRESSOR["encoder_layers"] + 2)}
    np.testing.assert_allclose(to_np(got), np.asarray(want), **F32_TOL)
    # relative to each tensor's largest gradient: the path back through the
    # grouper sums over every grouped point, and an element near 0 carries
    # the others' rounding
    for k, p_ in tm.named_parameters():
        err = float((p_.grad - jgrads[k]).abs().max())
        scale = float(jgrads[k].abs().max())
        assert err <= GRAD_TOL["rtol"] * scale + GRAD_TOL["atol"], (
            k, err, scale)
    std = weights.load_compressor(
        Compressor(cfgs(SMALL_COMPRESSOR)[1], device="cpu").eval(), v)
    with torch.no_grad():
        other = std(_t(pts), noise=[_t(e) for e in noise])["set"]
    assert np.abs(to_np(other) - np.asarray(want)).max() > 1e-3
