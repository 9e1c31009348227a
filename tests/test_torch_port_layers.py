"""ldt_torch.nn.layers vs ldt_tpu.nn.layers on the CPU.

The JAX blocks run with `fused_attention=True`, so their attention goes
through the Pallas kernels in interpret mode: the AdaLN self-attention
through K1 (packed path), the decoder-style cross-attention through K2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.nn.layers as jl
from ldt_torch import weights
from ldt_torch.nn import layers as tl
from test_torch_port_common import DTYPES, assert_close, to_np

B, N, M, D, H, DC = 4, 16, 8, 32, 4, 16


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sd(convert, p):
    """Convert one flax module's params with a weights.py rule."""
    sd = {}
    convert(sd, "m", jax.tree_util.tree_map(np.asarray, p), "m")
    return {k[2:]: v for k, v in sd.items()}


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 241).astype(np.float32)
    got = tl.get_activation("gelu")(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(jax.nn.gelu(x)),
                               rtol=1e-6, atol=1e-6)
    # the exact-erf GELU (torch's default) is far off at x = -4
    exact = torch.nn.functional.gelu(torch.tensor(-4.0)).item()
    assert abs(exact - float(jax.nn.gelu(-4.0))) > 0.3 * abs(exact)


@pytest.mark.parametrize("name", ["gelu", "selu", "silu", "swish",
                                  "hardswish", "leakyrelu", "leakyrelu0.2",
                                  "relu", None])
def test_activations_match(name):
    x = _rand((64,), 0) * 4
    got = tl.get_activation(name)(torch.from_numpy(x))
    want = jl.get_activation(name)(jnp.asarray(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_unknown_activation_and_norm_raise():
    with pytest.raises(NotImplementedError):
        tl.get_activation("mish")
    with pytest.raises(TypeError):
        tl.make_norm("rms_norm", 8)


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_epsilon_and_affine(affine):
    """eps is 1e-6 (not torch's 1e-5): visible on a low-variance input."""
    x = 1e-3 * _rand((2, 5, D), 1)
    ln = jl.make_norm("layer_norm", D, elementwise_affine=affine)
    v = ln.init(jax.random.key(0), jnp.asarray(x))
    want = ln.apply(v, jnp.asarray(x))
    tln = tl.make_norm("layer_norm", D, affine)
    assert (tln.weight is not None) == affine
    if affine:
        rng = np.random.default_rng(2)
        scale, bias = rng.standard_normal((2, D)).astype(np.float32)
        v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
        want = ln.apply(v, jnp.asarray(x))
        tln.load_state_dict({"weight": torch.from_numpy(scale),
                             "bias": torch.from_numpy(bias)})
    got = tln(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    torch_eps = torch.nn.functional.layer_norm(torch.from_numpy(x), (D,),
                                               eps=1e-5)
    if not affine:
        assert np.abs(to_np(torch_eps) - np.asarray(want)).max() > 1e-2


def test_sinusoidal_embedding():
    t = np.linspace(1.0, 1e-6, 7).astype(np.float32)
    want = jl.sinusoidal_embedding(jnp.asarray(t), 16)
    got = tl.sinusoidal_embedding(torch.from_numpy(t), 16)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_embedding(dtype):
    jd, td = DTYPES[dtype]
    t = np.linspace(1.0, 1e-6, 6).astype(np.float32)
    mod = jl.TimeEmbedding(4, DC, dtype=jd)
    v = mod.init(jax.random.key(1), jnp.asarray(t))
    want = mod.apply(v, jnp.asarray(t))
    tm = tl.TimeEmbedding(4, DC, dtype=td)
    tm.load_state_dict(_sd(weights._two_dense, v["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(t))
    assert got.dtype == td
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp(dtype):
    jd, td = DTYPES[dtype]
    x = _rand((B, N, D), 3)
    mod = jl.MLP(4 * D, D, dtype=jd)
    v = mod.init(jax.random.key(2), jnp.asarray(x))
    tm = tl.MLP(D, 4 * D, D, dtype=td)
    tm.load_state_dict(_sd(weights._two_dense, v["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got, mod.apply(v, jnp.asarray(x)), dtype)


def _adaln_block(dtype):
    jd, td = DTYPES[dtype]
    x, c = _rand((B, N, D), 4), _rand((B, DC), 5)
    jb = jl.ResidualBlock(D, dim_c=DC, num_heads=H, fused_attention=True,
                          dtype=jd)
    v = jb.init(jax.random.key(3), jnp.asarray(x), None, jnp.asarray(c))
    tb = tl.ResidualBlock(D, dim_c=DC, num_heads=H, dtype=td)
    tb.load_state_dict(_sd(weights._residual_block, v["params"]))
    return jb, v, tb, x, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_block_adaln_c_path(dtype):
    jb, v, tb, x, c = _adaln_block(dtype)
    want = jb.apply(v, jnp.asarray(x), None, jnp.asarray(c))
    with torch.no_grad():
        got = tb(torch.from_numpy(x), None, torch.from_numpy(c))
    # f32 x plus a bf16 attention branch promotes to f32 on both sides
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_block_adaln_mods_path(dtype):
    jb, v, tb, x, c = _adaln_block(dtype)
    mods = jb.apply(v, jnp.asarray(c[:1]), method=jl.ResidualBlock.compute_mods)
    want = jb.apply(v, jnp.asarray(x), mods=mods[0])
    with torch.no_grad():
        tmods = tb.compute_mods(torch.from_numpy(c[:1]))
        got = tb(torch.from_numpy(x), mods=tmods[0])
    assert_close(tmods, mods, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_block_unconditional_cross_path(dtype):
    """The decoder's block: affine norms, act=None, K/V from y (K2)."""
    jd, td = DTYPES[dtype]
    x, y = _rand((B, N, D), 6), _rand((B, M, D), 7)
    jb = jl.ResidualBlock(D, dim_c=None, num_heads=H, act=None,
                          fused_attention=True, dtype=jd)
    v = jb.init(jax.random.key(4), jnp.asarray(x), jnp.asarray(y))
    # non-trivial affine params, so a dropped scale or bias shows
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    rng = np.random.default_rng(8)
    for ln in ("LayerNorm_0", "LayerNorm_1"):
        p[ln] = {k: rng.standard_normal(a.shape).astype(np.float32)
                 for k, a in p[ln].items()}
    want = jb.apply({"params": p}, jnp.asarray(x), jnp.asarray(y))
    tb = tl.ResidualBlock(D, None, num_heads=H, act=None, dtype=td)
    tb.load_state_dict(_sd(weights._residual_block, p))
    with torch.no_grad():
        got = tb(torch.from_numpy(x), torch.from_numpy(y))
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["c", "mods"])
def test_final_layer(path, dtype):
    jd, td = DTYPES[dtype]
    x, c = _rand((B, N, D), 9), _rand((B, DC), 10)
    jf = jl.FinalLayer(8, dim_c=DC, dtype=jd)
    v = jf.init(jax.random.key(5), jnp.asarray(x), jnp.asarray(c))
    tf = tl.FinalLayer(D, 8, dim_c=DC, dtype=td)
    sd = {}
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    weights._dense(sd, "adaLN", p["adaLN"], "adaLN")
    weights._dense(sd, "ln", p["ln"], "ln")
    tf.load_state_dict(sd)
    with torch.no_grad():
        if path == "c":
            want = jf.apply(v, jnp.asarray(x), jnp.asarray(c))
            got = tf(torch.from_numpy(x), torch.from_numpy(c))
        else:
            mods = jf.apply(v, jnp.asarray(c[:1]),
                            method=jl.FinalLayer.compute_mods)[0]
            want = jf.apply(v, jnp.asarray(x), mods=mods)
            got = tf(torch.from_numpy(x),
                     mods=tf.compute_mods(torch.from_numpy(c[:1]))[0])
    assert_close(got, want, dtype)


def test_attention_ref_merge_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        tl.Attention(D, H, ref_merge=True)
