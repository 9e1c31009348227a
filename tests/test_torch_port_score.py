"""ldt_torch Score vs ldt_tpu Score (small_score_cfg shape) on the CPU, the
JAX side with its Pallas attention kernels in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldt_tpu.models import Score as JaxScore
from ldt_torch.models import Score
from ldt_torch.weights import load_score, score_state_dict
from test_torch_port_common import (
    DTYPES,
    SMALL_SCORE,
    assert_close,
    cfgs,
    params_np,
)

B = 4


@functools.lru_cache(maxsize=None)
def _init():
    jcfg, _ = cfgs(SMALL_SCORE)
    x = np.random.default_rng(0).standard_normal(
        (B, jcfg.z_scale, jcfg.z_dim)).astype(np.float32)
    init = jax.jit(JaxScore(jcfg).init)
    return init(jax.random.key(1), jnp.asarray(x), jnp.ones((B,))), x


def _pair(dtype):
    jcfg, tcfg = cfgs(SMALL_SCORE)
    jd, td = DTYPES[dtype]
    v, x = _init()
    jm = JaxScore(jcfg, dtype=jd, fused_attention=True)
    tm = load_score(Score(tcfg, dtype=td, device="cpu"), params_np(v))
    return jm, v, tm, x


T = np.linspace(1.0, 1e-6, 5).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_precompute_mods(dtype):
    jm, v, tm, _ = _pair(dtype)
    want = jm.apply(v, jnp.asarray(T), method=JaxScore.precompute_mods)
    with torch.no_grad():
        got = tm.precompute_mods(torch.from_numpy(T))
    assert got["blocks"].shape == (5, SMALL_SCORE["num_blocks"],
                                   6 * SMALL_SCORE["hidden_size"])
    assert_close(got["blocks"], want["blocks"], dtype)
    assert_close(got["final"], want["final"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoise_with_mods(dtype):
    jm, v, tm, x = _pair(dtype)
    mods = jm.apply(v, jnp.asarray(T), method=JaxScore.precompute_mods)
    with torch.no_grad():
        tmods = tm.precompute_mods(torch.from_numpy(T))
        for step in (0, 4):
            want = jm.apply(v, jnp.asarray(x),
                            jax.tree_util.tree_map(lambda m: m[step], mods),
                            method=JaxScore.denoise_with_mods)
            got = tm.denoise_with_mods(
                torch.from_numpy(x), {k: m[step] for k, m in tmods.items()})
            assert str(got.dtype) == f"torch.{want.dtype}"
            assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward(dtype):
    jm, v, tm, x = _pair(dtype)
    t = np.full((B,), 0.3, np.float32)
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert_close(got, want, dtype)


def test_state_dict_keys_and_unmapped_leaf():
    _, tcfg = cfgs(SMALL_SCORE)
    p = params_np(_init()[0])
    sd = score_state_dict(p)
    assert set(sd) == set(Score(tcfg, device="cpu").state_dict())
    assert sd["transformer.0.attn.qkv.weight"].shape == (3 * 32, 32)
    p["transformer_1"]["attn"]["fc_x"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(ValueError, match="transformer_1/attn"):
        score_state_dict(p)


@pytest.mark.parametrize("over", [dict(unet=True), dict(condition=True),
                                  dict(num_categorys=3)])
def test_unported_variants_raise(over):
    _, tcfg = cfgs(dict(SMALL_SCORE, **over))
    with pytest.raises(NotImplementedError):
        Score(tcfg, device="cpu")
