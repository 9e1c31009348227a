"""ldt_torch Score vs ldt_tpu Score (small_score_cfg shape) on the CPU, the
JAX side with its Pallas attention kernels in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import InvalidRngError

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


@pytest.mark.parametrize("over", [dict(unet=True), dict(condition=True)])
def test_unported_variants_raise(over):
    """The UNet and the conditional Score are ported (their forwards are
    held in test_torch_port_condition.py) and build with JAX's names, now
    with a nonzero dropout rate too (held in test_torch_port_dropout.py);
    what raises is what raises in the JAX package: a train-mode forward
    without dropout masks (flax: no 'dropout' rng)."""
    jcfg, tcfg = cfgs(dict(SMALL_SCORE, **over, dropout=0.1))
    cond = None
    if jcfg.condition:
        cond = {"img": jnp.zeros((B, 16, 16, 3)),
                "pts": jnp.asarray(np.random.default_rng(0).standard_normal(
                    (B, 64, 3)), jnp.float32)}
    x = jnp.zeros((B, jcfg.z_scale, jcfg.z_dim))
    v = jax.jit(JaxScore(jcfg).init)(jax.random.key(1), x, jnp.ones((B,)),
                                     None, cond)
    with pytest.raises(InvalidRngError):
        JaxScore(jcfg).apply(v, x, jnp.ones((B,)), None, cond, train=True,
                             mutable=["batch_stats"])
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    sd = score_state_dict(v["params"], v.get("batch_stats"))
    score = Score(tcfg, device="cpu")
    assert set(sd) == set(score.state_dict())
    tcond = None if cond is None else {
        k: torch.from_numpy(np.asarray(a)) for k, a in cond.items()}
    with pytest.raises(ValueError, match="dropout"):
        score(torch.zeros(x.shape), torch.ones(B), None, tcond, train=True)


@pytest.mark.parametrize("over", [dict(num_categorys=3), dict(AdaLN=False)],
                         ids=["labels", "adaln_off"])
def test_ported_variants_build_with_jax_names(over):
    """Label conditioning and the AdaLN=False block, once refused: their
    state_dict is the converter's of JAX's init (the forwards are held in
    test_torch_port_labels.py and test_torch_port_layer_branches.py)."""
    jcfg, tcfg = cfgs(dict(SMALL_SCORE, **over))
    label = jnp.zeros((B,), jnp.int32) if "num_categorys" in over else None
    v = jax.jit(JaxScore(jcfg).init)(
        jax.random.key(1), jnp.zeros((B, jcfg.z_scale, jcfg.z_dim)),
        jnp.ones((B,)), label)
    assert set(score_state_dict(params_np(v))) == set(
        Score(tcfg, device="cpu").state_dict())
