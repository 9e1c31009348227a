"""ldt_torch Compressor (decode half) vs ldt_tpu Compressor on the CPU, the
JAX side's decoder cross-attention through the Pallas kernel K2 in
interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldt_tpu.models import Compressor as JaxCompressor
from ldt_torch.models import Compressor
from ldt_torch.weights import (
    compressor_decode_state_dict,
    is_decode_key,
    load_compressor_decoder,
)
from test_torch_port_common import (
    DTYPES,
    SMALL_COMPRESSOR,
    assert_close,
    cfgs,
    params_np,
)

B = 2


@functools.lru_cache(maxsize=None)
def _init():
    jcfg, _ = cfgs(SMALL_COMPRESSOR)
    v = jax.jit(JaxCompressor(jcfg).init)(
        {"params": jax.random.key(1), "sample": jax.random.key(2)},
        jnp.zeros((B, 64, 3)))
    return params_np(v)


def _eps(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg["z_scales"], cfg["n_layers"] * cfg["z_dim"])).astype(
            np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_matches(dtype):
    jcfg, tcfg = cfgs(SMALL_COMPRESSOR)
    jd, td = DTYPES[dtype]
    p = _init()
    eps = _eps(SMALL_COMPRESSOR)
    want = JaxCompressor(jcfg, dtype=jd, fused_attention=True).apply(
        {"params": p}, (B, 64), jnp.asarray(eps),
        method=JaxCompressor.sample)
    tm = Compressor(tcfg, dtype=td, device="cpu")
    load_compressor_decoder(tm, p)
    with torch.no_grad():
        got = tm.sample((B, 64), torch.from_numpy(eps))
    assert got.shape == (B, 64, 3)
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert_close(got, want, dtype)


def test_decoder_runs_in_reverse_on_its_eps_slices():
    """Block n_layers-1-idx takes eps[..., idx*z_dim:(idx+1)*z_dim]: feeding
    the blocks in forward order, or the slices swapped, changes the cloud."""
    _, tcfg = cfgs(SMALL_COMPRESSOR)
    tm = Compressor(tcfg, device="cpu")
    load_compressor_decoder(tm, _init())
    eps = torch.from_numpy(_eps(SMALL_COMPRESSOR, 1))
    z = tcfg.z_dim
    with torch.no_grad():
        got = tm.sample((B, 64), eps)
        o = tm.init_set(B, 64)
        for idx in range(tcfg.n_layers):
            o = tm.decoder[tcfg.n_layers - 1 - idx](
                o, eps[..., idx * z:(idx + 1) * z])
        assert torch.equal(got, tm.output_dense(o))
        swapped = torch.cat([eps[..., z:], eps[..., :z]], dim=-1)
        assert not torch.allclose(tm.sample((B, 64), swapped), got)


def test_initial_set_broadcasts_the_prior():
    _, tcfg = cfgs(SMALL_COMPRESSOR)
    tm = Compressor(tcfg, device="cpu")
    o = tm.init_set(3, 64)
    assert o.shape == (3, 64, tcfg.hidden_dim)
    assert torch.equal(o[2], tm.init_set.prior)
    with pytest.raises(NotImplementedError):
        tm.init_set(3, 32)  # random subset: a later slice


def test_weight_converter_reports_what_it_leaves():
    _, tcfg = cfgs(SMALL_COMPRESSOR)
    sd, left = compressor_decode_state_dict(_init())
    assert set(sd) == {k for k in Compressor(tcfg, device="cpu").state_dict()
                       if is_decode_key(k)}
    assert "decoder_0/att/attn/fc_q/kernel" in left
    assert "decoder_1/prior_dense/bias" in left
    assert "encoder_0/att0/adaLN/kernel" in left
    assert "group/affine_alpha" in left
    assert not any(p.startswith(("decoder_0/att1", "output_dense",
                                 "init_set")) for p in left)


def test_weight_converter_raises_on_an_unmapped_decoder_leaf():
    p = _init()
    p = dict(p, decoder_1=dict(p["decoder_1"]))
    p["decoder_1"]["att1"] = dict(p["decoder_1"]["att1"],
                                  shortcut={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="decoder_1/att1"):
        compressor_decode_state_dict(p)


def test_unported_variants_raise():
    _, tcfg = cfgs(dict(SMALL_COMPRESSOR, class_condition=True))
    with pytest.raises(NotImplementedError):
        Compressor(tcfg, device="cpu")
    _, tcfg = cfgs(dict(SMALL_COMPRESSOR, max_outputs=None))
    with pytest.raises(NotImplementedError):
        Compressor(tcfg, device="cpu")
