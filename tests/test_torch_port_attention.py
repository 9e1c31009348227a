"""ldt_torch attention cores vs the JAX package's Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU, as
tests/test_pallas_attention.py does: K1 as `_fwd_call_packed` (the
multi-element phased kernel at B=4, the one-element phased kernel at B=2)
and K2 as `fused_attention`. The torch side is each kernel's plain twin,
which the wrappers use for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.pallas_attention as pa
from ldt_torch.ops import attention as ops
from test_torch_port_common import DTYPES, assert_close
from test_torch_port_csrc_syntax import host_rules

# bf16: both sides take f32 products and an f32 softmax and round the
# weights and the output to bf16, so they differ by about one output ulp.
ATTN_BF16_REL = 1e-2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [4, 2], ids=["multi_elems", "one_elem"])
def test_packed_self_attention_matches_pallas(b, dtype, monkeypatch):
    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", False)
    jd, td = DTYPES[dtype]
    n, h, dh = 32, 4, 16
    qkv = _rand((b, n, 3 * h * dh), 0)
    want = pa._fwd_call_packed(jnp.asarray(qkv, jd), h, True)
    got = ops.packed_self_attention(torch.from_numpy(qkv).to(td), h)
    assert got.dtype == td
    assert_close(got, want, dtype, ATTN_BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,d,h", [(64, 8, 64, 2), (256, 32, 128, 4)])
def test_cross_attention_matches_pallas(n, m, d, h, dtype):
    jd, td = DTYPES[dtype]
    q, k, v = _rand((2, n, d), 1), _rand((2, m, d), 2), _rand((2, m, d), 3)
    want = pa.fused_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                              jnp.asarray(v, jd), h, True)
    got = ops.cross_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                              h)
    assert got.dtype == td
    assert_close(got, want, dtype, ATTN_BF16_REL)


def test_plain_twins_match_reference_core_f32():
    """K1's twin equals K2's on the split qkv, and both the XLA oracle."""
    b, n, h, dh = 2, 16, 4, 8
    qkv = _rand((b, n, 3 * h * dh), 4)
    d = h * dh
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    want = pa.reference_attention_core(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), h)
    t = torch.from_numpy(qkv)
    packed = ops.packed_self_attention_plain(t, h)
    split = ops.attention_plain(t[..., :d], t[..., d:2 * d], t[..., 2 * d:], h)
    assert torch.equal(packed, split)
    assert_close(packed, want, "float32")


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch():
    qkv = torch.from_numpy(_rand((2, 8, 48), 5))
    q, kv = torch.from_numpy(_rand((2, 8, 16), 6)), torch.from_numpy(
        _rand((2, 4, 16), 7))
    k1, k2 = ops.packed_self_attention.launches, ops.cross_attention.launches
    assert torch.equal(ops.packed_self_attention(qkv, 2),
                       ops.packed_self_attention_plain(qkv, 2))
    assert torch.equal(ops.cross_attention(q, kv, kv, 2),
                       ops.attention_plain(q, kv, kv, 2))
    assert ops.packed_self_attention.launches == k1
    assert ops.cross_attention.launches == k2


def _bad_self_inputs():
    ok = torch.zeros(2, 8, 48)
    return {
        "float16": (TypeError, ok.half(), 2),
        "heads_do_not_divide": (ValueError, ok, 5),
        "not_3d": (ValueError, ok[0], 2),
        "not_3xD": (ValueError, torch.zeros(2, 8, 47), 1),
        "non_contiguous": (ValueError, torch.zeros(2, 48, 8).transpose(1, 2),
                           2),
        "beyond_shared_memory": (ValueError, torch.zeros(1, 512, 3 * 64), 1),
    }


@pytest.mark.parametrize("case", list(_bad_self_inputs()))
def test_packed_self_attention_rejects(case):
    exc, x, h = _bad_self_inputs()[case]
    with pytest.raises(exc):
        ops.packed_self_attention(x, h)


def _bad_cross_inputs():
    q, kv = torch.zeros(2, 8, 16), torch.zeros(2, 4, 16)
    return {
        "mixed_dtypes": (ValueError, (q, kv.bfloat16(), kv.bfloat16()), 2),
        "kv_shapes_differ": (ValueError, (q, kv, torch.zeros(2, 5, 16)), 2),
        "width_differs": (ValueError, (q, torch.zeros(2, 4, 8),
                                       torch.zeros(2, 4, 8)), 2),
        "heads_do_not_divide": (ValueError, (q, kv, kv), 3),
        "non_contiguous": (ValueError, (torch.zeros(2, 16, 8).transpose(1, 2),
                                        kv, kv), 2),
        # a chunk of 32 keys 32768 wide
        "beyond_shared_memory": (ValueError, (torch.zeros(1, 8, 32768),
                                              torch.zeros(1, 2, 32768),
                                              torch.zeros(1, 2, 32768)), 1),
    }


@pytest.mark.parametrize("case", list(_bad_cross_inputs()))
def test_cross_attention_rejects(case):
    exc, args, h = _bad_cross_inputs()[case]
    with pytest.raises(exc):
        ops.cross_attention(*args, h)


def test_shared_memory_bounds_admit_the_main_path_shapes():
    assert ops.self_smem_bytes(32, 64) <= 48 * 1024
    assert ops.cross_whole_smem_bytes(32, 32) <= 48 * 1024
    # K2 keeps other M whole up to its bound (the conditional Score's
    # cross-attention will give it other key counts)
    assert ops.cross_whole_smem_bytes(512, 32) <= ops.SMEM_LIMIT
    # the posterior's 2048 keys take the long-key schedule in chunks of
    # 128; K3 at the DiT's shape
    assert ops.cross_whole_smem_bytes(2048, 32) > ops.SMEM_LIMIT
    assert ops.cross_lk_smem_bytes(32, 128) <= 48 * 1024
    assert ops.cross_schedule(32, 2048, 32) == "long_key"
    assert ops.cross_schedule(32, 40000, 32) == "long_key"
    # (both of K3's kernels: the rule in csrc/rules.h that the library
    # launches by, built here by the host compiler)
    assert all(host_rules().ldt_self_bwd_smem_bytes(32, 64, tiled)
               <= 48 * 1024 for tiled in (0, 1))
