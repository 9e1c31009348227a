"""K4, the backward of K2: its plain twin against `jax.vjp` of the JAX
package's `fused_attention` (the Pallas kernels `_fwd_kernel` and
`_bwd_kernel` in interpret mode) and against torch autograd, the
autograd.Function that pairs K2 and K4 (gradcheck in f64), the attention
layer's use of it, and the wrapper's checks and schedule choice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.pallas_attention as pa
from ldt_torch.nn.layers import Attention
from ldt_torch.ops import attention as ops
from test_torch_port_common import DTYPES, assert_close

# bf16: both sides take f32 products and softmax and round the weights, ds
# and the gradients to bf16 at the same places; the sums run in other
# orders, so a rounded ds or gradient can land one bf16 ulp away.
BWD_BF16_REL = 1e-2
H = 2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _inputs(b, n, m, d, seed):
    return (_rand((b, n, d), seed), _rand((b, m, d), seed + 1),
            _rand((b, m, d), seed + 2), _rand((b, n, d), seed + 3))


def _jax_vjp(q, k, v, g, h, dtype):
    jd = DTYPES[dtype][0]
    _, vjp = jax.vjp(lambda a, b, c: pa.fused_attention(a, b, c, h, True),
                     *(jnp.asarray(t, jd) for t in (q, k, v)))
    return vjp(jnp.asarray(g, jd))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(8, 8), (8, 300), (300, 8)],
                         ids=["square", "long_keys", "long_queries"])
def test_k4_twin_matches_jax_vjp(n, m, dtype):
    """300 is a multiple of no tile of either schedule."""
    q, k, v, g = _inputs(2, n, m, 32, 0)
    want = _jax_vjp(q, k, v, g, H, dtype)
    td = DTYPES[dtype][1]
    got = ops.cross_attention_bwd_plain(
        *(torch.from_numpy(t).to(td) for t in (q, k, v, g)), H)
    for gt, wt, like in zip(got, want, (q, k, v)):
        assert gt.dtype == td and gt.shape == like.shape
        if dtype == "float32":  # relative 1e-5 of the gradient's scale
            wt = np.asarray(wt)
            np.testing.assert_allclose(gt.numpy(), wt, rtol=1e-5,
                                       atol=1e-5 * np.abs(wt).max())
        else:
            assert_close(gt, wt, dtype, BWD_BF16_REL)


def test_k4_twin_rounds_where_the_tpu_kernel_does():
    """In bf16, w is rounded before dv and ds before dq and dk, and ds is
    taken from the unrounded w: a twin without the roundings lands far
    further from JAX's gradients (mean) than the twin."""
    q, k, v, g = _inputs(2, 32, 48, 32, 10)
    want = [np.asarray(t.astype(jnp.float32))
            for t in _jax_vjp(q, k, v, g, H, "bfloat16")]
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v, g)]
    got = ops.cross_attention_bwd_plain(*t, H)
    unrounded = ops.cross_attention_bwd_plain(*(a.float() for a in t), H)
    right = max(np.abs(a.float().numpy() - w).mean()
                for a, w in zip(got, want))
    wrong = max(np.abs(a.bfloat16().float().numpy() - w).mean()
                for a, w in zip(unrounded, want))
    assert wrong > 100 * right, (right, wrong)


def test_k4_twin_equals_autograd_of_the_plain_forward():
    q, k, v, g = (torch.from_numpy(a).double()
                  for a in _inputs(2, 12, 20, 16, 20))
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.attention_plain(*x, H).backward(g)
    got = ops.cross_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        g.float(), H)
    for gt, xt in zip(got, x):
        np.testing.assert_allclose(gt.numpy(), xt.grad.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_k3_twin_is_k4_twin_on_the_packed_qkv():
    qkv, g = _rand((2, 9, 3 * 24), 30), _rand((2, 9, 24), 31)
    t = torch.from_numpy(qkv)
    got = ops.packed_self_attention_bwd_plain(t, torch.from_numpy(g), 3)
    want = ops.cross_attention_bwd_plain(t[..., :24], t[..., 24:48],
                                         t[..., 48:], torch.from_numpy(g), 3)
    assert torch.equal(got, torch.cat(want, dim=-1))


def test_cross_attention_function_passes_gradcheck_in_f64():
    gen = torch.Generator().manual_seed(0)
    x = [torch.randn(2, n, 8, dtype=torch.float64, generator=gen,
                     requires_grad=True) for n in (5, 7, 7)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.CrossAttention.apply(q, k, v, H), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_function_is_k2_then_k4(dtype):
    td = DTYPES[dtype][1]
    q, k, v, g = (torch.from_numpy(a).to(td) for a in _inputs(2, 9, 6, 16,
                                                                40))
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.CrossAttention.apply(*x, H)
    assert torch.equal(out.detach(), ops.attention_plain(q, k, v, H))
    out.backward(g)
    for t, want in zip(x, ops.cross_attention_bwd_plain(q, k, v, g, H)):
        assert torch.equal(t.grad, want)


def _function_names(out):
    names, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None:
            names.add(type(fn).__name__)
            stack += [f for f, _ in fn.next_functions]
    return names


def test_attention_cross_branch_takes_the_function_only_with_grad():
    attn = Attention(16, H, device="cpu")
    x, y = (torch.from_numpy(_rand((2, n, 16), 50 + n)) for n in (8, 5))
    out = attn(x, y)
    assert any("CrossAttention" in n for n in _function_names(out))
    with torch.no_grad():
        assert torch.equal(attn(x, y), out.detach())
    out.sum().backward()
    assert attn.qkv.weight.grad.abs().sum() > 0


def test_cpu_backward_counts_no_launch():
    q, k, v, g = (torch.zeros(1, n, 8) for n in (4, 3, 3, 4))
    before = ops.cross_attention_bwd.launches
    got = ops.cross_attention_bwd(q, k, v, g, H)
    want = ops.cross_attention_bwd_plain(q, k, v, g, H)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.cross_attention_bwd.launches == before


@pytest.mark.parametrize("n,m,dh,want", [
    (32, 32, 32, 32),      # encoder blocks, a posterior: one tile
    (2048, 32, 32, 128),   # decoder att1: 16 tiles of 128 rows
    (32, 2048, 32, 0),     # posterior over the decoded set: long keys
    (8, 300, 32, 8),       # k and v fit with 32 rows; 8 is all of N
    (2048, 4096, 64, None),
])
def test_k4_schedule_fits_shared_memory(n, m, dh, want):
    rows = ops.cross_bwd_schedule(n, m, dh)
    assert rows == want
    if rows:
        assert ops.cross_bwd_lq_smem_bytes(m, dh, rows) <= ops.SMEM_LIMIT
        assert (rows == n or rows == 128
                or ops.cross_bwd_lq_smem_bytes(m, dh, 2 * rows)
                > ops.SMEM_LIMIT)
    elif rows == 0:
        assert ops.cross_bwd_lk_smem_bytes(n, dh) <= ops.SMEM_LIMIT


def _bad_inputs():
    q, k, g = torch.zeros(2, 8, 16), torch.zeros(2, 4, 16), torch.zeros(2, 8,
                                                                        16)
    return {
        "g_shape": (q, k, k, torch.zeros(2, 4, 16)),
        "g_dtype": (q, k, k, g.bfloat16()),
        "g_not_contiguous": (q, k, k, torch.zeros(2, 16, 8).transpose(1, 2)),
        "kv_shape": (q, k, torch.zeros(2, 5, 16), g),
        "beyond_shared_memory": (torch.zeros(1, 2048, 128),
                                 torch.zeros(1, 4096, 128),
                                 torch.zeros(1, 4096, 128),
                                 torch.zeros(1, 2048, 128)),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_cross_attention_bwd_rejects(case):
    with pytest.raises(ValueError):
        ops.cross_attention_bwd(*_bad_inputs()[case], H)


def test_half_precision_is_refused_and_f64_runs_only_on_the_cpu():
    q = torch.zeros(1, 4, 8)
    with pytest.raises(TypeError, match="float64 on the CPU"):
        ops.cross_attention_bwd(q.half(), q.half(), q.half(), q.half(), H)
    got = ops.cross_attention_bwd(*(q.double() for _ in range(4)), H)
    assert all(t.dtype == torch.float64 for t in got)
