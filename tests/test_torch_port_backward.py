"""K3, the backward of K1: its plain twin against `jax.vjp` of the JAX
package's `fused_attention_packed` (the Pallas backward kernels in
interpret mode), the autograd.Function that pairs K1 and K3, and the
wrappers that refuse to drop a gradient (K1 called directly, K2, K8)."""

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


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_vjp(qkv, g, h, dtype):
    jd = DTYPES[dtype][0]
    _, vjp = jax.vjp(lambda x: pa.fused_attention_packed(x, h, True),
                     jnp.asarray(qkv, jd))
    return vjp(jnp.asarray(g, jd))[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phased", [True, False], ids=["phased", "per_head"])
@pytest.mark.parametrize("b,n,h,dh", [(2, 32, 4, 16), (3, 17, 3, 8)])
def test_k3_twin_matches_jax_vjp(b, n, h, dh, phased, dtype, monkeypatch):
    """`_bwd_kernel_packed_phased` (default) and `_bwd_kernel_packed`."""
    monkeypatch.setattr(pa, "_PHASED_BWD", phased)
    qkv, g = _rand((b, n, 3 * h * dh), 0), _rand((b, n, h * dh), 1)
    want = _jax_vjp(qkv, g, h, dtype)
    td = DTYPES[dtype][1]
    got = ops.packed_self_attention_bwd_plain(
        torch.from_numpy(qkv).to(td), torch.from_numpy(g).to(td), h)
    assert got.dtype == td and got.shape == qkv.shape
    assert_close(got, want, dtype, BWD_BF16_REL)


def test_k3_twin_rounds_where_the_tpu_kernel_does():
    """In bf16 the weights are rounded before dv and ds before dq and dk;
    a twin that skips the roundings lands thousands of times further from
    JAX's gradient (mean), while the twin stays at rounding noise."""
    b, n, h, dh = 2, 32, 4, 16
    qkv, g = _rand((b, n, 3 * h * dh), 2), _rand((b, n, h * dh), 3)
    want = np.asarray(_jax_vjp(qkv, g, h, "bfloat16").astype(jnp.float32))
    t = (torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16())
    got = ops.packed_self_attention_bwd_plain(*t, h).float().numpy()
    unrounded = ops.packed_self_attention_bwd_plain(
        t[0].float(), t[1].float(), h).bfloat16().float().numpy()
    right = np.abs(got - want).mean()
    wrong = np.abs(unrounded - want).mean()
    assert wrong > 100 * right, (right, wrong)  # read 4.5e-8 vs 3.1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_self_attention_function_is_k1_then_k3(dtype):
    td = DTYPES[dtype][1]
    h = 4
    qkv = torch.from_numpy(_rand((2, 8, 3 * h * 8), 4)).to(td)
    g = torch.from_numpy(_rand((2, 8, h * 8), 5)).to(td)
    x = qkv.clone().requires_grad_(True)
    out = ops.PackedSelfAttention.apply(x, h)
    assert torch.equal(out.detach(), ops.packed_self_attention_plain(qkv, h))
    out.backward(g)
    assert torch.equal(x.grad, ops.packed_self_attention_bwd_plain(qkv, g, h))


def test_k3_twin_equals_autograd_of_the_plain_forward_in_f32():
    h = 2
    qkv = torch.from_numpy(_rand((2, 12, 3 * h * 8), 6)).double()
    g = torch.from_numpy(_rand((2, 12, h * 8), 7)).double()
    x = qkv.clone().requires_grad_(True)
    ops.packed_self_attention_plain(x, h).backward(g)
    got = ops.packed_self_attention_bwd_plain(qkv.float(), g.float(), h)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_attention_takes_the_function_only_with_grad():
    attn = Attention(16, 2, device="cpu")
    x = torch.from_numpy(_rand((2, 8, 16), 8))
    out = attn(x)
    found, stack = False, [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None:
            continue
        found |= "PackedSelfAttention" in type(fn).__name__
        stack += [f for f, _ in fn.next_functions]
    assert found
    with torch.no_grad():
        assert torch.equal(attn(x), out.detach())
    with torch.inference_mode():
        assert attn(x).grad_fn is None


def test_cpu_backward_counts_no_launch():
    h = 2
    qkv, g = torch.zeros(1, 4, 24), torch.zeros(1, 4, 8)
    before = ops.packed_self_attention_bwd.launches
    assert torch.equal(ops.packed_self_attention_bwd(qkv, g, h),
                       ops.packed_self_attention_bwd_plain(qkv, g, h))
    assert ops.packed_self_attention_bwd.launches == before


def _bad_bwd_inputs():
    qkv, g = torch.zeros(2, 8, 48), torch.zeros(2, 8, 16)
    return {
        "g_shape": (qkv, torch.zeros(2, 8, 48)),
        "g_dtype": (qkv, g.bfloat16()),
        "g_not_contiguous": (qkv, torch.zeros(2, 16, 8).transpose(1, 2)),
        "beyond_shared_memory": (torch.zeros(1, 128, 3 * 256),
                                 torch.zeros(1, 128, 256)),
    }


@pytest.mark.parametrize("case", list(_bad_bwd_inputs()))
def test_packed_self_attention_bwd_rejects(case):
    qkv, g = _bad_bwd_inputs()[case]
    with pytest.raises(ValueError):
        ops.packed_self_attention_bwd(qkv, g, 2 if qkv.shape[0] == 2 else 1)


def _grad_inputs():
    def q():
        return torch.zeros(4, 8, 16)

    def kv():
        return torch.zeros(4, 4, 16)

    return {
        "K1": lambda t: ops.packed_self_attention(t(torch.zeros(4, 8, 48)),
                                                  2),
        "K2": lambda t: ops.cross_attention(t(q()), kv(), kv(), 2),
        "K2_keys": lambda t: ops.cross_attention(q(), t(kv()), kv(), 2),
        "K8": lambda t: ops.packed_self_attention_int8(
            t(torch.zeros(4, 8, 48)), 2),
    }


@pytest.mark.parametrize("kernel", list(_grad_inputs()))
def test_kernels_without_backward_refuse_grad(kernel):
    """No silent zero gradient: with grad mode on and an input that requires
    grad, K1 (called directly), K2 and K8 raise; without, they run."""
    call = _grad_inputs()[kernel]
    with pytest.raises(RuntimeError, match="no gradient"):
        call(lambda t: t.requires_grad_(True))
    with torch.no_grad():
        call(lambda t: t.requires_grad_(True))
    call(lambda t: t)
