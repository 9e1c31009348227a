"""K3's register-tiled kernel on the CPU: the rule that picks it and its
shared-memory size (`ldt_self_bwd_tiled` and `ldt_self_bwd_smem_bytes` in
`ldt_torch/csrc/rules.h`, which the library launches by, built here by the
host compiler), and its arithmetic as a plain-PyTorch emulation in which
K3's five products run either as the scalar kernel maps them (a thread per
element) or as the tiled kernel does (4 x 4 register tiles).

The tiled kernel runs K4's register-tiled products on a head's n x n
problem (the source check below holds it to that), so the emulation takes
K4's from `test_torch_port_bwd_tiles`: each product element is the same
f32 FMA chain in both mappings (the scores and dw over the channels, dk and
dv over the query rows, dq over the keys, each ascending), and a tiled
thread owns rows rt + rn i and keys kt + rn j of the scores and dw, keys
4 jt + i and channels 4 ct + j of dk and dv, rows rt + rn i and channels
4 ct + j of dq, rows and keys padded to a multiple of 4. The tiles gather
their operands by those indices, so the two mappings give the same bits
only if the tiles cover every element once with the right operands; a
ragged n (30) leaves the last tiles half in the padding. Both are held
against the plain twin and against `jax.vjp` of the JAX package's Pallas
attention (`_bwd_kernel_packed_phased` in interpret mode) under K3's card
limit (`chip_smoke.K3_TOL`).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.pallas_attention as pa
from chip_smoke import K3_TOL
from ldt_torch.ops import _build
from ldt_torch.ops import attention as ops
from test_torch_port_bwd_tiles import _round, dk_dv_sums, dq_sums, scores
from test_torch_port_common import DTYPES
from test_torch_port_csrc_syntax import host_rules

SOURCE = (_build.CSRC / "attention.cu").read_text()
H, DH = 2, 16


def k3_emulation(qkv, g, h, tiled):
    """The packed dqkv of K3, its products in the tiled or the scalar
    mapping."""
    dt = qkv.dtype
    d = qkv.shape[-1] // 3
    scale = torch.tensor((d // h) ** -0.5, dtype=torch.float32)
    q, k, v = (ops._heads(qkv[..., i * d:(i + 1) * d], h) for i in range(3))
    gh = ops._heads(g, h)
    s = scores(q, k, tiled) * scale
    dw = scores(gh, v, tiled)
    w = torch.softmax(s, dim=-1)
    ds = _round(w * (dw - (dw * w).sum(-1, keepdim=True)), dt)
    dq = dq_sums(ds, k, tiled) * scale
    dk = dk_dv_sums(ds, q, tiled) * scale
    dv = dk_dv_sums(_round(w, dt), gh, tiled)
    return torch.cat([ops._merge(t, dt) for t in (dq, dk, dv)], dim=-1)


def _inputs(b, n, seed, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, n, c)).astype(
        np.float32)).to(dtype) for c in (3 * H * DH, H * DH))


def _jax_vjp(qkv, g, h):
    jd = DTYPES["float32" if qkv.dtype == torch.float32 else "bfloat16"][0]
    _, vjp = jax.vjp(lambda x: pa.fused_attention_packed(x, h, True),
                     jnp.asarray(qkv.float().numpy(), jd))
    out = vjp(jnp.asarray(g.float().numpy(), jd))[0]
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _errs(got, want):
    """(max, mean) of |got - want| relative to max|want|."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().max()
    return (diff.max() / scale).item(), (diff.mean() / scale).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n", [32, 30], ids=["train_n", "ragged"])
def test_tiled_mapping_gives_the_scalar_chains(n, dtype):
    qkv, g = _inputs(2, n, n, dtype)
    assert host_rules().ldt_self_bwd_tiled(n, DH, 1)
    tiled = k3_emulation(qkv, g, H, tiled=True)
    scalar = k3_emulation(qkv, g, H, tiled=False)
    assert tiled.dtype == dtype and tiled.shape == qkv.shape
    assert torch.equal(tiled, scalar)
    tol = K3_TOL[str(dtype).split(".")[1]]
    for want in (ops.packed_self_attention_bwd_plain(qkv, g, H),
                 _jax_vjp(qkv, g, H)):
        r = _errs(tiled, want)
        assert r[0] <= tol[0] and r[1] <= tol[1], r


def test_k3_tol_tells_dq_from_dk():
    """The emulation tells the products apart: dq and dk exchanged in the
    packed output are far outside K3_TOL."""
    qkv, g = _inputs(1, 32, 5, torch.float32)
    d = H * DH
    got = k3_emulation(qkv, g, H, tiled=True)
    swapped = torch.cat([got[..., d:2 * d], got[..., :d], got[..., 2 * d:]],
                        dim=-1)
    r = _errs(swapped, ops.packed_self_attention_bwd_plain(qkv, g, H))
    assert r[0] > K3_TOL["float32"][0] and r[1] > K3_TOL["float32"][1]


@pytest.mark.parametrize("n,dh,aligned,tiled", [
    (32, 64, True, True), (30, 64, True, True), (17, 24, True, True),
    (64, 128, True, True), (1, 4, True, True), (32, 64, False, False),
    (32, 30, True, False), (17, 6, True, False), (128, 256, True, False)])
def test_tiled_rule(n, dh, aligned, tiled):
    assert host_rules().ldt_self_bwd_tiled(n, dh, int(aligned)) == tiled


def test_tiled_sizes_and_rule_mirror_the_source():
    lib = host_rules()
    smem, tiled = lib.ldt_self_bwd_smem_bytes, lib.ldt_self_bwd_tiled
    # at the train step's shape (N=32, dh=64, rows of stride 68): q, k, v, g
    # and the [32, 40] weights and ds, 44 KB, so that the four blocks a SM
    # that the kernel's registers allow fit a SM's 228 KB (a block also
    # holds 1 KB for the system); the scalar kernel's q, g [32, 64], k, v
    # [32, 65] and [32, 32] weights and ds
    assert smem(32, 64, 1) == 4 * (4 * 32 * 68 + 2 * 32 * 40) == 45056
    assert 4 * (smem(32, 64, 1) + 1024) <= 228 * 1024
    assert re.search(r"kSelfBwdTileThreads = 256;\s+constexpr int "
                     r"kSelfBwdTileBlocks = 4;", SOURCE)
    assert smem(32, 64, 0) == 4 * (2 * 32 * 64 + 2 * 32 * 65 + 2 * 32 * 32)
    # the rule flips where the tiled layout passes a block's, as n grows
    k = next(x for x in range(8, 400) if smem(x, 64, 1) > ops.SMEM_LIMIT)
    assert tiled(k - 1, 64, 1) == 1 and tiled(k, 64, 1) == 0
    # dh a multiple of 4, and aligned rows
    assert [tiled(32, dh, 1) for dh in (60, 62, 64, 65)] == [1, 0, 1, 0]
    assert tiled(32, 64, 0) == 0
    # the entry launches by that rule, on all three operands' alignment, and
    # the kernel's products are K4's tiled ones on the n x n problem
    entry = re.search(r"cudaError_t launch_self_bwd\(.*?\n}", SOURCE,
                      re.S).group(0)
    assert re.search(r"self_bwd_tiled\(n, dh, aligned16\(qkv\) && "
                     r"aligned16\(g\) &&\s+aligned16\(dqkv\)\)", entry)
    kernel = re.search(r"packed_self_attention_bwd_tiled_kernel\(const T\* "
                       r".*?\n}", SOURCE, re.S).group(0)
    for call in (r"scores_and_dw_tiled\(qs, gs, ks, vs, ws, ds, n, n, lds, "
                 r"dh, scale\)", r"dq_tiled\(ds, ks, n, n, lds, dh,",
                 r"dk_dv_tiled<T>\(ws, ds, qs, gs, n, n, lds, dh,",
                 r"softmax_ds_row<T>\("):
        assert re.search(call, kernel), call
