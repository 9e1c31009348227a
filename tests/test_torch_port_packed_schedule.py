"""K1's three schedules on the CPU: which one a shape takes
(`ops.attention.packed_schedule`), the constants `ops.attention` mirrors
from `ldt_torch/csrc/attention.cu`, and the tensor-core schedule's
arithmetic as a plain-PyTorch emulation held against the plain twin and
against the JAX package's Pallas K1 in interpret mode.

The emulation follows `packed_self_attention_mma_kernel`: bf16 operands,
whose products are exact in f32; the scores summed over k-steps of 16
channels, each an f32 partial (an m16n8k16 product), added in order; the
f32 softmax (max-shifted, exp, divided by the row sum); the weights rounded
to bf16; the AV product over k-steps of 16 keys the same way; the output
rounded to bf16. Its sums run in another order than the twin's, and the
card's limits (`chip_smoke.KERNEL_TOL`) must still hold it, while the same
arithmetic with the weights left unrounded must fail them.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.pallas_attention as pa
from chip_smoke import KERNEL_TOL
from ldt_torch.ops import _build
from ldt_torch.ops import attention as ops

SOURCE = (_build.CSRC / "attention.cu").read_text()
BF16, F32 = torch.bfloat16, torch.float32

# (n, dh, dtype, aligned, schedule)
RULE = [(32, 64, BF16, True, "mma"),        # the DiT's generation shape
        (16, 16, BF16, True, "mma"), (48, 32, BF16, True, "mma"),
        (64, 128, BF16, True, "mma"), (64, 64, BF16, True, "mma"),
        (32, 64, F32, True, "tiled"),       # training's f32
        (17, 24, F32, True, "tiled"), (5, 4, F32, True, "tiled"),
        (64, 96, F32, True, "tiled"), (80, 64, F32, True, "tiled"),
        (32, 64, F32, False, "fma"),        # unaligned rows
        (32, 30, F32, True, "fma"),         # dh not a multiple of 4
        (64, 128, F32, True, "tiled"), (100, 64, F32, True, "tiled"),
        (128, 64, F32, True, "fma"),        # past the shared memory
        (64, 256, F32, True, "fma"),
        (32, 64, BF16, False, "fma"),           # unaligned rows
        (17, 64, BF16, True, "fma"), (8, 64, BF16, True, "fma"),
        (80, 64, BF16, True, "fma"), (32, 24, BF16, True, "fma"),
        (32, 48, BF16, True, "fma"), (32, 256, BF16, True, "fma")]


@pytest.mark.parametrize("n,dh,dtype,aligned,schedule", RULE)
def test_packed_schedule_rule(n, dh, dtype, aligned, schedule):
    assert ops.packed_schedule(n, dh, dtype, aligned) == schedule


def _constants():
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}


def test_constants_mirror_the_source():
    c = _constants()
    assert (c["kMmaHeads"], c["kMmaMaxN"], c["kMmaPad"]) == (
        ops._MMA_HEADS, ops._MMA_MAX_N, ops._MMA_PAD)
    rule = re.search(r"bool self_mma\(.*?\n}", SOURCE, re.S).group(0)
    assert tuple(int(v) for v in re.findall(r"dh == (\d+)", rule)) \
        == ops._MMA_DH
    assert "n % 16 == 0 && n >= 16 && n <= kMmaMaxN" in rule
    assert "dtype == kDtypeBF16" in rule and "% 16 == 0" in rule
    expr = re.search(r"size_t self_mma_smem_bytes\(int n, int dh\) {\s*"
                     r"return (.+?);", SOURCE, re.S).group(1)
    expr = (expr.replace("sizeof(__nv_bfloat16)", "2")
            .replace("(size_t)", "").replace("kMmaHeads", "4")
            .replace("kMmaPad", "8"))
    for n, dh in [(32, 64), (64, 128), (16, 16)]:
        assert eval(expr, {}, dict(n=n, dh=dh)) \
            == ops.self_mma_smem_bytes(n, dh)
    # every shape the rule takes fits; a block is at most 4 heads x 4 warps
    for n in range(16, 65, 16):
        for dh in ops._MMA_DH:
            assert ops.self_mma_smem_bytes(n, dh) <= ops.SMEM_LIMIT
    assert re.search(r"__launch_bounds__\(kMmaHeads\* kMmaMaxN / 16 \* 32\)",
                     SOURCE)
    # the generation shape: 2 blocks per SM fit in shared memory
    assert 2 * ops.self_mma_smem_bytes(32, 64) <= ops.SMEM_LIMIT


def test_tiled_constants_mirror_the_source():
    """The register-tiled f32 rule and its shared memory, read from the
    source: kTileHeads, the rule's terms and the byte count."""
    c = _constants()
    assert c["kTileHeads"] == ops._TILE_HEADS
    # a block's threads take one 4 x 4 output tile each at the train
    # step's shape (N = 32, dh = 64: 8 x 16 tiles a head)
    assert c["kTileThreads"] == ops._TILE_HEADS * (32 // 4) * (64 // 4)
    rule = re.search(r"bool self_tiled\(.*?\n}", SOURCE, re.S).group(0)
    for term in ("dtype == kDtypeF32", "dh % 4 == 0", "aligned16(qkv)",
                 "aligned16(out)", "self_tiled_smem_bytes(n, dh) <= kMaxSmem"):
        assert term in rule, term
    body = re.search(r"size_t self_tiled_smem_bytes\(int n, int dh\) {\s*"
                     r"const size_t n4 = (.+?);\s*return (.+?);", SOURCE,
                     re.S)
    n4_expr, expr = body.groups()
    expr = (expr.replace("sizeof(float)", "4").replace("kTileHeads", "2")
            .replace("lk_ld(dh)", "lk_ld"))
    for n, dh in [(32, 64), (17, 24), (64, 96), (5, 4), (128, 64)]:
        n4 = eval(n4_expr.replace("/", "//"), {}, dict(n=n))
        assert eval(expr, {}, dict(n4=n4, lk_ld=ops.lk_ld(dh))) \
            == ops.self_tiled_smem_bytes(n, dh)
    # the train step's shape: a block needs no more than the default 48 KB,
    # and 4 blocks fit an SM, so its 512 blocks are resident at once
    assert ops.self_tiled_smem_bytes(32, 64) <= 48 * 1024
    assert 4 * ops.self_tiled_smem_bytes(32, 64) <= ops.SMEM_LIMIT


def mma_emulation(qkv, num_heads, round_weights=True):
    """K1's tensor-core schedule in plain PyTorch (see the module doc)."""
    d = qkv.shape[-1] // 3
    dh = d // num_heads
    qh, kh, vh = (ops._heads(t, num_heads) for t in (
        qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]))
    s = torch.zeros(qh.shape[:-1] + (qh.shape[-2],))
    for k0 in range(0, dh, 16):
        s = s + torch.matmul(qh[..., k0:k0 + 16],
                             kh[..., k0:k0 + 16].transpose(-1, -2))
    s = s * dh ** -0.5
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    if round_weights:
        w = w.to(BF16).float()
    out = torch.zeros_like(qh)
    for k0 in range(0, s.shape[-1], 16):
        out = out + torch.matmul(w[..., k0:k0 + 16], vh[..., k0:k0 + 16, :])
    return ops._merge(out, BF16)


def _errs(got, want):
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), diff.mean().item()


def _within(r, tol):
    return r[0] <= tol[0] and r[1] <= tol[1]


def _qkv(seed, b=4, n=32, h=4, dh=64):
    """A DiT-like packed qkv: N=32 tokens, heads of width 64, bf16."""
    return np.random.default_rng(seed).standard_normal(
        (b, n, 3 * h * dh)).astype(np.float32)


@pytest.mark.parametrize("n,dh", [(32, 64), (48, 32), (16, 128)])
def test_mma_arithmetic_matches_the_twin_and_pallas(n, dh, monkeypatch):
    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", False)
    arr = _qkv(0, n=n, dh=dh)
    assert ops.packed_schedule(n, dh, BF16) == "mma"
    qkv = torch.from_numpy(arr).to(BF16)
    got = mma_emulation(qkv, 4)
    twin = ops.packed_self_attention_plain(qkv, 4)
    want = torch.from_numpy(np.array(pa._fwd_call_packed(
        jnp.asarray(arr, jnp.bfloat16), 4, True), np.float32))
    tol = KERNEL_TOL["bfloat16"]
    for r in (_errs(got, twin), _errs(got, want)):
        assert _within(r, tol), (r, tol)


def test_unrounded_weights_fail_the_limit():
    """The same arithmetic with the f32 weights fed to AV unrounded (a
    kernel's slip) is told from the right one by KERNEL_TOL."""
    qkv = torch.from_numpy(_qkv(1)).to(BF16)
    twin = ops.packed_self_attention_plain(qkv, 4)
    right = _errs(mma_emulation(qkv, 4), twin)
    wrong = _errs(mma_emulation(qkv, 4, round_weights=False), twin)
    assert _within(right, KERNEL_TOL["bfloat16"]), right
    assert not _within(wrong, KERNEL_TOL["bfloat16"]), wrong


def test_cpu_bf16_takes_the_twin_and_counts_no_mma_launch():
    qkv = torch.from_numpy(_qkv(2)).to(BF16)
    fn = ops.packed_self_attention
    before = (fn.launches, fn.mma_launches)
    assert torch.equal(fn(qkv, 4), ops.packed_self_attention_plain(qkv, 4))
    assert (fn.launches, fn.mma_launches) == before
