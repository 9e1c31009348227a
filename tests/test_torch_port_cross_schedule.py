"""K2's two schedules on the CPU: which one a shape takes
(`ops.attention.cross_schedule`), the constants `ops.attention` mirrors from
`ldt_torch/csrc/attention.cu`, and the long-key schedule's arithmetic as a
plain-PyTorch emulation held against the plain twin and against the JAX
package's Pallas kernel in interpret mode.

The emulation follows the CUDA launches step by step: per chunk of keys each
row's max m_c and sum l_c = sum exp(s - m_c); the merge in chunk order,
m = max m_c and l = sum_c l_c exp(m_c - m); the weights exp(s - m) / l
rounded to the input dtype; each chunk's f32 partial AV product; the
partials summed in chunk order. Its row sum differs from a direct one by a
few f32 ulps, and the card's limits (`chip_smoke.KERNEL_TOL`) must still
hold it, while the same arithmetic with the bf16 weights left unrounded
must fail them.
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
from test_torch_port_common import DTYPES

SOURCE = (_build.CSRC / "attention.cu").read_text()

# (n, m, dh): the decode and the encoder take the whole-set schedule; the
# posterior and every long shape of tests/test_torch_port_cuda.py the
# long-key one
WHOLE = [(2048, 32, 32), (32, 32, 32), (100, 45, 48), (70, 512, 32),
         (129, 31, 32), (129, 33, 48), (257, 33, 64), (50, 70, 20),
         (40, 512, 32)]
LONG_KEY = [(32, 2048, 32), (45, 3000, 48), (5, 20000, 64), (33, 2047, 32),
            (31, 2048, 16), (65, 2049, 48), (40, 127, 96), (40, 128, 96),
            (40, 129, 96), (32, 1000, 64), (50, 1500, 20), (20, 300, 256),
            (20, 100, 400), (40, 512, 64)]


@pytest.mark.parametrize("n,m,dh", WHOLE)
def test_whole_set_shapes(n, m, dh):
    assert ops.cross_schedule(n, m, dh) == "whole"


@pytest.mark.parametrize("n,m,dh", LONG_KEY)
def test_long_key_shapes(n, m, dh):
    assert ops.cross_schedule(n, m, dh) == "long_key"


def test_wide_heads_fit_neither_schedule():
    assert ops.cross_schedule(8, 2, 32768) is None
    assert ops.cross_lk_keys(256) == 64 and ops.cross_lk_keys(400) == 32
    assert ops.cross_lk_keys(32) == 128


def _constants():
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}


def test_constants_mirror_the_source():
    c = _constants()
    assert (c["kWholeThreads"], c["kWholeMaxDh"], c["kWholeChunk"],
            c["kLkThreads"], c["kLkRows"], c["kLkKeys"],
            c["kLkMinKeys"]) == (
        ops._WHOLE_THREADS, ops._WHOLE_MAX_DH, ops._WHOLE_CHUNK,
        ops._LK_THREADS, ops._LK_ROWS, ops._LK_KEYS, ops._LK_MIN_KEYS)
    # 4 query rows per warp, 32 keys per lane step
    assert c["kLkThreads"] // 32 * 4 == c["kLkRows"]
    assert c["kWholeChunk"] == 32 and c["kLkMinKeys"] == 32
    # the long-key workspace, as the C entry states it
    expr = re.search(r"one\) of (.+?) values", SOURCE).group(1)
    for b, n, m, d, h in [(64, 32, 2048, 128, 4), (2, 45, 3000, 96, 2),
                          (1, 20, 100, 400, 1)]:
        chunks = -(-m // ops.cross_lk_keys(d // h))
        want = eval(expr, {}, dict(b=b, n=n, d=d, h=h, chunks=chunks))
        assert ops.cross_lk_workspace(b, n, m, d, h) == want


def test_shared_memory_of_each_schedule_fits():
    for n, m, dh in WHOLE:
        assert ops.cross_whole_smem_bytes(m, dh) <= ops.SMEM_LIMIT
    for n, m, dh in LONG_KEY:
        assert ops.cross_lk_smem_bytes(dh, ops.cross_lk_keys(dh)) \
            <= ops.SMEM_LIMIT
    # the posterior's chunks leave room for 5 blocks per SM
    assert ops.cross_lk_smem_bytes(32, 128) <= ops.SMEM_LIMIT // 5


def lk_emulation(q, k, v, num_heads, keys, round_weights=True):
    """K2's long-key schedule in plain PyTorch (see the module doc)."""
    dt = q.dtype
    dh = q.shape[-1] // num_heads
    qh, kh, vh = (ops._heads(t, num_heads) for t in (q, k, v))
    starts = range(0, k.shape[1], keys)

    def scores(t0):
        return torch.matmul(qh, kh[:, :, t0:t0 + keys].transpose(-1, -2)) \
            * dh ** -0.5

    stats = []
    for t0 in starts:
        s = scores(t0)
        mc = s.amax(dim=-1, keepdim=True)
        stats.append((mc, torch.exp(s - mc).sum(dim=-1, keepdim=True)))
    mx = stats[0][0]
    for mc, _ in stats[1:]:
        mx = torch.maximum(mx, mc)
    total = torch.zeros_like(mx)
    for mc, lc in stats:
        total = total + lc * torch.exp(mc - mx)
    out = torch.zeros_like(qh)
    for t0 in starts:
        w = torch.exp(scores(t0) - mx) / total
        if round_weights:
            w = w.to(dt).to(qh.dtype)
        out = out + torch.matmul(w, vh[:, :, t0:t0 + keys])
    return ops._merge(out, dt)


def _errs(got, want):
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), diff.mean().item()


def _within(r, tol):
    return r[0] <= tol[0] and r[1] <= tol[1]


def _posterior_like(seed):
    """32 tokens over 1280 points (10 chunks of 128), 2 heads of width
    32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 32, 64), (2, 1280, 64), (2, 1280, 64))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_key_arithmetic_matches_the_twin_and_pallas(dtype):
    jd, td = DTYPES[dtype]
    arrays = _posterior_like(0)
    q, k, v = (torch.from_numpy(a).to(td) for a in arrays)
    keys = ops.cross_lk_keys(32)
    assert ops.cross_schedule(32, 1280, 32) == "long_key" and keys == 128
    got = lk_emulation(q, k, v, 2, keys)
    tol = KERNEL_TOL[dtype]
    twin = ops.attention_plain(q, k, v, 2)
    want = torch.from_numpy(np.array(pa.fused_attention(
        *(jnp.asarray(a, jd) for a in arrays), 2, True), np.float32))
    for r in (_errs(got, twin), _errs(got, want)):
        assert _within(r, tol), (r, tol)


def test_unrounded_bf16_weights_fail_the_limit():
    """The same arithmetic with the weights left in f32 before AV (a kernel
    template's slip) is told from the right one by KERNEL_TOL."""
    arrays = _posterior_like(1)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    keys = ops.cross_lk_keys(32)
    twin = ops.attention_plain(q, k, v, 2)
    right = _errs(lk_emulation(q, k, v, 2, keys), twin)
    wrong = _errs(lk_emulation(q, k, v, 2, keys, round_weights=False), twin)
    assert _within(right, KERNEL_TOL["bfloat16"]), right
    assert not _within(wrong, KERNEL_TOL["bfloat16"]), wrong


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_set_chunks_of_32_keys_match_the_twin(dtype):
    """The whole-set schedule's passes over 32-key chunks (max, then the
    sum, then the weights) as plain PyTorch at M=70: a direct row sum, so
    the twin's arithmetic up to the order of its sums."""
    _, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(td) for s in ((2, 130, 48), (2, 70, 48), (2, 70, 48)))
    qh, kh, vh = (ops._heads(t, 2) for t in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * 24 ** -0.5
    mx = torch.stack([c.amax(-1) for c in s.split(32, -1)], -1).amax(-1,
                                                                     True)
    e = torch.exp(s - mx)
    total = sum(c.sum(-1, keepdim=True) for c in e.split(32, -1))
    w = (e / total).to(td).float()
    got = ops._merge(torch.matmul(w, vh), td)
    assert _within(_errs(got, ops.attention_plain(q, k, v, 2)),
                   KERNEL_TOL[dtype])
