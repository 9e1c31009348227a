"""K8's int8 tensor-core schedule on the CPU: an emulation of its tile
arithmetic in numpy, held bit for bit against the plain twin
(`ops.attention.packed_self_attention_int8_plain`) and against the JAX
package's Pallas K8 in interpret mode as tests/test_torch_port_int8.py
holds the twin.

The emulation follows `packed_self_attention_int8_mma_kernel` and its scale
pass in `ldt_torch/csrc/attention.cu`:
  * the scale pass: per group, part (q|k|v) and slice of kScaleRows rows
    (read from the source) the max |x|; the main kernel merges the slices'
    maxima into max / 127 + 1e-20 (an IEEE division);
  * the codes in shared memory, as bytes: q and k rows [n, dh + 16], v
    transposed [dh, np + 16], the weight codes [n, np + 16], np = n rounded
    up to 32, the padding keys holding zero codes;
  * each warp's 16 query rows: `ldmatrix` x4 over those bytes with the
    kernel's lane addresses, `mma.sync` m16n8k32 s8 products (the PTX
    fragment layouts) summed in int32 over k-steps of 32, the scores
    `(float)acc * ((sq sk) dh^-1/2)` written from the accumulator fragments;
    the f32 softmax (the twin's: on the card it is the kernel's `expf`,
    which the card limits hold); the weight codes; the AV product the same
    way over v transposed, times sv / 127.
The integer dots are exact, so the emulation must give the twin's bits; a
layout slip (v not transposed, a slice's maximum left out) must not.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.pallas_attention as pa
from ldt_torch.ops import _build
from ldt_torch.ops import attention as ops
from test_torch_port_common import DTYPES, to_np

SOURCE = (_build.CSRC / "attention.cu").read_text()
SCALE_ROWS = int(re.search(r"constexpr int kScaleRows = (\d+);",
                           SOURCE).group(1))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --- the warp-level primitives, as PTX defines them -------------------------

def ldmatrix_x4(smem: np.ndarray, addrs) -> np.ndarray:
    """`ldmatrix.sync.aligned.m8n8.x4.b16` on a byte array: lanes 8j..8j+7
    give the 16-byte rows of matrix j; lane l receives the 32-bit word
    l % 4 of row l / 4 of each matrix. Returns [32 lanes, 4] of 4 int8."""
    regs = np.zeros((32, 4, 4), np.int8)
    for lane in range(32):
        for j in range(4):
            a = addrs[8 * j + lane // 4] + 4 * (lane % 4)
            regs[lane, j] = smem[a:a + 4]
    return regs


def mma_m16n8k32(acc: np.ndarray, a: np.ndarray, b0: np.ndarray,
                 b1: np.ndarray) -> None:
    """acc[32 lanes, 4] += A B for `mma.sync.aligned.m16n8k32.row.col.s32.
    s8.s8.s32`: lane (g, t) = (l / 4, l % 4) holds A[g][4t..], A[g+8][4t..],
    A[g][16+4t..], A[g+8][16+4t..] in a[l], B[4t..][g] and B[16+4t..][g] in
    b0[l], b1[l], and D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, 4 * t:4 * t + 4] = a[lane, 0]
        A[g + 8, 4 * t:4 * t + 4] = a[lane, 1]
        A[g, 16 + 4 * t:20 + 4 * t] = a[lane, 2]
        A[g + 8, 16 + 4 * t:20 + 4 * t] = a[lane, 3]
        B[4 * t:4 * t + 4, g] = b0[lane]
        B[16 + 4 * t:20 + 4 * t, g] = b1[lane]
    D = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        acc[lane] += (D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                      D[g + 8, 2 * t + 1])


# --- the kernel -------------------------------------------------------------

def scale_pass(x: np.ndarray, elems: int, drop_max_slice: bool = False):
    """The group scales [groups, 3] of a packed qkv x [B, N, 3D] (f32), from
    the slices' maxima; `drop_max_slice` leaves out the slice that holds a
    part's maximum (a slip the merge must not make)."""
    b, n, d3 = x.shape
    rows = elems * n
    slices = -(-rows // SCALE_ROWS)
    xg = np.abs(x.reshape(b // elems, rows, 3, d3 // 3))
    part = np.stack([xg[:, s * SCALE_ROWS:(s + 1) * SCALE_ROWS].max(
        axis=(1, 3)) for s in range(slices)], axis=-1)  # [groups, 3, slices]
    if drop_max_slice:
        part[np.arange(part.shape[0])[:, None], np.arange(3)[None, :],
             part.argmax(axis=-1)] = 0.0
    mx = torch.from_numpy(part.max(axis=-1))
    return ops.true_divide(mx, 127.0) + 1e-20


def codes(a: torch.Tensor, s: torch.Tensor) -> np.ndarray:
    """q8(a, s) = clip(round(a / s), -127, 127) as int8."""
    return torch.clamp(torch.round(a / s), -127.0, 127.0).to(
        torch.int8).numpy()


def head_attention(q8, k8, v8, sq, sk, sv, scale, transpose_v=True):
    """One head of the main kernel, warp by warp: q8, k8, v8 [n, dh] int8
    codes -> the output [n, dh] f32 (before the cast to the input dtype)."""
    n, dh = q8.shape
    np_ = -(-n // 32) * 32
    lq, lv = dh + 16, np_ + 16
    # the head's code bytes as the kernel lays them out
    qs, ks, vt = 0, n * lq, 2 * n * lq
    ws = vt + dh * lv
    smem = np.zeros(ws + n * lv, np.int8)
    for r in range(n):
        smem[qs + r * lq:qs + r * lq + dh] = q8[r]
        smem[ks + r * lq:ks + r * lq + dh] = k8[r]
    if transpose_v:
        for c in range(dh):
            smem[vt + c * lv:vt + c * lv + n] = v8[:, c]
    else:  # the slip: v's rows where its columns belong
        for c in range(min(dh, n)):
            smem[vt + c * lv:vt + c * lv + min(n, dh)] = v8[c, :min(n, dh)]
    qk_scale = (sq * sk) * scale
    out_scale = ops.true_divide(sv, 127.0)
    scores = torch.zeros(n, n)
    out = torch.zeros(n, dh)
    lanes = np.arange(32)
    g, t2 = torch.arange(32) // 4, (torch.arange(32) % 4) * 2
    for r0 in range(0, n, 16):
        s = np.zeros((n // 8, 32, 4), np.int64)
        for kk in range(0, dh, 32):
            qa = ldmatrix_x4(smem, qs + (r0 + (lanes & 15)) * lq + kk
                             + (lanes >> 4) * 16)
            for j in range(0, n // 8, 2):
                kb = ldmatrix_x4(smem, ks + (j * 8 + (lanes & 7)
                                             + ((lanes >> 4) << 3)) * lq
                                 + kk + ((lanes >> 3) & 1) * 16)
                mma_m16n8k32(s[j], qa, kb[:, 0], kb[:, 1])
                mma_m16n8k32(s[j + 1], qa, kb[:, 2], kb[:, 3])
        assert np.abs(s).max() <= 127 * 127 * dh < 2 ** 31  # exact in int32
        for j in range(n // 8):
            for e, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0), (8, 1))):
                scores[r0 + g + dr, j * 8 + t2 + dc] = torch.from_numpy(
                    s[j, :, e]).float() * qk_scale
        # the softmax and the weight codes of the warp's rows
        w = ops._softmax_rows(scores[r0:r0 + 16])
        w8 = torch.clamp(torch.round(w * 127.0), 0.0, 127.0).to(torch.int8)
        for r in range(16):
            smem[ws + (r0 + r) * lv:ws + (r0 + r) * lv + n] = w8[r].numpy()
        for c0 in range(0, dh, 32):
            acc = np.zeros((4, 32, 4), np.int64)
            for kk in range(0, np_, 32):
                wa = ldmatrix_x4(smem, ws + (r0 + (lanes & 15)) * lv + kk
                                 + (lanes >> 4) * 16)
                for jn in (0, 2):
                    vb = ldmatrix_x4(smem, vt + (c0 + jn * 8 + (lanes & 7)
                                                 + ((lanes >> 4) << 3)) * lv
                                     + kk + ((lanes >> 3) & 1) * 16)
                    mma_m16n8k32(acc[jn], wa, vb[:, 0], vb[:, 1])
                    mma_m16n8k32(acc[jn + 1], wa, vb[:, 2], vb[:, 3])
            for jn in range(4):
                for e, (dr, dc) in enumerate(((0, 0), (0, 1), (8, 0),
                                              (8, 1))):
                    out[r0 + g + dr, c0 + jn * 8 + t2 + dc] = \
                        torch.from_numpy(acc[jn, :, e]).float() * out_scale
    return out


def k8_emulation(qkv: torch.Tensor, num_heads: int, elems: int = 4,
                 drop_max_slice: bool = False, transpose_v: bool = True):
    """K8's int8 tensor-core schedule in numpy (see the module doc)."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    x = qkv.float()
    s = scale_pass(x.numpy(), elems, drop_max_slice)
    out = torch.empty(b, n, d)
    for e in range(b):
        sq, sk, sv = s[e // elems]
        for hh in range(num_heads):
            q8, k8, v8 = (codes(x[e, :, i * d + hh * dh:i * d + (hh + 1) * dh],
                                s[e // elems, i]) for i in range(3))
            out[e, :, hh * dh:(hh + 1) * dh] = head_attention(
                q8, k8, v8, sq, sk, sv, dh ** -0.5, transpose_v)
    return out.to(qkv.dtype), s


# (b, n, h, dh): the DiT's N and dh; N = 48 and 16, whose keys pad to 64
# and 32; dh = 96; N = 64
SHAPES = [(4, 32, 2, 64), (4, 48, 3, 32), (8, 16, 2, 96), (4, 64, 1, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,dh", SHAPES)
def test_emulation_gives_the_twins_bits(b, n, h, dh, dtype):
    t = torch.from_numpy(_rand((b, n, 3 * h * dh), n + dh)).to(
        DTYPES[dtype][1])
    got, scales = k8_emulation(t, h)
    assert torch.equal(got, ops.packed_self_attention_int8_plain(t, h))
    # the merged slice maxima are the scales of the whole group
    x = t.float().reshape(b // 4, 4 * n, 3, h * dh)
    assert torch.equal(scales, ops.true_divide(
        x.abs().amax(dim=(1, 3)), 127.0) + 1e-20)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulation_matches_pallas_int8(dtype, monkeypatch):
    """Against the Pallas K8 in interpret mode, as the twin is held in
    tests/test_torch_port_int8.py: bit for bit but for rare weight codes
    one step apart (exp and the row sum round differently), each moving
    one (element, row, head) slice by at most one v code step plus an
    output ulp; the scales as the Pallas kernel forms them, bit for bit."""
    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", True)
    jd, td = DTYPES[dtype]
    b, n, h, dh = 8, 32, 4, 64
    qkv = _rand((b, n, 3 * h * dh), 7)
    want = pa._fwd_call_packed(jnp.asarray(qkv, jd), h, True)
    t = torch.from_numpy(qkv).to(td)
    got, scales = k8_emulation(t, h)
    diff = np.abs(to_np(got) - to_np(want)).reshape(b, n, h, dh)
    flips = int((diff.max(axis=-1) > 0).sum())
    step = np.abs(to_np(t)[..., 2 * h * dh:]).max() / 127
    ulp = np.abs(to_np(want)).max() * (2.0 ** -7 if dtype == "bfloat16"
                                       else 2.0 ** -23)
    assert flips <= 4 and diff.max() <= step + ulp, (flips, diff.max())
    xf = jnp.asarray(to_np(t)).reshape(b // 4, 4 * n, 3 * h * dh)
    d = h * dh
    jax_scales = np.stack([np.stack(
        [np.asarray(jnp.max(jnp.abs(xf[g, :, i * d:(i + 1) * d])) / 127.0
                    + 1e-20) for i in range(3)]) for g in range(b // 4)])
    assert np.array_equal(scales.numpy(), jax_scales.astype(np.float32))


@pytest.mark.parametrize("slip", ["v not transposed", "a slice left out"])
def test_layout_slips_are_told(slip):
    """The same emulation with v's codes stored as rows, or with the slice
    holding a part's maximum left out of the merge, loses the twin's bits
    (v as rows: by most of the output's scale)."""
    b, n, h, dh = 4, 32, 2, 32
    t = torch.from_numpy(_rand((b, n, 3 * h * dh), 11))
    right, scales = k8_emulation(t, h)
    twin = ops.packed_self_attention_int8_plain(t, h)
    assert torch.equal(right, twin)
    if slip == "v not transposed":
        got, _ = k8_emulation(t, h, transpose_v=False)
        assert (got - twin).abs().max() > 0.1 * twin.abs().max()
    else:
        got, wrong_scales = k8_emulation(t, h, drop_max_slice=True)
        assert (wrong_scales < scales).all()
    assert not torch.equal(got, twin)


def test_scale_rows_split_the_flagship_group_over_the_card():
    """At the DiT's shape (B=64, E=4, N=32) the scale pass runs (group,
    part, slice) blocks: at least 2 per SM of an H100 (132)."""
    slices = -(-4 * 32 // SCALE_ROWS)
    assert 64 // 4 * 3 * slices >= 2 * 132
