"""K4's register-tiled kernels on the CPU: the rule that picks them and
their shared-memory sizes (`ldt_cross_bwd_tiled` in `ldt_torch/csrc/rules.h`,
which the library launches by, built here by the host compiler), and the
two schedules' arithmetic as a plain-PyTorch emulation in which the three
products run either as the scalar kernels map them (a thread per element)
or as the tiled kernels do (4 x 4 register tiles).

Each product element is the same f32 FMA chain in both mappings: the scores
and dw over the channels, dk and dv over the rows, dq over the keys, each
ascending (an f32 FMA is emulated as the f64 product, exact for f32
operands, plus the addend, rounded once to f64 and then to f32; both
mappings share it). A tiled thread owns rows rt + rn i and keys kt + kn j
of the scores and dw, keys 4 jt + i and channels 4 ct + j of dk and dv,
rows rt + rn i and channels 4 ct + j of dq, with rows and keys padded to
multiples of 4. The emulation gathers each tile's operands by those indices,
so the two mappings give the same bits only if the tiles cover every
element once with the right operands. Around the products it runs the
schedules' steps: the long-query schedule's row tiles and their dk/dv
partials summed in tile order; the long-key schedule's 64-key chunks, their
row statistics merged in chunk order and their dq partials summed in chunk
order. Both are held against the plain twin and against `jax.vjp` of the
JAX package's Pallas attention (`_bwd_kernel` in interpret mode) under K4's
card limit (`chip_smoke.K4_TOL`).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.pallas_attention as pa
from chip_smoke import K4_TOL
from ldt_torch.ops import _build
from ldt_torch.ops import attention as ops
from test_torch_port_common import DTYPES
from test_torch_port_csrc_syntax import host_rules

SOURCE = (_build.CSRC / "attention.cu").read_text()
H = 2


def _fma(a, b, c):
    """f32 fmaf(a, b, c) of f32 tensors."""
    return (a.double() * b.double() + c.double()).float()


def _chain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., P, L] @ b [..., L, Q] with every element the FMA chain over
    l = 0, 1, ... L - 1."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for l in range(a.shape[-1]):
        acc = _fma(a[..., :, l, None], b[..., l, None, :], acc)
    # one layout for both mappings: torch's row sums downstream follow it
    return acc.contiguous()


def _tiled_mm(a, b, row_idx, col_idx, p, q):
    """`_chain_mm` computed tile by tile: tile t holds rows row_idx[t] and
    columns col_idx[t] (4 each) of the [p, q] result; a and b are padded
    (with zeros) to every index the tiles name. Every element of the
    result must be written exactly once."""
    at = a[..., row_idx, :]                              # [..., T, 4, L]
    bt = b[..., :, col_idx].movedim(-2, -3)              # [..., T, L, 4]
    tiles = _chain_mm(at, bt)                            # [..., T, 4, 4]
    out = torch.zeros(*a.shape[:-2], p, q)
    hits = torch.zeros(p, q, dtype=torch.int64)
    for t in range(row_idx.shape[0]):
        for i in range(4):
            for j in range(4):
                r, c = int(row_idx[t, i]), int(col_idx[t, j])
                if r < p and c < q:
                    out[..., r, c] = tiles[..., t, i, j]
                    hits[r, c] += 1
    assert bool((hits == 1).all())
    return out


def _pad_rows(t, rows):
    return torch.cat([t, t.new_zeros(*t.shape[:-2], rows - t.shape[-2],
                                     t.shape[-1])], dim=-2)


def _strided(n):
    """(rows [T, 4], n4 / 4) of tiles rt + rn i, rt < rn = ceil(n / 4)."""
    rn = -(-n // 4)
    return torch.arange(rn)[:, None] + rn * torch.arange(4)[None], rn


def _blocked(n):
    """Tiles 4 t + i, t < ceil(n / 4)."""
    return 4 * torch.arange(-(-n // 4))[:, None] + torch.arange(4)[None]


def _outer(a_idx, b_idx):
    """Every pair (a tile, b tile), b fastest: ([T, 4], [T, 4])."""
    ta, tb = a_idx.shape[0], b_idx.shape[0]
    return a_idx.repeat_interleave(tb, 0), b_idx.repeat(ta, 1)


def scores(x, y, tiled):
    """x [.., n, dh] against y [.., m, dh]: each element's chain over the
    channels (the scores and dw)."""
    n, m = x.shape[-2], y.shape[-2]
    if not tiled:
        return _chain_mm(x, y.transpose(-1, -2))
    rows, rn = _strided(n)
    keys, kn = _strided(m)
    r, k = _outer(rows, keys)
    return _tiled_mm(_pad_rows(x, 4 * rn), _pad_rows(y, 4 * kn).transpose(
        -1, -2), r, k, n, m)


def dq_sums(ds, k, tiled):
    """ds [.., n, tm] @ k [.., tm, dh]: each element's chain over the
    keys."""
    n, dh = ds.shape[-2], k.shape[-1]
    if not tiled:
        return _chain_mm(ds, k)
    rows, rn = _strided(n)
    r, c = _outer(rows, _blocked(dh))
    return _tiled_mm(_pad_rows(ds, 4 * rn), k, r, c, n, dh)


def dk_dv_sums(w, x, tiled):
    """w^T [.., tm, nr] @ x [.., nr, dh]: each element's chain over the
    rows."""
    tm, dh = w.shape[-1], x.shape[-1]
    wt = w.transpose(-1, -2)
    if not tiled:
        return _chain_mm(wt, x)
    keys = _blocked(tm)
    r, c = _outer(keys, _blocked(dh))
    return _tiled_mm(_pad_rows(wt, 4 * keys.shape[0]), x, r, c, tm, dh)


def _round(t, dt):
    return t.to(dt).float()


def k4_emulation(q, k, v, g, h, tiled):
    """(dq, dk, dv) of K4's schedule `cross_bwd_schedule` picks, with its
    products in the tiled or the scalar mapping."""
    dt = q.dtype
    b, n, d = q.shape
    m = k.shape[1]
    dh = d // h
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    qh, kh, vh, gh = (ops._heads(t, h) for t in (q, k, v, g))
    rows = ops.cross_bwd_schedule(n, m, dh)
    if rows:  # long-query: row tiles, dk/dv partials summed in tile order
        dq = torch.zeros(b, h, n, dh)
        dk = torch.zeros(b, h, m, dh)
        dv = torch.zeros(b, h, m, dh)
        for r0 in range(0, n, rows):
            qt, gt = qh[..., r0:r0 + rows, :], gh[..., r0:r0 + rows, :]
            s = scores(qt, kh, tiled) * scale
            dw = scores(gt, vh, tiled)
            w = torch.softmax(s, dim=-1)
            ds = _round(w * (dw - (dw * w).sum(-1, keepdim=True)), dt)
            dq[..., r0:r0 + rows, :] = dq_sums(ds, kh, tiled) * scale
            dk = dk + dk_dv_sums(ds, qt, tiled)
            dv = dv + dk_dv_sums(_round(w, dt), gt, tiled)
        dk = dk * scale
    else:  # long-key: 64-key chunks
        keys = 64
        starts = range(0, m, keys)
        parts = []
        for t0 in starts:
            s = scores(qh, kh[..., t0:t0 + keys, :], tiled) * scale
            dw = scores(gh, vh[..., t0:t0 + keys, :], tiled)
            mc = s.amax(-1, keepdim=True)
            e = torch.exp(s - mc)
            parts.append((s, dw, mc, e.sum(-1, keepdim=True),
                          (dw * e).sum(-1, keepdim=True)))
        mx = parts[0][2]
        for p in parts[1:]:
            mx = torch.maximum(mx, p[2])
        total = torch.zeros_like(mx)
        dot = torch.zeros_like(mx)
        for _, _, mc, sc, dc in parts:
            f = torch.exp(mc - mx)
            total = total + sc * f
            dot = dot + dc * f
        dot = dot / total
        dq = torch.zeros(b, h, n, dh)
        dks, dvs = [], []
        for t0, (s, dw, _, _, _) in zip(starts, parts):
            w = torch.exp(s - mx) / total
            ds = _round(w * (dw - dot), dt)
            kc, vc = kh[..., t0:t0 + keys, :], vh[..., t0:t0 + keys, :]
            dks.append(dk_dv_sums(ds, qh, tiled) * scale)
            dvs.append(dk_dv_sums(_round(w, dt), gh, tiled))
            dq = dq + dq_sums(ds, kc, tiled)
        dq = dq * scale
        dk, dv = torch.cat(dks, dim=-2), torch.cat(dvs, dim=-2)
    return tuple(ops._merge(t, dt) for t in (dq, dk, dv))


def _inputs(b, n, m, d, seed, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, x, d)).astype(
        np.float32)).to(dtype) for x in (n, m, m, n))


def _jax_vjp(q, k, v, g, h):
    jd = DTYPES["float32" if q.dtype == torch.float32 else "bfloat16"][0]
    _, vjp = jax.vjp(lambda a, b, c: pa.fused_attention(a, b, c, h, True),
                     *(jnp.asarray(t.float().numpy(), jd) for t in (q, k, v)))
    return [torch.from_numpy(np.array(t.astype(jnp.float32)))
            for t in vjp(jnp.asarray(g.float().numpy(), jd))]


def _errs3(got, want):
    """(max, mean) over dq, dk, dv of |got - want| relative to max|want|."""
    e = []
    for a, w in zip(got, want):
        diff = (a.float() - w.float()).abs()
        scale = w.float().abs().max()
        e.append(((diff.max() / scale).item(), (diff.mean() / scale).item()))
    return max(x[0] for x in e), max(x[1] for x in e)


# (n, m): one tile of 9 rows over 10 keys (both ragged); long keys (2047:
# a last chunk of 63); long queries (300: three row tiles of 128, 10 keys)
SHAPES = {"square": (9, 10), "long_keys": (9, 2047),
          "long_queries": (300, 10)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(SHAPES))
def test_tiled_mapping_gives_the_pr4_chains(kind, dtype):
    n, m = SHAPES[kind]
    d = 16 * H
    q, k, v, g = _inputs(1, n, m, d, n + m, dtype)
    rows = ops.cross_bwd_schedule(n, m, d // H)
    assert (rows == 0) == (kind == "long_keys")
    assert (rows and n > rows) == (kind == "long_queries")
    assert host_rules().ldt_cross_bwd_tiled(n, m, d // H, rows, 1)
    tiled = k4_emulation(q, k, v, g, H, tiled=True)
    pr4 = k4_emulation(q, k, v, g, H, tiled=False)
    for a, b in zip(tiled, pr4):
        assert a.dtype == dtype and torch.equal(a, b)
    tol = K4_TOL[str(dtype).split(".")[1]]
    twin = ops.cross_attention_bwd_plain(q, k, v, g, H)
    r = _errs3(tiled, twin)
    assert r[0] <= tol[0] and r[1] <= tol[1], r
    r = _errs3(tiled, _jax_vjp(q, k, v, g, H))
    assert r[0] <= tol[0] and r[1] <= tol[1], r


def test_a_mapping_that_misses_a_strided_row_fails():
    """Tiles of the scores that take rows rt + i (not rt + rn i) leave rows
    unwritten or written twice: `_tiled_mm` refuses them."""
    x = torch.randn(1, 1, 9, 8)
    rows, rn = _strided(9)
    wrong = torch.arange(rn)[:, None] + torch.arange(4)[None]
    keys, kn = _strided(9)
    r, k = _outer(wrong, keys)
    with pytest.raises(AssertionError):
        _tiled_mm(_pad_rows(x, 4 * rn + 4), _pad_rows(x, 4 * kn).transpose(
            -1, -2), r, k, 9, 9)


@pytest.mark.parametrize("n,m,dh,aligned,tiled", [
    (32, 32, 32, True, True), (32, 2048, 32, True, True),
    (2048, 32, 32, True, True), (45, 3000, 48, True, True),
    (32, 32, 32, False, False), (40, 50, 10, True, False),
    (20, 300, 400, True, False)])
def test_tiled_rule(n, m, dh, aligned, tiled):
    rows = ops.cross_bwd_schedule(n, m, dh)
    assert (rows is not None and host_rules().ldt_cross_bwd_tiled(
        n, m, dh, rows, int(aligned)) == 1) == tiled


def test_tiled_sizes_and_rule_mirror_the_source():
    lib = host_rules()
    smem, tiled = lib.ldt_cross_bwd_tiled_smem_bytes, lib.ldt_cross_bwd_tiled
    # the layouts at the stage-1 shapes (dh = 32, rows of stride 36): the
    # long-query tile of 128 rows over 32 keys, k v q g rows and the
    # [128, 32] weights and ds, leaves room for two blocks a SM; the
    # long-key chunk over 32 queries (q g, a 64-key k v, [32, 64] weights
    # and ds, three scalars a row) for four
    assert smem(2048, 32, 32, 128) == 4 * (2 * 32 * 36 + 2 * 128 * 36
                                           + 2 * 128 * 32) <= \
        ops.SMEM_LIMIT // 2
    assert smem(32, 2048, 32, 0) == 4 * (2 * 32 * 36 + 2 * 64 * 36
                                         + 2 * 32 * 64 + 3 * 32) <= \
        ops.SMEM_LIMIT // 4
    # the rule flips where the shared memory passes a block's, either side:
    # (n, m, dh, rows) of 64-row long-query tiles as m grows, and of the
    # long-key schedule as n grows
    for at in (lambda x: (4096, x, 32, 64), lambda x: (x, 4096, 32, 0)):
        k = next(x for x in range(8, 4000)
                 if smem(*at(x)) > ops.SMEM_LIMIT)
        assert tiled(*at(k - 1), 1) == 1 and tiled(*at(k), 1) == 0
    # dh a multiple of 4, and aligned rows
    assert [tiled(32, 32, dh, 32, 1) for dh in (28, 30, 32, 33)] == [
        1, 0, 1, 0]
    assert tiled(32, 32, 32, 32, 0) == 0
    # the entry launches by that rule, on all four operands' alignment
    entry = re.search(r"cudaError_t launch_cross_bwd_any\(.*?\n}", SOURCE,
                      re.S).group(0)
    assert re.search(r"cross_bwd_tiled\(n, m, d / h, rows, aligned16\(q\) "
                     r"&&\s+aligned16\(k\) &&\s+aligned16\(v\) && "
                     r"aligned16\(g\)\)", entry)
