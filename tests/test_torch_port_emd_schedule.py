"""K6/K7's cluster schedule on the CPU: which schedule and cluster size a
tile takes (`ops._eval_kernels.emd_schedule`), the constants it mirrors
from `ldt_torch/csrc/eval.cu`, and the schedule's order of operations as a
plain-PyTorch emulation held against the plain twin and against the JAX
package's approx-match EMD (the Pallas kernel in interpret mode where it
takes the shape, else the XLA form `_approx_match_cost_single`).

The emulation follows `approx_match_cluster_kernel`: the rows of a pair in
16 slots (row i in slot i % 16), a slot being warp w of block r of a cluster
of c blocks of 16 / c warps (slot r (16 / c) + w); sweep A(0), then sweep
B(L) fused with A(L + 1) for L = 0..7, then B(8): per row, B's cost and
remain_l from ratio_r, then A's row sum from the next level's remain_r and
ratio_l from the remain_l just computed; each slot's column partial sums
and cost over its rows in row order; then a balanced tree over the block's
warps in warp order, and over the cluster's blocks in rank order; then the
column state (sumr, ratio_r, the next remain_r) from the sums. The same
tree for every c, so the emulation gives the same bits for every cluster
size, as the kernel does. Its sums run in another order than the twin's,
and K6's card limit (`chip_smoke.K6_TOL`) must hold it, while a fusion whose
A(L + 1) reads level L's remain_r must fail it.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K6_TOL, synthetic_shapes
from ldt_tpu.ops import emd as jemd
from ldt_tpu.ops.geometry import square_distance as jax_square_distance
from ldt_torch.ops import _build, _eval_kernels, emd
from ldt_torch.ops.geometry import square_distance

SOURCE = (_build.CSRC / "eval.cu").read_text()
SLOTS = _eval_kernels._EMD_SLOTS


def _tree(v: torch.Tensor) -> torch.Tensor:
    """Balanced pairwise sum over dim 1 (a power of two), adjacent first."""
    while v.shape[1] > 1:
        v = v[:, 0::2] + v[:, 1::2]
    return v[:, 0]


def _reduce(part: torch.Tensor, c: int) -> torch.Tensor:
    """[P, 16, ...] slot partials -> [P, ...]: each block's warps in warp
    order, then the blocks in rank order."""
    w = SLOTS // c
    blocks = torch.stack([_tree(part[:, r * w:(r + 1) * w])
                          for r in range(c)], dim=1)
    return _tree(blocks)


def cluster_emulation(d: torch.Tensor, c: int,
                      stale_remain_r: bool = False) -> torch.Tensor:
    """[P] costs of the squared distances d [P, N, M] (f32, >= 0) in the
    cluster schedule's order (see the module doc); `stale_remain_r` gives
    the wrong fusion, A(L + 1) reading level L's remain_r."""
    p, n, m = d.shape
    rows = -(-n // SLOTS)
    pad = torch.zeros(p, rows * SLOTS, m)
    pad[:, :n] = d
    dd = pad.view(p, rows, SLOTS, m)          # row k * 16 + s
    valid = (torch.arange(rows * SLOTS) < n).view(rows, SLOTS)
    dist = torch.sqrt(torch.clamp(dd, min=1e-20))
    remain_l = torch.full((p, rows, SLOTS), float(max(1, m // n)))
    ratio_l = torch.zeros(p, rows, SLOTS)
    remain_r = torch.full((p, m), float(max(1, n // m)))
    prev_remain_r = remain_r
    ratio_r = torch.zeros(p, m)
    levels = emd.LEVELS
    cost = torch.zeros(p)
    for r in range(len(levels) + 1):
        has_b, has_a = r > 0, r < len(levels)
        acc = torch.zeros(p, SLOTS, m)
        lc = torch.zeros(p, SLOTS)
        rr_a = prev_remain_r if stale_remain_r and has_b else remain_r
        for k in range(rows):
            ok = valid[k]
            rem = remain_l[:, k]
            rl_next = torch.zeros_like(rem)
            if has_b:
                w = torch.exp(levels[r - 1] * dd[:, k])
                c_row = ((w * dist[:, k]) * ratio_r[:, None]).sum(-1)
                wr = (w * ratio_r[:, None]).sum(-1)
                rl = ratio_l[:, k]
                lc = lc + torch.where(ok, rl * c_row, 0.0)
                rem = torch.clamp(rem - rl * wr, min=0.0)
            if has_a:
                w = torch.exp(levels[r] * dd[:, k])
                rl_next = rem / (1e-9 + (w * rr_a[:, None]).sum(-1))
                acc = acc + torch.where(ok[:, None], rl_next[..., None] * w,
                                        0.0)
            remain_l[:, k] = rem
            ratio_l[:, k] = rl_next
        cost = cost + _reduce(lc, c)
        if has_a:
            colsum = _reduce(acc, c)
            sumr = colsum * remain_r
            ratio_r = torch.clamp(remain_r / (sumr + 1e-9), max=1.0) \
                * remain_r
            prev_remain_r = remain_r
            remain_r = torch.clamp(remain_r - sumr, min=0.0)
    return cost


def _clouds(p, n, m, seed):
    """Unit-radius shapes; even pairs a shape and its jittered copy (when
    N == M)."""
    rng = np.random.default_rng(seed)
    x = synthetic_shapes(p, n, rng)
    y = synthetic_shapes(p, m, rng)
    if n == m:
        y[::2] = x[::2] + 0.01 * rng.standard_normal(x[::2].shape)
    return x, y


def _rel(got, want):
    rel = (np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
           / np.abs(np.asarray(want, np.float64)))
    return rel.max(), rel.mean()


def _within(r, tol=K6_TOL):
    return r[0] <= tol[0] and r[1] <= tol[1]


@pytest.mark.parametrize("n,m", [(64, 64), (96, 40), (40, 130)],
                         ids=["square", "multi_r_2", "multi_l_3"])
def test_emulation_matches_the_twin_and_jax(n, m):
    x, y = _clouds(4, n, m, seed=n + m)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    d = torch.clamp(square_distance(xt, yt), min=0.0)
    got = {c: cluster_emulation(d, c) for c in (1, 2, 4)}
    assert torch.equal(got[1], got[2]) and torch.equal(got[1], got[4])
    # the port's own path: the twin on the port's distances
    r = _rel(got[2], emd.approx_match_cost_plain(xt, yt))
    assert _within(r), r
    # the algorithm on JAX's distances, against JAX's XLA form
    jd = np.array(jnp.maximum(jax_square_distance(jnp.asarray(x),
                                                  jnp.asarray(y)), 0.0))
    want = np.asarray(jax.vmap(jemd._approx_match_cost_single)(
        jnp.asarray(x), jnp.asarray(y)))
    r = _rel(cluster_emulation(torch.from_numpy(jd), 2), want)
    assert _within(r), r


def test_emulation_matches_the_pallas_kernel(monkeypatch):
    """Where the Pallas kernel takes the shape (N == M, a multiple of its
    256-row tile), in interpret mode, on its own distances."""
    monkeypatch.setattr(jemd, "_EMD_OTF", False)
    n = jemd._EMD_TILE * 2
    x, y = _clouds(2, n, n, seed=5)
    want = np.asarray(jemd._approx_match_cost_pallas(
        jnp.asarray(x), jnp.asarray(y), interpret=True))
    jd = np.array(jnp.maximum(jax_square_distance(jnp.asarray(x),
                                                  jnp.asarray(y)), 0.0))
    r = _rel(cluster_emulation(torch.from_numpy(jd), 2), want)
    assert _within(r), r


def test_a_fusion_with_the_stale_remain_r_fails_the_limit():
    x, y = _clouds(4, 64, 64, seed=7)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    d = torch.clamp(square_distance(xt, yt), min=0.0)
    twin = emd.approx_match_cost_plain(xt, yt)
    assert _within(_rel(cluster_emulation(d, 2), twin))
    wrong = _rel(cluster_emulation(d, 2, stale_remain_r=True), twin)
    assert not _within(wrong), wrong


@pytest.mark.parametrize("p,sms,c", [
    (1, 132, 8), (16, 132, 8), (17, 132, 4), (32, 132, 4), (33, 132, 4),
    (34, 132, 2), (64, 132, 2), (130, 132, 2), (4096, 132, 2),
    # a card of 114 SMs (the H100 PCIe): the rule follows the count
    (14, 114, 8), (15, 114, 4), (28, 114, 4), (29, 114, 2), (64, 114, 2)])
def test_cluster_size_rule(p, sms, c):
    assert _eval_kernels.emd_cluster(p, sms) == c
    # at most 8 warps a block (the kernel's launch bound), on at most the
    # card's SMs where the tile is small enough
    assert SLOTS // c <= 8 and (p * c <= sms or c == 2)


@pytest.mark.parametrize("p,n,m,otf,schedule", [
    (64, 2048, 2048, False, "cluster"), (64, 2048, 2048, True, "cluster"),
    (3, 700, 300, True, "cluster"), (64, 6000, 2048, False, "cluster"),
    (64, 6000, 2048, True, "block"), (2, 1500, 2049, False, "block"),
    (2, 8000, 8000, False, "block")])
def test_schedule_rule(p, n, m, otf, schedule):
    assert _eval_kernels.emd_schedule(p, n, m, otf, 132)[0] == schedule


def _constants():
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}


def test_constants_mirror_the_source():
    c = _constants()
    assert (c["kEmdSlots"], c["kEmdMaxGroups"]) == (
        _eval_kernels._EMD_SLOTS, _eval_kernels._EMD_MAX_GROUPS)
    # the cluster rule takes the SM count from the card, not a constant
    assert "cudaDevAttrMultiProcessorCount" in SOURCE
    assert c["kEmdThreads"] // 32 == _eval_kernels._EMD_WARPS
    assert re.search(r"__launch_bounds__\(kEmdSlots / 2 \* 32\)", SOURCE)
    body = re.search(r"size_t emd_cluster_smem_bytes\(.*?\n}", SOURCE,
                     re.S).group(0)
    base = re.search(r"size_t f = (.+?);", body).group(1)
    extra = re.search(r"if \(otf\) f \+= (.+?);", body).group(1)
    for n, m, otf, cl in [(2048, 2048, False, 2), (2048, 2048, True, 2),
                          (700, 300, True, 8), (130, 67, False, 4)]:
        env = dict(n4=-(-n // 4) * 4, mp=128 * _eval_kernels.emd_groups(m),
                   kEmdSlots=SLOTS, c=cl)
        want = eval(base.replace("/", "//"), {}, env) + (
            eval(extra, {}, env) if otf else 0)
        assert 4 * want == _eval_kernels.emd_cluster_smem_bytes(n, m, otf,
                                                                cl)
    # the eval's tile fits, K7 beside K6
    assert _eval_kernels.emd_cluster_smem_bytes(2048, 2048, True, 2) \
        <= _eval_kernels.SMEM_LIMIT
