"""K5's split schedule on the CPU: which schedule and cluster size a tile
takes (`ldt_cd_schedule`, the rule in `ldt_torch/csrc/rules.h` that the
library launches by, built here by the host compiler), the constants the
emulation reads from the sources, and the schedule's arithmetic as a
plain-PyTorch emulation held against the plain twin and against the JAX
package's Pallas kernel in interpret mode.

The emulation follows `pairwise_cd_split_kernel`: a pair's rows split over
a cluster of c blocks of rb = ceil(N / c) rows; in a block, `threads`
threads hold 4 rows each per pass (thread t's rows base + i threads + t),
a row past the block's last repeating that row; each d_ij in the direct
form (`square_distance`, the kernel's roundings); the rows' minima and each
block's column minima, merged over the cluster by a minimum; then each set
summed over 256 slots (slot s adds the values s, s + 256, ... in index
order) and the slots in a balanced tree (slot s + w into slot s, w = 128,
..., 1); the chamfer means rows / N + cols / M. Its minima must be the
twin's bits, its result the same bits for every cluster size, and within
K5's card limit (`chip_smoke.K5_TOL`) of the twin and the Pallas kernel,
while a merge that drops one block's column minima must fail the limit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K5_TOL, SEED, synthetic_shapes
from ldt_tpu.ops import chamfer as jchamfer
from ldt_torch.ops import _build, _eval_kernels, chamfer
from ldt_torch.ops.geometry import square_distance
from test_torch_port_csrc_syntax import host_rules

SOURCE = (_build.CSRC / "eval.cu").read_text()
CONSTANTS = {name: int(val) for name, val in re.findall(
    r"constexpr int (k\w+) = (\d+);",
    SOURCE + (_build.CSRC / "rules.h").read_text())}
SLOTS = CONSTANTS["kCdSumSlots"]
ROWS = CONSTANTS["kCdRows"]  # rows a thread holds


def split_threads(rb: int) -> int:
    """`cd_split_threads`: threads of a split block with rb rows, ROWS a
    thread, in whole warps, at most kCdSplitThreads."""
    warps = -(-rb // (32 * ROWS))
    return 32 * max(1, min(CONSTANTS["kCdSplitThreads"] // 32, warps))


def _slot_sum(v: torch.Tensor) -> torch.Tensor:
    """[P, K] f32 -> [P]: the kernel's 256 slots, then its slot tree."""
    p, k = v.shape
    slots = torch.zeros(p, SLOTS)
    for i in range(k):  # slot i % 256 adds v[:, i] in index order
        slots[:, i % SLOTS] = slots[:, i % SLOTS] + v[:, i]
    w = SLOTS // 2
    while w:
        slots = slots[:, :w] + slots[:, w:2 * w]
        w //= 2
    return slots[:, 0]


def split_emulation(x: torch.Tensor, y: torch.Tensor, c: int,
                    drop_block=None):
    """(chamfer means [P], row minima [P, N], column minima [P, M]) of the
    split schedule with cluster size c; `drop_block` leaves that block's
    column minima out of the merge (the wrong variant)."""
    p, n, _ = x.shape
    m = y.shape[1]
    d = square_distance(x.float(), y.float())            # [P, N, M]
    rb = -(-n // c)
    per_pass = split_threads(rb) * ROWS
    rowmin = torch.full((p, n), float("nan"))
    colmin = torch.full((p, m), torch.finfo(torch.float32).max)
    for rank in range(c):
        r0, r1 = min(n, rank * rb), min(n, rank * rb + rb)
        if r0 == r1:
            continue
        block_cols = torch.full((p, m), torch.finfo(torch.float32).max)
        for base in range(r0, r1, per_pass):
            rows = torch.arange(base, base + per_pass).clamp(max=r1 - 1)
            dd = d[:, rows]                              # duplicates too
            block_cols = torch.minimum(block_cols, dd.amin(dim=1))
            real = torch.arange(base, min(base + per_pass, r1))
            rowmin[:, real] = d[:, real].amin(dim=2)
        if rank != drop_block:
            colmin = torch.minimum(colmin, block_cols)
    out = _slot_sum(rowmin) / n + _slot_sum(colmin) / m
    return out, rowmin, colmin


def _clouds(p, n, m, seed):
    """Unit-radius shapes; even pairs a shape and its jittered copy (the
    first min(n, m) points)."""
    rng = np.random.default_rng(seed)
    x = synthetic_shapes(p, n, rng)
    y = synthetic_shapes(p, m, rng)
    k = min(n, m)
    y[::2, :k] = x[::2, :k] + 0.01 * rng.standard_normal(x[::2, :k].shape)
    return torch.from_numpy(x), torch.from_numpy(y)


def _rel(got, want):
    rel = ((got.double() - want.double()).abs() / want.double().abs())
    return rel.max().item(), rel.mean().item()


def _within(r, tol=K5_TOL):
    return r[0] <= tol[0] and r[1] <= tol[1]


# (p, n, m): a tile whose rows no split divides and M != N, one pair, fewer
# rows than blocks, more rows than a block's threads take in one pass
SHAPES = [(4, 700, 332), (1, 256, 256), (3, 5, 12), (2, 1100, 64)]


@pytest.mark.parametrize("p,n,m", SHAPES)
def test_emulation_matches_the_twin_in_every_cluster_size(p, n, m):
    x, y = _clouds(p, n, m, seed=n + m)
    d1, d2, _, _ = chamfer.chamfer_distance(x, y)
    twin = chamfer.pairwise_cd_means_plain(x, y)
    outs = {}
    for c in (2, 4, 8):
        out, rowmin, colmin = split_emulation(x, y, c)
        # the minima are the twin's bits (the same direct-form roundings)
        assert torch.equal(rowmin, d1) and torch.equal(colmin, d2)
        r = _rel(out, twin)
        assert _within(r), r
        outs[c] = out
    # the sums' order depends on N and M alone
    assert torch.equal(outs[2], outs[4]) and torch.equal(outs[2], outs[8])


def test_emulation_matches_the_pallas_kernel():
    """Where the Pallas kernel takes the shape (N a multiple of its
    256-row tile), in interpret mode, M != N."""
    x, y = _clouds(3, 512, 300, seed=3)
    want = torch.from_numpy(np.array(jchamfer.pairwise_cd_means_pallas(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), interpret=True)))
    out = split_emulation(x, y, 2)[0]
    r = _rel(out, want)
    assert _within(r), r


def test_a_merge_that_drops_one_block_fails_the_limit():
    x, y = _clouds(4, 512, 512, seed=9)
    twin = chamfer.pairwise_cd_means_plain(x, y)
    assert _within(_rel(split_emulation(x, y, 4)[0], twin))
    wrong = _rel(split_emulation(x, y, 4, drop_block=1)[0], twin)
    assert not _within(wrong), wrong


def _fma(a, b, c):
    """f32 fmaf(a, b, c) of f32 tensors: the f64 product (exact for f32
    operands) plus c, rounded to f64 and then to f32."""
    return (a.double() * b.double() + c.double()).float()


def _means_of(d: torch.Tensor) -> torch.Tensor:
    """[N, M] squared distances -> mean row minimum + mean column minimum."""
    return d.amin(1).mean() + d.amin(0).mean()


def test_the_bound_s_fused_form_holds_the_limit_and_the_expanded_does_not():
    """chip_smoke.py's K5 bound counts 8 instructions an element: the direct
    form with its two adds fused (three differences, a square, two FMAs)
    and the two minima. On eight pairs of the eval's 2048-point clouds that
    form keeps K5_TOL of the twin, each d within 2 ulps of the rounded
    form; the expanded form |x|^2 - 2 x.y + |y|^2 (an add, three FMAs)
    misses it, so the bound counts no fewer."""
    x, y = _clouds(8, 2048, 2048, seed=SEED)
    twin = chamfer.pairwise_cd_means_plain(x, y)
    fused, expanded = [], []
    for xp, yp in zip(x.float(), y.float()):
        diff = xp[:, None] - yp[None]
        d = _fma(diff[..., 2], diff[..., 2], _fma(
            diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0]))
        rounded = square_distance(xp[None], yp[None])[0]
        ulps = (d.view(torch.int32) - rounded.view(torch.int32)).abs()
        assert ulps.max().item() <= 2
        fused.append(_means_of(d))
        e = (xp * xp).sum(-1)[:, None] + (yp * yp).sum(-1)[None]
        for c in (2, 1, 0):
            e = _fma(-2 * xp[:, None, c], yp[None, :, c], e)
        expanded.append(_means_of(e.clamp(min=0)))
    assert _within(_rel(torch.stack(fused), twin))
    r = _rel(torch.stack(expanded), twin)
    assert not _within(r), r


@pytest.mark.parametrize("p,sms,c", [
    (1, 132, 8), (16, 132, 8), (17, 132, 4), (32, 132, 4), (33, 132, 4),
    (64, 132, 2), (66, 132, 2), (67, 132, 8), (95, 132, 4), (132, 132, 2),
    (192, 132, 2), (4096, 132, 8),
    # a card of 114 SMs (the H100 PCIe): the rule follows the count
    (14, 114, 8), (28, 114, 4), (57, 114, 2), (64, 114, 8)])
def test_cluster_size_rule(p, sms, c):
    assert host_rules().ldt_cd_schedule(p, 2048, 2048, 1, sms) == c
    # no other of 2, 4, 8 puts fewer rows on the busiest SM
    load = {k: -(-p * k // sms) / k for k in (2, 4, 8)}
    assert load[c] == min(load.values())


@pytest.mark.parametrize("p,n,m,aligned,schedule", [
    (64, 2048, 2048, True, "split"), (1, 2048, 2048, True, "split"),
    (3, 1000, 332, True, "split"), (64, 2048, 2048, False, "block"),
    (3, 1000, 333, True, "block"), (2, 100, 4000, True, "block"),
    (2, 2049, 64, True, "block")])
def test_schedule_rule(p, n, m, aligned, schedule):
    c = host_rules().ldt_cd_schedule(p, n, m, int(aligned), 132)
    assert ("split" if c else "block") == schedule


def test_constants_and_rules_mirror_the_source():
    # the split rule's limits, either side of each
    rule = host_rules().ldt_cd_schedule
    top = CONSTANTS["kCdSplitMaxPoints"]
    assert rule(5, top, top, 1, 132) and rule(5, top - 3, top - 4, 1, 132)
    for n, m, aligned in [(top + 1, 64, 1), (64, top + 4, 1),
                          (64, top - 2, 1), (64, 64, 0)]:
        assert rule(5, n, m, aligned, 132) == 0
    assert {rule(p, 64, 64, 1, 132) for p in range(1, 300)} == {
        c for c in (2, 4, 8) if c <= CONSTANTS["kCdMaxCluster"]}
    # the entry launches by that rule, on the card's SM count
    entry = re.search(r"int ldt_pairwise_cd_means\(.*?\n}", SOURCE,
                      re.S).group(0)
    assert "cd_split(n, m, aligned16(y))" in entry
    assert "cudaDevAttrMultiProcessorCount" in entry
    assert "*cluster = cd_cluster(p, sms)" in entry
    # threads: ROWS rows each, whole warps, at most 256, as the source has it
    body = re.search(r"int cd_split_threads\(.*?\n}", SOURCE, re.S).group(0)
    assert "(rb + 32 * kCdRows - 1) / (32 * kCdRows)" in body
    assert [split_threads(rb) for rb in (1, 128, 129, 1024, 2048)] == [
        32, 32, 64, 256, 256]
    # n <= 2048 with c >= 2 leaves every block one pass (the kernel has no
    # other), and the widest tile's shared memory, as the source states it,
    # fits a block
    assert -(-CONSTANTS["kCdSplitMaxPoints"] // 2) <= ROWS * split_threads(
        1024)
    body = re.search(r"size_t cd_split_smem_bytes\(.*?\n}", SOURCE,
                     re.S).group(0)
    expr = re.search(r"sizeof\(float\) \* \((.+?)\);", body, re.S).group(1)
    expr = re.sub(r"\(size_t\)", "", " ".join(expr.split()))
    for c in (2, 4, 8):
        rb = -(-2048 // c)
        smem = 4 * eval(expr.replace("/", "//"), {}, dict(
            m=2048, rb=rb, cd_split_threads=split_threads,
            kCdSumSlots=SLOTS))
        assert smem <= _eval_kernels.SMEM_LIMIT
