"""Generative point-cloud metrics: MMD / COV / 1-NNA over CD and EMD, and
the JSD, counterpart of `ldt_tpu/eval/metrics.py` (the same names, numpy
results and dict keys).

The pair matrices are built tile by tile: each (sample block x ref block)
tile flattens its S * R pairs into one batch for K5 (`ops.chamfer.
pairwise_cd_means`) and K6/K7 (`ops.emd.approx_match_cost`), so a pair's
value does not depend on the tile it lies in. `emd_otf` is
`approx_match_cost`'s `otf`, the JAX package's `LDT_EMD_PALLAS_OTF`, but
with another default: None, the port's rule, takes K7 (d built inside the
kernel) on a card wherever its shared memory fits, the eval's 2048-point
clouds included, and K6 behind a [P, N, M] d build only past that (the
JAX package takes K6 unless asked); True or False forces K7 or K6, which
give the same bits. The tiles keep the JAX package's `_PAIR_TILE_BYTES`
budget, sized for K6's d, 16.8 MB a pair at 2048 points. The last tile
of a row or column is ragged (the JAX package pads it to one shape to avoid
TPU recompiles; nothing here recompiles).

Under a registered mesh (`set_eval_mesh`, the trainers' mesh) a tile's
flattened pair axis is split over every rank, as the JAX package's: pairs
are independent, so even a model axis serves as data parallelism here.
Each rank runs K5 and K6/K7 on its pairs and one all_gather per matrix
joins them (where the world does not divide the tile's pairs, every rank
computes the whole tile, as the JAX package then replicates). The JAX
package takes XLA's chamfer under a mesh; the port keeps K5: the same
function, rounded otherwise (the CPU tests hold rtol 1e-4, atol 1e-5).

Every entry point takes `device` ("cuda" unless the CPU is asked for; it
raises without a card), and clouds as numpy arrays or tensors.

Spans (`tools.profiling`): `compute_all_metrics` is one `eval.call`; each
tile of `pairwise_EMD_CD` an `eval.tile`, holding the copy of its two
matrices to the host, `eval.copy`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ldt_torch import resolve_device
from ldt_torch.ops.attention import true_divide
from ldt_torch.ops.chamfer import pairwise_cd_means
from ldt_torch.ops.emd import approx_match_cost
from ldt_torch.ops.geometry import square_distance
from ldt_torch.parallel import comm
from ldt_torch.tools import profiling

# The mesh the pair tiles shard over; the trainers register theirs
# (`training.base.BaseTrainer`). None: every pair on this process.
_EVAL_MESH = None


def set_eval_mesh(mesh) -> None:
    """Register (or clear, with None) the mesh eval pair tiles shard over."""
    global _EVAL_MESH
    _EVAL_MESH = mesh

# ---------------------------------------------------------------------------
# Pairwise distance matrices
# ---------------------------------------------------------------------------


def _clouds(pcs, dev: torch.device) -> torch.Tensor:
    """Clouds [K, N, 3] as float32 on `dev`."""
    if isinstance(pcs, torch.Tensor):
        return pcs.detach().to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(pcs, np.float32), device=dev)


def _pair_block(sample_block: torch.Tensor, ref_block: torch.Tensor,
                with_emd: bool = False, emd_otf: Optional[bool] = None):
    """All-pairs CD (and EMD) of two blocks of clouds [S, N, 3], [R, M, 3]:
    cd [S, R] (= mean_n dl + mean_m dr, squared distances) and emd [S, R]
    (approx-match cost / M) when asked."""
    s, r = sample_block.shape[0], ref_block.shape[0]
    xs = sample_block.repeat_interleave(r, dim=0)     # [S*R, N, 3]
    ys = ref_block.repeat(s, 1, 1)                    # [S*R, M, 3]
    world = comm.world_size() if _EVAL_MESH is not None else 1
    split = world > 1 and (s * r) % world == 0
    if split:  # this rank's pairs; the matrices joined by all_gather
        xs, ys = comm.local_slice(xs, None, 0), comm.local_slice(ys, None, 0)

    def joined(v):
        return (comm.all_gather(v, None, 0) if split else v).reshape(s, r)

    cd = joined(pairwise_cd_means(xs, ys))
    if not with_emd:
        return cd
    cost = approx_match_cost(xs, ys, otf=emd_otf)
    return cd, joined(true_divide(cost, float(ref_block.shape[1])))


def _iter_blocks(total: int, block: int):
    for start in range(0, total, block):
        yield start, min(total, start + block)


# Device-memory budget for one pair tile's [P, N, M] distances (the JAX
# package's: an uncapped 256-pair tile of 2048-point clouds wants > 8 GB).
_PAIR_TILE_BYTES = int(1.6e9)


def _tile_shape(ns: int, nr: int, batch_size: int, block: Optional[int],
                n_pts: int, m_pts: int, symmetric: bool = False):
    """(sample-block, ref-block) sizes: ~4 * batch_size pairs per tile,
    capped so P * N * M * 4 bytes stays under `_PAIR_TILE_BYTES`.
    `symmetric` tiles are square (a skipped strictly-lower tile is then
    exactly the transpose of a computed upper one), with a side that holds
    the same ~min(4 * batch_size, budget) pairs."""
    budget = max(1, _PAIR_TILE_BYTES // max(n_pts * m_pts * 4, 1))
    if symmetric:
        side = max(1, math.isqrt(min(4 * batch_size, budget)))
        if block is not None:
            side = min(side, max(1, block))
        side = min(side, max(ns, 1))
        return side, side
    rb = min(batch_size, nr, budget)
    if block is not None:
        sb = min(block, ns, max(1, budget // rb))
    else:
        sb = max(1, min(4 * batch_size, budget) // rb)
        sb = min(sb, ns)
    return sb, rb


def pairwise_CD(sample_pcs, ref_pcs, batch_size: int = 32,
                block: Optional[int] = None, symmetric: bool = False, *,
                device="cuda") -> np.ndarray:
    """Full [N_sample, N_ref] chamfer matrix. `batch_size` bounds the ref
    block, `block` the sample block. `symmetric=True` (only when both
    arguments are the same object: a self-distance matrix) computes the
    upper-triangle tiles and mirrors them (chamfer is symmetric in its
    arguments)."""
    if symmetric and sample_pcs is not ref_pcs:
        # the mirror holds only for a set against itself: two distinct sets
        # of equal length would get CD(ref_i, smp_j) where CD(smp_i, ref_j)
        # belongs
        raise ValueError("symmetric=True requires passing the SAME array "
                         "for sample_pcs and ref_pcs (a self-distance "
                         "matrix); got two distinct objects")
    dev = resolve_device(device)
    sample = _clouds(sample_pcs, dev)
    ref = sample if symmetric else _clouds(ref_pcs, dev)
    ns, nr = sample.shape[0], ref.shape[0]
    sb, rb = _tile_shape(ns, nr, batch_size, block, sample.shape[1],
                         ref.shape[1], symmetric=symmetric)
    out = np.zeros((ns, nr), np.float32)
    for s0, s1 in _iter_blocks(ns, sb):
        for r0, r1 in _iter_blocks(nr, rb):
            if symmetric and r1 <= s0:
                continue  # strictly lower: filled by the final mirror
            out[s0:s1, r0:r1] = _pair_block(sample[s0:s1],
                                            ref[r0:r1]).cpu().numpy()
    if symmetric:
        low = np.tril_indices(ns, -1)
        out[low] = out.T[low]
    return out


def pairwise_EMD_CD(sample_pcs, ref_pcs, batch_size: int = 32,
                    block: Optional[int] = None, *,
                    emd_otf: Optional[bool] = None,
                    device="cuda"):
    """[N_sample, N_ref] CD and EMD matrices."""
    dev = resolve_device(device)
    sample, ref = _clouds(sample_pcs, dev), _clouds(ref_pcs, dev)
    ns, nr = sample.shape[0], ref.shape[0]
    sb, rb = _tile_shape(ns, nr, batch_size, block, sample.shape[1],
                         ref.shape[1])
    cd = np.zeros((ns, nr), np.float32)
    emd = np.zeros((ns, nr), np.float32)
    for s0, s1 in _iter_blocks(ns, sb):
        for r0, r1 in _iter_blocks(nr, rb):
            with profiling.span("eval.tile"):
                c, e = _pair_block(sample[s0:s1], ref[r0:r1], with_emd=True,
                                   emd_otf=emd_otf)
                with profiling.span("eval.copy"):
                    cd[s0:s1, r0:r1] = c.cpu().numpy()
                    emd[s0:s1, r0:r1] = e.cpu().numpy()
    return cd, emd


# ---------------------------------------------------------------------------
# Metrics from distance matrices (numpy, as the JAX package)
# ---------------------------------------------------------------------------


def lgan_mmd_cov(all_dist: np.ndarray) -> Dict[str, float]:
    """MMD / COV / MMD_smp from a [N_sample, N_ref] matrix."""
    all_dist = np.asarray(all_dist)
    n_ref = all_dist.shape[1]
    min_val_fromsmp = all_dist.min(axis=1)
    min_idx = all_dist.argmin(axis=1)
    min_val = all_dist.min(axis=0)
    return {
        "mmd": float(min_val.mean()),
        "cov": float(np.unique(min_idx).size) / float(n_ref),
        "mmd_smp": float(min_val_fromsmp.mean()),
    }


def knn(mxx: np.ndarray, mxy: np.ndarray, myy: np.ndarray, k: int,
        sqrt: bool = False) -> Dict[str, float]:
    """1-NN two-sample classifier test. mxx: ref x ref; mxy: ref x sample;
    myy: sample x sample. tp/fp/fn/tn, precision/recall, acc, acc_t and
    acc_f."""
    mxx, mxy, myy = (np.asarray(m, np.float64) for m in (mxx, mxy, myy))
    n0, n1 = mxx.shape[0], myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    mat = np.block([[mxx, mxy], [mxy.T, myy]])
    if sqrt:
        mat = np.sqrt(np.abs(mat))
    np.fill_diagonal(mat, np.inf)
    idx = np.argpartition(mat, k - 1, axis=0)[:k]
    count = label[idx].sum(axis=0)
    pred = (count >= (float(k) / 2)).astype(np.float64)

    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {
        "tp": tp, "fp": fp, "fn": fn, "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": float((pred == label).mean()),
    }


# ---------------------------------------------------------------------------
# Public entry points (reference contract)
# ---------------------------------------------------------------------------


def EMD_CD(sample_pcs, ref_pcs, batch_size: int, reduced: bool = True, *,
           emd_otf: Optional[bool] = None, device="cuda",
           **_ignored) -> Dict[str, float]:
    """Paired (same-index) CD and EMD, keys 'mmd-CD' and 'mmd-EMD'."""
    dev = resolve_device(device)
    sample, ref = _clouds(sample_pcs, dev), _clouds(ref_pcs, dev)
    ns = sample.shape[0]
    assert ns == ref.shape[0], f"REF:{ref.shape[0]} SMP:{ns}"
    budget = max(1, _PAIR_TILE_BYTES // max(
        sample.shape[1] * ref.shape[1] * 4, 1))
    bs = min(batch_size, ns, budget)
    cd_lst, emd_lst = [], []
    for b0, b1 in _iter_blocks(ns, bs):
        xs, ys = sample[b0:b1], ref[b0:b1]
        cd_lst.append(pairwise_cd_means(xs, ys).cpu().numpy())
        emd_lst.append(true_divide(approx_match_cost(xs, ys, otf=emd_otf),
                                   float(ref.shape[1])).cpu().numpy())
    cd = np.concatenate(cd_lst)
    emd = np.concatenate(emd_lst)
    if reduced:
        return {"mmd-CD": float(cd.mean()), "mmd-EMD": float(emd.mean())}
    return {"mmd-CD": cd, "mmd-EMD": emd}


def compute_all_metrics(sample_pcs, ref_pcs, batch_size: int,
                        verbose: bool = True, *,
                        emd_otf: Optional[bool] = None,
                        device="cuda", **_ignored) -> Dict[str, float]:
    """MMD/COV/1-NNA over CD and EMD. The ref-vs-sample matrices are taken
    as `pairwise_EMD_CD(ref, sample)` and transposed, as the JAX package
    does: the approx-match is not symmetric in its arguments."""
    with profiling.span("eval.call"):
        kw = dict(emd_otf=emd_otf, device=device)
        results: Dict[str, float] = {}
        m_rs_cd, m_rs_emd = pairwise_EMD_CD(ref_pcs, sample_pcs, batch_size,
                                            **kw)
        results.update({f"{k}-CD": v
                        for k, v in lgan_mmd_cov(m_rs_cd.T).items()})
        results.update({f"{k}-EMD": v
                        for k, v in lgan_mmd_cov(m_rs_emd.T).items()})
        if verbose:
            for k, v in results.items():
                print(f"[{k}] {v:.8f}")
        m_rr_cd, m_rr_emd = pairwise_EMD_CD(ref_pcs, ref_pcs, batch_size,
                                            **kw)
        m_ss_cd, m_ss_emd = pairwise_EMD_CD(sample_pcs, sample_pcs,
                                            batch_size, **kw)
        one_nn_cd = knn(m_rr_cd, m_rs_cd, m_ss_cd, 1, sqrt=False)
        results.update({f"1-NN-CD-{k}": v for k, v in one_nn_cd.items()
                        if "acc" in k})
        one_nn_emd = knn(m_rr_emd, m_rs_emd, m_ss_emd, 1, sqrt=False)
        results.update({f"1-NN-EMD-{k}": v for k, v in one_nn_emd.items()
                        if "acc" in k})
        return results


def compute_MMD_metrics(sample_pcs, ref_pcs, batch_size: int,
                        verbose: bool = True, *, device="cuda",
                        emd_otf: Optional[bool] = None,
                        **_ignored) -> Dict[str, float]:
    """MMD/COV only. `emd_otf` as in `compute_all_metrics`."""
    results: Dict[str, float] = {}
    m_rs_cd, m_rs_emd = pairwise_EMD_CD(ref_pcs, sample_pcs, batch_size,
                                        device=device, emd_otf=emd_otf)
    results.update({f"{k}-CD": v for k, v in lgan_mmd_cov(m_rs_cd.T).items()})
    results.update({f"{k}-EMD": v
                    for k, v in lgan_mmd_cov(m_rs_emd.T).items()})
    if verbose:
        for k, v in results.items():
            print(f"[{k}] {v:.8f}")
    return results


def compute_CD_metrics(sample_pcs, ref_pcs, batch_size: int,
                       verbose: bool = True, *,
                       device="cuda") -> Dict[str, float]:
    """CD-only MMD/COV and 1-NNA, the self matrices from symmetric
    tiles."""
    results: Dict[str, float] = {}
    m_rs_cd = pairwise_CD(ref_pcs, sample_pcs, batch_size, device=device)
    results.update({f"{k}-CD": v for k, v in lgan_mmd_cov(m_rs_cd.T).items()})
    if verbose:
        for k, v in results.items():
            print(f"[{k}] {v:.8f}")
    m_rr_cd = pairwise_CD(ref_pcs, ref_pcs, batch_size, symmetric=True,
                          device=device)
    m_ss_cd = pairwise_CD(sample_pcs, sample_pcs, batch_size,
                          symmetric=True, device=device)
    one_nn_cd = knn(m_rr_cd, m_rs_cd, m_ss_cd, 1, sqrt=False)
    results.update({f"1-NN-CD-{k}": v for k, v in one_nn_cd.items()
                    if "acc" in k})
    return results


# ---------------------------------------------------------------------------
# JSD
# ---------------------------------------------------------------------------


def unit_cube_grid_point_cloud(resolution: int, clip_sphere: bool = False):
    """Cell centers of a resolution^3 grid in the unit cube."""
    spacing = 1.0 / float(resolution - 1)
    coords = np.arange(resolution, dtype=np.float32) * spacing - 0.5
    grid = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"),
                    axis=-1).astype(np.float32)
    if clip_sphere:
        grid = grid.reshape(-1, 3)
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


# Points x grid cells per distance tile of `_occupancy_counts` (256 MB of
# f32 per temporary).
_OCCUPANCY_TILE = 1 << 26


@torch.no_grad()
def _occupancy_counts(pclouds: torch.Tensor,
                      grid: torch.Tensor) -> torch.Tensor:
    """Per-cloud counts [B, n_cells] (float32) of the points' nearest grid
    cells. The squared distances are the direct form sum_c (p_c - g_c)^2
    (`ops.geometry.square_distance`: the same bits on every device, and the
    reference's numpy loop's), taken over tiles of cells with a running
    minimum; the first cell wins a tie (strict <, tiles in order), as
    numpy's argmin."""
    b, n, _ = pclouds.shape
    pts = pclouds.reshape(1, b * n, 3)
    n_cells = grid.shape[0]
    tile = max(1, min(n_cells, _OCCUPANCY_TILE // max(b * n, 1)))
    best_d = torch.full((b * n,), float("inf"), device=pts.device)
    best_i = torch.zeros((b * n,), dtype=torch.long, device=pts.device)
    for g0 in range(0, n_cells, tile):
        d = square_distance(pts, grid[None, g0:g0 + tile])[0]
        i = torch.argmin(d, dim=1)
        dmin = torch.gather(d, 1, i[:, None])[:, 0]
        upd = dmin < best_d
        best_d = torch.where(upd, dmin, best_d)
        best_i = torch.where(upd, i + g0, best_i)
    counts = torch.zeros((b, n_cells), device=pts.device)
    return counts.scatter_add_(1, best_i.reshape(b, n),
                               torch.ones((b, n), device=pts.device))


def entropy_of_occupancy_grid(pclouds, grid_resolution: int,
                              in_sphere: bool = False, *, device="cuda"):
    """(occupancy-grid entropy, per-cell point counts [n_cells]); the
    nearest-cell assignment runs on `device` in chunks of 32 clouds."""
    dev = resolve_device(device)
    pclouds = np.asarray(pclouds, np.float32)
    grid, _ = unit_cube_grid_point_cloud(grid_resolution, in_sphere)
    grid = torch.as_tensor(np.asarray(grid.reshape(-1, 3), np.float32),
                           device=dev)
    n_cells = grid.shape[0]
    grid_counters = np.zeros(n_cells)
    grid_bernoulli = np.zeros(n_cells)
    chunk = 32
    for s in range(0, len(pclouds), chunk):
        counts = _occupancy_counts(_clouds(pclouds[s:s + chunk], dev),
                                   grid).cpu().numpy()
        grid_counters += counts.sum(axis=0)
        grid_bernoulli += (counts > 0).sum(axis=0)

    def bernoulli_entropy(p):
        q = 1.0 - p
        out = 0.0
        if 0 < p < 1:
            out = -(p * np.log(p) + q * np.log(q))
        return out

    n = float(len(pclouds))
    acc_entropy = sum(bernoulli_entropy(g / n) for g in grid_bernoulli
                      if g > 0)
    return acc_entropy / len(grid_counters), grid_counters


def _entropy_bits(p):
    p = np.asarray(p, np.float64)
    p = p / p.sum()
    nz = p > 0
    return float(-(p[nz] * np.log2(p[nz])).sum())


def jensen_shannon_divergence(p, q) -> float:
    """JSD in bits."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    if (p < 0).any() or (q < 0).any():
        raise ValueError("Negative values.")
    if len(p) != len(q):
        raise ValueError("Non equal size.")
    p_ = p / p.sum()
    q_ = q / q.sum()
    return _entropy_bits((p_ + q_) / 2.0) - 0.5 * (
        _entropy_bits(p_) + _entropy_bits(q_))


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, resolution: int = 28,
                                 *, device="cuda") -> float:
    """Set-level JSD over occupancy grids."""
    sample_var = entropy_of_occupancy_grid(sample_pcs, resolution, True,
                                           device=device)[1]
    ref_var = entropy_of_occupancy_grid(ref_pcs, resolution, True,
                                        device=device)[1]
    return jensen_shannon_divergence(sample_var, ref_var)
