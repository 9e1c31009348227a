"""Plain reference of the point-cloud evaluation, frozen here; imports
nothing of the program under test.

- chamfer(x, y): mean_n min_m |x_n - y_m|^2 + mean_m min_n |x_n - y_m|^2;
- approx_match_cost(x, y): the annealed approximate matching of PointFlow's
  EMD (`approxmatch`): for levels L = -4^7, -4^6, ..., -4^-1,
  w = exp(L d) over the squared distances d, each row's remaining mass
  spread over the columns in proportion to w, each column's intake capped
  by its remaining mass; the cost sum(match * sqrt(d)); the eval divides it
  by the point count;
- mmd_cov and one_nn_acc: MMD / COV / MMD_smp of a sample x ref matrix and
  the leave-one-out 1-NN accuracy of the two sets (PointFlow's `lgan_mmd_cov`
  and `knn` with k = 1).

The matrix-vector products of the matching go through `models.mm`, so a
lower precision (TF32) there is a control the comparison must reject.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models import mm, sq_dist

LEVELS = [-(4.0 ** j) for j in range(7, -2, -1)]


@torch.no_grad()
def chamfer(x, y):
    """[P] chamfer means of pairs x [P, N, 3], y [P, M, 3]."""
    d = sq_dist(x.float(), y.float())
    return d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)


@torch.no_grad()
def approx_match_cost(x, y):
    """[P] approximate-matching transport costs of pairs x [P, N, 3],
    y [P, M, 3] (N = M here)."""
    d = sq_dist(x.float(), y.float()).clamp(min=0.0)
    p, n, m = d.shape
    dist = torch.sqrt(d.clamp(min=1e-20))
    left = torch.full((p, n), float(max(1, m // n)), device=d.device)
    right = torch.full((p, m), float(max(1, n // m)), device=d.device)
    cost = torch.zeros(p, device=d.device)
    for level in LEVELS:
        w = torch.exp(level * d)
        ratio_l = left / (1e-9 + mm(w, right[:, :, None])[:, :, 0])
        sum_r = mm(ratio_l[:, None, :], w)[:, 0, :] * right
        ratio_r = torch.clamp(right / (sum_r + 1e-9), max=1.0) * right
        cost = cost + (ratio_l * mm(w * dist, ratio_r[:, :, None])[:, :, 0]
                       ).sum(dim=1)
        left = torch.clamp(
            left - ratio_l * mm(w, ratio_r[:, :, None])[:, :, 0], min=0.0)
        right = torch.clamp(right - sum_r, min=0.0)
    return cost


def mmd_cov(dist: np.ndarray) -> dict:
    """From a [N_sample, N_ref] matrix: mmd (mean over refs of the nearest
    sample), cov (share of refs that are some sample's nearest), mmd_smp
    (mean over samples of the nearest ref)."""
    dist = np.asarray(dist)
    return {"mmd": float(dist.min(axis=0).mean()),
            "cov": float(np.unique(dist.argmin(axis=1)).size) / dist.shape[1],
            "mmd_smp": float(dist.min(axis=1).mean())}


def one_nn_acc(mxx, mxy, myy) -> dict:
    """Leave-one-out 1-NN accuracy of refs (label 1) against samples (label
    0): mxx ref x ref, mxy ref x sample, myy sample x sample."""
    mxx, mxy, myy = (np.asarray(a, np.float64) for a in (mxx, mxy, myy))
    n0, n1 = mxx.shape[0], myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    mat = np.block([[mxx, mxy], [mxy.T, myy]])
    np.fill_diagonal(mat, np.inf)
    pred = label[mat.argmin(axis=0)]
    return {"acc_t": float((pred * label).sum() / n0),
            "acc_f": float(((1 - pred) * (1 - label)).sum() / n1),
            "acc": float((pred == label).mean())}


def all_metrics(m_rs_cd, m_rs_emd, m_rr_cd, m_rr_emd, m_ss_cd, m_ss_emd):
    """The metrics of `compute_all_metrics` from its six matrices (ref x
    sample, ref x ref, sample x sample)."""
    out = {}
    for tag, m in (("CD", m_rs_cd), ("EMD", m_rs_emd)):
        out.update({f"{k}-{tag}": v
                    for k, v in mmd_cov(np.asarray(m).T).items()})
    for tag, (a, b, c) in (("CD", (m_rr_cd, m_rs_cd, m_ss_cd)),
                           ("EMD", (m_rr_emd, m_rs_emd, m_ss_emd))):
        out.update({f"1-NN-{tag}-{k}": v
                    for k, v in one_nn_acc(a, b, c).items()})
    return out
