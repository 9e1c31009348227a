"""Generative metrics (MMD/COV/1-NNA over CD and EMD, JSD) and losses of the
port, counterpart of `ldt_tpu/eval`."""

from ldt_torch.eval.loss import (
    CD_loss,
    EMD_loss,
    F1Score,
    L2_ChamferEval_1000,
    fscore,
    huber_loss,
    kl_softmax_loss,
)
from ldt_torch.eval.metrics import (
    EMD_CD,
    compute_CD_metrics,
    compute_MMD_metrics,
    compute_all_metrics,
    jsd_between_point_cloud_sets,
    knn,
    lgan_mmd_cov,
    pairwise_CD,
    pairwise_EMD_CD,
)

__all__ = [
    "EMD_CD",
    "CD_loss",
    "EMD_loss",
    "F1Score",
    "L2_ChamferEval_1000",
    "compute_CD_metrics",
    "compute_MMD_metrics",
    "compute_all_metrics",
    "fscore",
    "huber_loss",
    "jsd_between_point_cloud_sets",
    "kl_softmax_loss",
    "knn",
    "lgan_mmd_cov",
    "pairwise_CD",
    "pairwise_EMD_CD",
]
