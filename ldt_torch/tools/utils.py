"""Host utilities of the entries, counterpart of `ldt_tpu/tools/utils.py`:
normalization, seeding, the training dtype, the epoch's loss sync and the
running meter."""

from __future__ import annotations

import random

import numpy as np
import torch

from ldt_torch import resolve_device


def normalize_point_clouds(pcs: np.ndarray) -> np.ndarray:
    """Each cloud of [B, N, 3] centred and scaled to unit max radius."""
    pcs = np.asarray(pcs)
    pcs = pcs - np.mean(pcs, axis=1, keepdims=True)
    furthest = np.max(np.sqrt(np.sum(pcs ** 2, axis=-1, keepdims=True)),
                      axis=1, keepdims=True)
    return pcs / furthest


def common_init(seed: int, device="cuda") -> torch.Generator:
    """Seed `random`, numpy and torch; returns the trainers' generator on
    `device`, seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(resolve_device(device)).manual_seed(seed)


TRAIN_DTYPES = {"float32": torch.float32, "f32": torch.float32,
                "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def train_dtype(cfg) -> torch.dtype:
    """`cfg.common.train_dtype` as the models' compute dtype: 'float32'
    (the default) or 'bfloat16', the JAX package's mixed precision (f32
    parameters, bf16 activations and products); an unknown name raises."""
    name = str(getattr(cfg.common, "train_dtype", None) or "float32")
    if name not in TRAIN_DTYPES:
        raise ValueError(f"common.train_dtype={name!r}: expected one of "
                         f"{sorted(TRAIN_DTYPES)}")
    return TRAIN_DTYPES[name]


def sync_epoch_values(values) -> np.ndarray:
    """An epoch's per-step 0-d tensors (on the device), or tuples of them
    (a row each), as one numpy array, in one device-to-host transfer."""
    if not values:
        return np.zeros((0,), np.float32)
    if isinstance(values[0], tuple):
        values = [torch.stack(v) for v in values]
    return torch.stack(values).cpu().numpy()


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
