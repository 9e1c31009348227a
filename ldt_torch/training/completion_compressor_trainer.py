"""ViPC completion, stage 1: the set-VAE Compressor on FPS-subsampled GT
clouds, counterpart of `ldt_tpu/training/completion_compressor_trainer.py`.

The stage-1 trainer (`compressor_trainer.Trainer`: the same loss, optimizer
and checkpoints) with:
  * `update` on a [B, N, 3] array or tensor (the entry subsamples the GT
    clouds with `fps_to` first) or on a ViPC batch dict (its `pc` as it
    is);
  * `reconstruction`: each test batch's GT clouds `fps_to` the trainer's
    point count, encoded and decoded, scored by CD x 1000
    (`L2_ChamferEval_1000`) and the F-score (`F1Score`, threshold 1e-3)
    over the whole split: {'cd', 'f1score'}; the reconstructions go to
    `rec_ep<epoch>.npy`;
  * `load_pretrain`: the run starts from the stage-1 checkpoint
    `model.pretrain_path` (a port `.pt` or a JAX `.msgpack`), its whole
    train state; without one it raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ldt_torch.eval.loss import F1Score, L2_ChamferEval_1000
from ldt_torch.ops.geometry import furthest_point_sample, index_points
from ldt_torch.training.base import to_numpy
from ldt_torch.training.checkpoint import load_checkpoint, restore_into
from ldt_torch.training.compressor_trainer import Trainer as CompressorTrainer

# clouds a chamfer call takes at once in the completion scores (its
# [B, N, M] distances: 64 x 2048 x 2048 f32 = 1 GiB)
SCORE_CHUNK = 64


def fps_to(pc, n: int, device="cpu") -> torch.Tensor:
    """Furthest-point-subsample clouds [B, N, 3] (numpy or a tensor) to
    [B, n, 3] on `device`, where they stay."""
    pts = torch.as_tensor(pc, dtype=torch.float32).to(device)
    return index_points(pts, furthest_point_sample(pts, n))


@torch.no_grad()
def completion_scores(smp: np.ndarray, ref: np.ndarray,
                      device="cpu") -> dict:
    """{'cd': CD x 1000, 'f1score': the mean F-score} of clouds `smp`
    against `ref` (numpy, pair by pair), in chunks of `SCORE_CHUNK` pairs
    on `device`: the means over every point of the split."""
    cd_sum, f1 = 0.0, []
    for i in range(0, len(smp), SCORE_CHUNK):
        a = torch.from_numpy(np.ascontiguousarray(smp[i:i + SCORE_CHUNK])
                             ).to(device)
        b = torch.from_numpy(np.ascontiguousarray(ref[i:i + SCORE_CHUNK])
                             ).to(device)
        cd_sum += L2_ChamferEval_1000(a, b).item() * len(a)
        f1.append(F1Score(a, b)[0].cpu())
    return {"cd": cd_sum / len(smp),
            "f1score": float(torch.cat(f1).mean())}


class Trainer(CompressorTrainer):
    """The completion stage-1 trainer; `cfg` as the stage-1 trainer's (its
    `model.pretrain_path` the stage-1 checkpoint to start from)."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device=device, generator=generator)
        self.num_points = cfg.data.tr_max_sample_points

    @staticmethod
    def _batch(data) -> dict:
        """A stage-1 batch of a raw [B, N, 3] array or a ViPC dict."""
        if isinstance(data, dict) and "tr_points" not in data:
            data = data["pc"]
        if isinstance(data, dict):
            return data
        return {"tr_points": data,
                "cate_idx": np.zeros((data.shape[0],), np.int32)}

    def update(self, data, *,
               noise: Optional[Sequence[torch.Tensor]] = None):
        """One stage-1 step on a [B, N, 3] array or tensor (the entry's
        FPS-subsampled GT clouds, kept on the device) or on a ViPC batch
        (its `pc`); returns (loss, kl, rec, max)."""
        return super().update(self._batch(data), noise=noise)

    def reconstruct(self, pts: torch.Tensor) -> torch.Tensor:
        """The Compressor's encode-decode of clouds [B, N, 3] (running
        statistics, draws from the generator)."""
        return self.encode(pts)["set"]

    def reconstruction(self, test_loader, val_cate: int = 0):
        """CD x 1000 and F1 of the test split's reconstructions against its
        GT clouds, both `fps_to` the trainer's point count; `val_cate` is
        unused (the entries' common signature)."""
        all_ref, all_rec = [], []
        for data in test_loader:
            ref_pts = fps_to(data["pc"], self.num_points, self.device)
            if self.state is None:
                self.maybe_init({"tr_points": ref_pts})
            all_rec.append(self.reconstruct(ref_pts).cpu().numpy())
            all_ref.append(to_numpy(ref_pts))
        rec = np.concatenate(all_rec)
        ref = np.concatenate(all_ref)
        self.save_npy(f"rec_ep{self.epoch}.npy", rec)
        all_res = completion_scores(rec, ref, self.device)
        print(f"Validation Sample (unit) Epoch:{self.epoch} ", all_res)
        return all_res

    reconstrustion = reconstruction

    def load_pretrain(self) -> None:
        """The whole train state (params, BatchNorm statistics, optimizer,
        step) from the stage-1 checkpoint `model.pretrain_path`, a port
        `.pt` or a JAX `.msgpack`; the run's counters stay."""
        self._need_state("load_pretrain")
        path = getattr(self.cfg.model, "pretrain_path", None)
        if not path:
            raise ValueError(
                "completion compressor finetune bootstraps from a stage-1 "
                "checkpoint: set model.pretrain_path in config.yaml (or "
                "pass --resume to continue this run)")
        ckpt = load_checkpoint(path)
        restored = restore_into(self.state_tree(), ckpt["state"])
        self.state.load_tree(restored["state"])
