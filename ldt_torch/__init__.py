"""LDT in PyTorch and CUDA for NVIDIA Hopper.

A port of `ldt_tpu` (JAX/flax/Pallas), which stays the reference. The module
layout and names follow `ldt_tpu` so each part has an obvious counterpart:

  * `configs`                 <- ldt_tpu/configs.py (the stage-1 and stage-2
                                 config.yaml's values)
  * `ops.attention`           <- ldt_tpu/ops/pallas_attention.py (CUDA kernels
                                 in `csrc/attention.cu`, built by `ops._build`)
  * `ops.geometry`            <- ldt_tpu/ops/geometry.py (FPS, kNN, grouping,
                                 the PVCNN primitives)
  * `ops.masks`               <- ldt_tpu/ops/masks.py (set masks,
                                 MaskedBatchNorm)
  * `ops.chamfer`, `ops.emd`  <- ldt_tpu/ops/chamfer.py, emd.py (the stage-1
                                 losses: chamfer, auction EMD; the eval's K5
                                 and K6/K7 as CUDA kernels in
                                 `csrc/eval.cu`, bound by
                                 `ops._eval_kernels`)
  * `eval.loss`               <- ldt_tpu/eval/loss.py
  * `eval.metrics`            <- ldt_tpu/eval/metrics.py (MMD/COV/1-NNA over
                                 CD and EMD, JSD)
  * `nn.layers`               <- ldt_tpu/nn/layers.py
  * `models.score`            <- ldt_tpu/models/score.py
  * `models.compressor`       <- ldt_tpu/models/compressor.py (encode, decode)
  * `diffusion.sde/sampling`  <- ldt_tpu/diffusion/
  * `serving.int8`            <- ldt_tpu/serving/int8.py (unconditional W8A8)
  * `training`                <- ldt_tpu/training/ (state, base; stage 1:
                                 compressor_trainer; stage 2:
                                 latent_sde_trainer; both with their
                                 `valsample`, stage 1 `reconstruction`;
                                 the completion trainers of both stages;
                                 checkpoint: `checkpt_{epoch}.pt`, and
                                 jax_checkpoint: the JAX package's
                                 `.msgpack` files, both ways)
  * `tools`, `data`, `cli`    <- ldt_tpu/tools/{io,log,utils}.py (with a
                                 YAML reader), ldt_tpu/data/ (PC15k
                                 ShapeNet; ShapeNet-ViPC with a PNG reader
                                 of its own), ldt_tpu/cli.py
  * `entries`                 <- train_Compressor.py,
                                 train_Latent_Diffusion.py, val_sample.py,
                                 train_Completion_Compressor.py,
                                 train_Completion_Latent_Diffusion.py,
                                 __graft_entry__.py::dryrun_multichip
                                 (`python -m ldt_torch.entries.<name>`)
  * `parallel`                <- ldt_tpu/parallel/ (data, tensor and
                                 sequence parallelism over
                                 torch.distributed; `comm` the collectives)
  * `weights`                 flax variable trees -> torch state_dicts
  * `generate`                noise -> [B, 2048, 3] clouds (bench.py::generate,
                                 bf16 or int8 serving)

Every entry point takes an explicit `device`, which defaults to "cuda" and
raises when no card is present; only `device="cpu"` runs on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises instead of drifting to CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ldt_torch: no CUDA device is available; pass device='cpu' to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ldt_torch: unsupported device {dev}")
    return dev
