"""Calibrate the static activation scales of int8 serving, counterpart of
`scripts/int8_calibrate.py`.

    python -m ldt_torch.entries.int8_calibrate --exp <experiment dir> \
        [--epoch N] [--batch 64] [--margin 1.0] [--attn-int8] \
        [--bf16-tail K] [--device cpu]

`--exp` holds a stage-2 `config.yaml` and its checkpoints (the port's
`.pt` or the JAX package's `.msgpack`); the checkpoint is `--epoch`'s, else
training.csv's last, else the newest on disk. One ancestral reverse run of
`sde.sample_N` steps with the dynamic W8A8 sampler on the EMA params
(`serving.int8.calibrate_act_scales`, `--batch` clouds, draws from a
generator seeded with 7) records each quantized GEMM input's amax per step;
the [sample_N, num_blocks, 4] table of amax / 127, times `--margin`, is
written next to the checkpoint (`<ckpt>.int8_act_scales.npz`, the JAX
package's format), bound to the checkpoint's content and to `--bf16-tail`.
Serving it: `Trainer.sample(..., serve_int8=True, static_act=True)`; gate
that scheme with `int8_golden_gate --static-act`. A predictor other than
ancestral, or the continuous sampler, is refused.

The JAX script's environment knobs are flags here: `--attn-int8`
(LDT_ATTN_INT8: K8 as the attention core) and `--bf16-tail`
(LDT_INT8_BF16_TAIL). `--device` as the other entries'.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ldt_torch import resolve_device
from ldt_torch.diffusion import make_diffusion
from ldt_torch.diffusion.sampling import timesteps
from ldt_torch.models import Score
from ldt_torch.serving.int8 import (
    calibrate_act_scales,
    quantize_score_params,
    save_act_scales,
)
from ldt_torch.tools.io import dict2namespace, load_yaml
from ldt_torch.training.checkpoint import (
    checkpoint_file,
    load_checkpoint,
    resolve_checkpoint_epoch,
)

# the calibration run's draws (the JAX script's key)
CALIBRATION_SEED = 7


def ema_score_state(ckpt_path: str) -> dict:
    """The Score's state_dict of a stage-2 checkpoint: its EMA params (or
    its params when it holds no EMA) and running statistics."""
    sc = load_checkpoint(ckpt_path)["state"]["score"]
    return {**(sc.get("ema_params") or sc["params"]),
            **(sc.get("batch_stats") or {})}


def main(args) -> str:
    """Calibrate as `args` say; returns the written table's path."""
    device = resolve_device(args.device)
    cfg = dict2namespace(load_yaml(os.path.join(args.exp, "config.yaml")))
    if cfg.sde.predictor != "ancestral" or cfg.sde.sample_mode == "continuous":
        raise SystemExit("[calibrate] static int8 scales are "
                         "ancestral/discrete-only (the certified int8 "
                         f"regime); config has predictor={cfg.sde.predictor}"
                         f" sample_mode={cfg.sde.sample_mode}")
    epoch = resolve_checkpoint_epoch(args.exp, args.epoch)
    ckpt_path = checkpoint_file(args.exp, epoch)
    print(f"[calibrate] checkpoint: {ckpt_path}")
    # modulations from a bf16 Score over the f32 params, weights quantized
    # from the f32 params (the JAX script's)
    score = Score(cfg.score, dtype=torch.bfloat16, param_dtype=torch.float32,
                  device=device)
    score.load_state_dict(ema_score_state(ckpt_path))
    sde = make_diffusion(cfg.sde, device=device)
    n = int(cfg.sde.sample_N)
    eps = float(cfg.sde.sample_time_eps)
    t0 = time.perf_counter()
    with torch.inference_mode():
        mods = score.precompute_mods(timesteps(n, eps).to(device))
        qp = quantize_score_params(score, cfg.score.num_blocks,
                                   args.bf16_tail, device=device)
        scales, x_mean = calibrate_act_scales(
            sde, mods, qp, cfg.score.num_heads, args.batch,
            (cfg.score.z_scale, cfg.score.z_dim), n, time_eps=eps,
            attn_int8=args.attn_int8, device=device,
            generator=torch.Generator(device).manual_seed(CALIBRATION_SEED))
    scales = scales.cpu() * args.margin
    print(f"[calibrate] {n}-step recording run: "
          f"{time.perf_counter() - t0:.1f} s; latent amax "
          f"{x_mean.abs().max().item():.3f}")
    out = save_act_scales(
        ckpt_path, scales, bf16_tail=args.bf16_tail, sample_N=n,
        num_blocks=int(cfg.score.num_blocks), batch=args.batch,
        margin=args.margin, epoch=epoch, predictor=str(cfg.sde.predictor),
        sample_time_eps=eps)
    print(f"[calibrate] wrote {out} (shape {tuple(scales.shape)}, scale "
          f"range [{scales.min().item():.2e}, {scales.max().item():.2e}])")
    return out


def get_parser():
    ap = argparse.ArgumentParser("int8 static-scale calibration")
    ap.add_argument("--exp", required=True)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--batch", type=int, default=64,
                    help="calibration batch (amax is max-reduced over it)")
    ap.add_argument("--margin", type=float, default=1.0,
                    help="scale multiplier headroom for runtime "
                    "distributions exceeding the calibration batch")
    ap.add_argument("--attn-int8", action="store_true",
                    help="K8 (int8 operands) as the attention core")
    ap.add_argument("--bf16-tail", type=int, default=0,
                    help="keep the last k blocks' weights in bf16")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


if __name__ == "__main__":
    main(get_parser().parse_args())
