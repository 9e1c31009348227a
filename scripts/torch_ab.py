"""Time the port's two host-bound paths on the card, for a before/after of
two checkouts in one machine: the flagship bf16 generation (B=64, 1000
ancestral steps + decode, random weights from seed 0) and the flagship
stage-1 train step (B=16, 2048 points, f32).

    python scripts/torch_ab.py --root <checkout> [--reps 3] [--steps 10]

`--root` is the checkout whose `ldt_torch` is imported (the default is the
one holding this script), so one copy of the script times an older commit
unpacked beside it. Run the checkouts alternately (A, B, B, A) in one call
to the card, and compare only within that call. Prints one JSON line:
each generation's seconds and clouds/min, the train steps' ms/step, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from ldt_torch.configs import (compressor_cfg, compressor_trainer_cfg,
                                   score_cfg, sde_cfg)
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate
    from ldt_torch.models import Compressor, Score
    from ldt_torch.training import compressor_trainer as ct

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch, steps = 64, 1000
    weights = Score(score_cfg(), device="cuda", generator=gen).state_dict()
    score = Score(score_cfg(), dtype=torch.bfloat16, device="cuda").eval()
    score.load_state_dict(weights)
    del weights
    comp = Compressor(compressor_cfg(), dtype=torch.bfloat16, device="cuda",
                      generator=gen).eval()
    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    # warm-up: builds the kernels, fills the allocator and the caches
    generate(score, comp, make_diffusion(sde_cfg(sample_N=32),
                                         device="cuda"),
             batch, 32, device="cuda", generator=gen)
    gen_s = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(score, comp, sde, batch, steps, device="cuda",
                       generator=gen)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
        if not torch.isfinite(out).all():
            print("torch_ab: a generated cloud is not finite",
                  file=sys.stderr)
            return 1
    del score, comp, sde

    cfg = compressor_trainer_cfg()
    trainer = ct.Trainer(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(0))
    data = {"tr_points": torch.randn(cfg.data.batch_size,
                                     cfg.data.tr_max_sample_points, 3,
                                     device="cuda", generator=gen)}
    trainer.maybe_init(data)
    for _ in range(2):
        trainer.update(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        trainer.update(data)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(json.dumps({
        "root": args.root, "card": card,
        "generation_s": gen_s,
        "clouds_per_min": [batch / s * 60.0 for s in gen_s],
        "stage1_ms_per_step": step_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
