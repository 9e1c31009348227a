"""Time the port's flagship paths on the card, for a before/after of two
checkouts in one machine. Paths (`--paths`, comma-separated):
  bf16     the bf16 generation (B=64, 1000 ancestral steps + decode, random
           weights from seed 0): seconds and clouds/min per run;
  stage1   the stage-1 train step (B=16, 2048 points, f32): ms/step;
  int8_k8  the int8 W8A8 generation with K8 attention (B=64): one 32-step
           run under torch.profiler (device busy, K8's device time in it)
           and the 1000-step run's seconds;
  stage2   the stage-2 train step (B=64, f32): ms/step, and one step under
           torch.profiler (device busy, K1's device time in it);
  k3       K3 alone at the stage-2 step's shape (f32), on its register-tiled
           kernel and, through an unaligned copy of qkv, on the scalar
           kernel it replaced (`_pr3`; the two must give the same bits);
  k4       K4 alone at the stage-1 step's three shapes (f32), on its
           register-tiled kernels and, through unaligned copies of q, k, v
           and g, on the scalar kernels they replaced (`_pr4`; the two must
           give the same bits);
  k5       K5 alone at the eval tile (64 pairs of 2048 points) on its split
           schedule and, through an unaligned copy of y, on the block
           schedule it replaced (`_pr5`).
The kernel paths give each reading as the device time per call from
torch.profiler (`device_ms`, by kernel `device_us`) and the event loop over
back-to-back wrapper calls (`ms`, host work included), taken with
chip_smoke.py's helpers.

    python scripts/torch_ab.py --root <checkout> [--paths bf16,stage1]
                               [--reps 3] [--steps 10]

`--root` is the checkout whose `ldt_torch` is imported (the default is the
one holding this script), so one copy of the script times an older commit,
or a variant of a kernel's source, unpacked beside it. Run the checkouts
alternately (A, B, B, A) in one call to the card, and compare only within
that call. Prints one JSON line with each path's numbers and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PATHS = ("bf16", "stage1", "int8_k8", "stage2", "k3", "k4", "k5")
BATCH = 64


def profiled(torch, fn) -> dict:
    """{kernel name: device us} of one `fn()` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + us
    return out


def timed(torch, fn) -> float:
    """Seconds of `fn()`, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_bf16(torch, gen, reps: int) -> dict:
    from ldt_torch.configs import compressor_cfg, score_cfg, sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate
    from ldt_torch.models import Compressor, Score

    steps = 1000
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
             BATCH, 32, device="cuda", generator=gen)
    gen_s = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(score, comp, sde, BATCH, steps, device="cuda",
                       generator=gen)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
        if not torch.isfinite(out).all():
            raise RuntimeError("torch_ab: a generated cloud is not finite")
    return {"generation_s": gen_s,
            "clouds_per_min": [BATCH / s * 60.0 for s in gen_s]}


def run_stage1(torch, gen, steps: int) -> dict:
    from ldt_torch.configs import compressor_trainer_cfg
    from ldt_torch.training import compressor_trainer as ct

    cfg = compressor_trainer_cfg()
    trainer = ct.Trainer(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(0))
    data = {"tr_points": torch.randn(cfg.data.batch_size,
                                     cfg.data.tr_max_sample_points, 3,
                                     device="cuda", generator=gen)}
    trainer.maybe_init(data)
    for _ in range(2):
        trainer.update(data)
    dt = timed(torch, lambda: [trainer.update(data) for _ in range(steps)])
    return {"stage1_ms_per_step": dt * 1e3 / steps}


def run_int8_k8(torch, gen) -> dict:
    from ldt_torch.configs import compressor_cfg, score_cfg, sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate
    from ldt_torch.models import Compressor, Score

    weights = Score(score_cfg(), device="cuda", generator=gen).state_dict()
    score = Score(score_cfg(), dtype=torch.bfloat16, device="cuda").eval()
    score.load_state_dict(weights)
    comp = Compressor(compressor_cfg(), dtype=torch.bfloat16, device="cuda",
                      generator=gen).eval()

    def run(steps):
        sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
        return lambda: generate(score, comp, sde, BATCH, steps,
                                device="cuda", generator=gen, int8=True,
                                int8_weights=weights, attn_int8=True)

    run(32)()  # warm-up
    kernels = profiled(torch, run(32))
    k8 = sum(us for k, us in kernels.items() if "self_attention_int8" in k
             or "int8_group_scales" in k)
    return {"int8_k8_busy_ms_32_steps": sum(kernels.values()) / 1e3,
            "int8_k8_k8_ms_32_steps": k8 / 1e3,
            "int8_k8_generation_s": timed(torch, run(1000))}


def run_stage2(torch, gen, steps: int) -> dict:
    from ldt_torch.configs import latent_trainer_cfg
    from ldt_torch.training.latent_sde_trainer import Trainer

    cfg = latent_trainer_cfg()
    trainer = Trainer(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(0))
    data = {"tr_points": torch.randn(BATCH, cfg.data.tr_max_sample_points,
                                     3, device="cuda", generator=gen)}
    trainer.maybe_init(data)
    for _ in range(2):
        trainer.update(data)
    dt = timed(torch, lambda: [trainer.update(data) for _ in range(steps)])
    kernels = profiled(torch, lambda: trainer.update(data))
    k1 = sum(us for k, us in kernels.items()
             if "packed_self_attention" in k and "bwd" not in k)
    return {"stage2_ms_per_step": dt * 1e3 / steps,
            "stage2_busy_ms_per_step": sum(kernels.values()) / 1e3,
            "stage2_k1_ms_per_step": k1 / 1e3}


def reading(fn) -> dict:
    """The event loop (`ms`) and the device time per call (`device_ms`, and
    by kernel `device_us`) of `fn`, as chip_smoke.py times its kernels."""
    from chip_smoke import cuda_ms, launch_us

    parts = launch_us(fn)
    return {"ms": cuda_ms(fn), "device_ms": sum(parts.values()) / 1e3,
            "device_us": parts}


def run_k3(torch, gen) -> dict:
    from chip_smoke import unaligned_copy
    from ldt_torch.ops import attention as ops

    fn = ops.packed_self_attention_bwd
    qkv = torch.randn(BATCH, 32, 3072, device="cuda", generator=gen)
    g = torch.randn(BATCH, 32, 1024, device="cuda", generator=gen)
    off = unaligned_copy(qkv)
    if not torch.equal(fn(qkv, g, 16), fn(off, g, 16)):
        raise RuntimeError("torch_ab: K3: the tiled and the scalar kernels "
                           "differ")
    return {"k3": reading(lambda: fn(qkv, g, 16)),
            "k3_pr3": reading(lambda: fn(off, g, 16))}


def run_k4(torch, gen) -> dict:
    from chip_smoke import unaligned_copy
    from ldt_torch.ops import attention as ops

    out = {}
    fn = ops.cross_attention_bwd
    for shape, (n, m) in {"encoder": (32, 32), "posterior": (32, 2048),
                          "decoder": (2048, 32)}.items():
        q, k, v, g = (torch.randn(16, x, 128, device="cuda", generator=gen)
                      for x in (n, m, m, n))
        off = [unaligned_copy(t) for t in (q, k, v, g)]
        if not all(torch.equal(a, b) for a, b in zip(fn(q, k, v, g, 4),
                                                     fn(*off, 4))):
            raise RuntimeError(f"torch_ab: K4 {shape}: the tiled and the "
                               "scalar kernels differ")
        out[f"k4_{shape}"] = reading(lambda: fn(q, k, v, g, 4))
        out[f"k4_{shape}_pr4"] = reading(lambda: fn(*off, 4))
    return out


def run_k5(torch) -> dict:
    import numpy as np

    from chip_smoke import synthetic_shapes, unaligned_copy
    from ldt_torch.ops import chamfer

    rng = np.random.default_rng(0)
    x = torch.from_numpy(synthetic_shapes(64, 2048, rng)).cuda()
    y = torch.from_numpy(synthetic_shapes(64, 2048, rng)).cuda()
    yu = unaligned_copy(y)
    fn = chamfer.pairwise_cd_means
    twin = chamfer.pairwise_cd_means_plain(x, y)
    for got in (fn(x, y), fn(x, yu)):
        rel = ((got - twin).abs() / twin.abs()).max().item()
        if rel > 1e-5:
            raise RuntimeError(f"torch_ab: K5 off its twin by {rel:.3e}")
    return {"k5": reading(lambda: fn(x, y)),
            "k5_pr5": reading(lambda: fn(x, yu))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--paths", default="bf16,stage1")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        ap.error(f"--paths: choose from {', '.join(PATHS)}")
    sys.path.insert(0, str(Path(args.root).resolve()))
    # chip_smoke.py's helpers, where the root has none
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import torch

    if not torch.cuda.is_available():
        print("torch_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"root": args.root, "card": card}
    runs = {"bf16": lambda: run_bf16(torch, gen, args.reps),
            "stage1": lambda: run_stage1(torch, gen, args.steps),
            "int8_k8": lambda: run_int8_k8(torch, gen),
            "stage2": lambda: run_stage2(torch, gen, args.steps),
            "k3": lambda: run_k3(torch, gen),
            "k4": lambda: run_k4(torch, gen),
            "k5": lambda: run_k5(torch)}
    for path in paths:
        result.update(runs[path]())
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
