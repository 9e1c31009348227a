"""Golden-eval gate of int8 serving, counterpart of
`scripts/int8_golden_gate.py`.

    python -m ldt_torch.entries.int8_golden_gate --exp <experiment dir> \
        [--epoch N] [--num 256] [--steps N] [--predictor P] \
        [--threshold 0.01] [--completion] [--attn-int8] [--bf16-tail K] \
        [--static-act] [--static-file F] [--device cpu]

`--exp` holds a stage-2 `config.yaml` (`--completion`: a ViPC completion
stage 2's) and its checkpoints (`.pt` or the JAX package's `.msgpack`);
the checkpoint is `--epoch`'s, else training.csv's last, else the newest
on disk. The trainer restored from it samples the same draws (its generator
seeded with 1234 before each leg) through the exact sampler and through the
W8A8 one, `--steps` and `--predictor` overriding `sde.sample_N` and
`sde.predictor`:
  * unconditional: `--num` clouds in batches of `data.test_batch_size`,
    scored against the val split by `compute_CD_metrics` (K5 on the card);
    the gated metrics are the MMD, COV and 1-NNA ones;
  * `--completion`: one completion per test item until `--num`, from its
    view and its partial cloud (both clouds `fps_to` 2048), scored by CD x
    1000 and F1 against the GT clouds (both gated), plus the paired CD x
    1000 of the two legs' clouds (printed only).
Each gated metric must agree within `--threshold` (relative); the deltas,
each leg's clouds/min and the verdict are printed, the verdict is stamped
next to the checkpoint (`<ckpt>.int8_gate.json`, the JAX package's format:
a list of entries per checkpoint content and sampler config), and the exit
code is 0 on a pass. The gate's own legs check no stamp.

The JAX script's environment knobs are flags here: `--attn-int8`
(LDT_ATTN_INT8), `--bf16-tail` (LDT_INT8_BF16_TAIL), `--static-act`
(LDT_INT8_STATIC: the int8 leg serves the checkpoint's static scales, from
`int8_calibrate`; the conditional sampler has none) and `--static-file`
(LDT_INT8_STATIC_FILE). They are part of the stamped sampler config.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ldt_torch import resolve_device
from ldt_torch.tools.io import dict2namespace, load_yaml
from ldt_torch.training.checkpoint import (
    checkpoint_file,
    resolve_checkpoint_epoch,
)

# the draws of both legs (the JAX script's key)
LEG_SEED = 1234


def _legs(trainer, sample, batches, num: int, device) -> dict:
    """{leg: clouds [num, P, 3]} of the exact ("exact") and the int8
    ("int8") sampler on the same draws; prints each leg's clouds/min."""
    samples = {}
    for mode in ("exact", "int8"):
        trainer.generator.manual_seed(LEG_SEED)
        trainer.synchronize()
        t0 = time.perf_counter()
        out = [sample(mode == "int8", b).cpu().numpy() for b in batches]
        trainer.synchronize()
        dt = time.perf_counter() - t0
        samples[mode] = np.concatenate(out)[:num]
        print(f"[gate] {mode}: {samples[mode].shape[0]} clouds in "
              f"{dt:.2f} s = {samples[mode].shape[0] / dt * 60:.1f} "
              f"clouds/min ({device})")
    return samples


def _completion(args, cfg, trainer, epoch: int, device):
    """The completion legs: (results, gated metric names)."""
    from ldt_torch.data.vipc import get_data_loaders
    from ldt_torch.training.completion_compressor_trainer import (
        completion_scores,
        fps_to,
    )

    loaders = get_data_loaders(cfg.data)
    trainer.maybe_init(next(iter(loaders["train_loader"])))
    trainer.resume(epoch=epoch, strict=False)
    batches, total = [], 0
    for data in loaders["test_loader"]:
        ref_pts = fps_to(data["pc"], 2048, device)
        batches.append((ref_pts, {"img": data["views"],
                                  "pts": fps_to(data["pc_part"], 2048,
                                                device)}))
        total += ref_pts.shape[0]
        if total >= args.num:
            break
    ref = np.concatenate([b[0].cpu().numpy() for b in batches])[:args.num]
    print(f"[gate] completion: sampling {ref.shape[0]} clouds x "
          f"{cfg.sde.sample_N} steps, exact vs int8 (same draws)")

    def sample(int8, batch):
        ref_pts, cond = batch
        return trainer.sample(ref_pts.shape[0], condition=cond, int8=int8,
                              attn_int8=int8 and args.attn_int8)[0]

    samples = _legs(trainer, sample, batches, args.num, device)
    results = {}
    for mode, smp in samples.items():
        s = completion_scores(smp, ref, device)
        results[mode] = {"cd_x1000": s["cd"], "f1score": s["f1score"]}
        print(f"[gate] {mode}: {json.dumps(results[mode])}")
    pair = completion_scores(samples["int8"], samples["exact"], device)
    print(f"[gate] direct int8<->exact paired CD x1000 on identical draws "
          f"(informational): {pair['cd']:.6f}")
    return results, list(results["exact"])


def _unconditional(args, cfg, trainer, epoch: int, device):
    """The unconditional legs: (results, gated metric names)."""
    from ldt_torch.data import get_data_loaders
    from ldt_torch.eval import compute_CD_metrics

    loaders = get_data_loaders(cfg.data, dict2namespace(
        dict(eval_split="val")))
    trainer.maybe_init(next(iter(loaders["train_loader"])))
    trainer.resume(epoch=epoch, strict=False)
    ref = np.concatenate([np.asarray(b["te_points"])
                          for b in loaders["test_loader"]])[:args.num]
    num = ref.shape[0]
    print(f"[gate] sampling {num} clouds x {cfg.sde.sample_N} steps, exact "
          f"vs int8 (same draws)")
    bs = cfg.data.test_batch_size
    sizes = [min(bs, num - i) for i in range(0, num, bs)]
    knobs = dict(attn_int8=args.attn_int8, bf16_tail=args.bf16_tail,
                 static_act=args.static_act, static_file=args.static_file)

    def sample(int8, n):
        return trainer.sample(n, serve_int8=int8,
                              **(knobs if int8 else {}))[0]

    samples = _legs(trainer, sample, sizes, num, device)
    results = {}
    for mode, smp in samples.items():
        res = compute_CD_metrics(smp, ref, batch_size=64, device=device)
        results[mode] = {k: float(v) for k, v in res.items()}
        print(f"[gate] {mode}: {json.dumps(results[mode])}")
    gated = [k for k in results["exact"]
             if "mmd" in k or "acc" in k.lower() or "cov" in k.lower()]
    return results, gated


def main(args) -> int:
    """Run the gate as `args` say; returns the exit code (0: passed)."""
    from ldt_torch.serving.int8 import write_gate_stamp

    device = resolve_device(args.device)
    cfg = dict2namespace(load_yaml(os.path.join(args.exp, "config.yaml")))
    cfg.log.save_path = args.exp
    if args.steps:
        cfg.sde.sample_N = args.steps
    if args.predictor:
        cfg.sde.predictor = args.predictor
    if args.completion and (args.static_act or args.bf16_tail
                            or args.static_file):
        raise SystemExit("[gate] the conditional int8 sampler has no static "
                         "scales and no bf16 tail")
    epoch = resolve_checkpoint_epoch(args.exp, args.epoch)
    ckpt_path = checkpoint_file(args.exp, epoch)
    print(f"[gate] checkpoint: {ckpt_path}")
    if args.completion:
        from ldt_torch.training.completion_latent_sde_trainer import Trainer
    else:
        from ldt_torch.training.latent_sde_trainer import Trainer
    trainer = Trainer(cfg, device=device)
    # the gate is the certification run: its own legs check no stamp
    trainer.gate_exempt = True
    run = _completion if args.completion else _unconditional
    results, gated = run(args, cfg, trainer, epoch, device)

    failed = []
    print(f"{'metric':<24}{'exact':>14}{'int8':>14}{'rel delta':>12}")
    for k in gated:
        a, b = results["exact"][k], results["int8"][k]
        rel = abs(b - a) / max(abs(a), 1e-12)
        # a non-finite metric fails the gate
        ok = bool(np.isfinite(rel)) and rel <= args.threshold
        print(f"{k:<24}{a:>14.6f}{b:>14.6f}{rel:>11.4%}"
              f"{'' if ok else '  <-- FAIL'}")
        if not ok:
            failed.append(k)
    stamp = write_gate_stamp(ckpt_path, cfg, args.completion,
                             passed=not failed, results=results,
                             threshold=args.threshold,
                             attn_int8=args.attn_int8,
                             bf16_tail=args.bf16_tail,
                             static_act=args.static_act)
    print(f"[gate] stamp written: {stamp}")
    if failed:
        print(f"[gate] FAILED: {failed}")
        return 1
    print(f"[gate] PASSED: all {len(gated)} metrics within "
          f"{args.threshold:.1%}")
    return 0


def get_parser():
    ap = argparse.ArgumentParser("int8 golden gate")
    ap.add_argument("--exp", required=True, help="experiment dir with "
                    "config.yaml + checkpt_{N}.pt or .msgpack")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--num", type=int, default=256)
    ap.add_argument("--steps", type=int, default=None,
                    help="override sde.sample_N")
    ap.add_argument("--predictor", type=str, default=None,
                    help="override sde.predictor (e.g. ddim for the "
                    "50-step fast-serving mode)")
    ap.add_argument("--threshold", type=float, default=0.01)
    ap.add_argument("--completion", action="store_true",
                    help="gate the conditional (ViPC completion) int8 "
                    "sampler; --exp must be a completion run")
    ap.add_argument("--attn-int8", action="store_true",
                    help="the int8 leg's attention core is K8 (int8 "
                    "operands)")
    ap.add_argument("--bf16-tail", type=int, default=0,
                    help="the int8 leg keeps the last k blocks in bf16")
    ap.add_argument("--static-act", action="store_true",
                    help="the int8 leg serves the checkpoint's static "
                    "activation scales (int8_calibrate)")
    ap.add_argument("--static-file", type=str, default=None,
                    help="an explicit static-scale table")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


if __name__ == "__main__":
    sys.exit(main(get_parser().parse_args()))
