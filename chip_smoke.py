#!/usr/bin/env python3
"""Bring-up check of the `ldt_torch` port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository:  python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):
  1. Build the CUDA kernels (ldt_torch/csrc/attention.cu and eval.cu, one
     nvcc each, started together); print the time.
  2. Hold each kernel against its plain PyTorch twin on the card at the main
     path's shapes, in f32 and bf16, each repeating its bits (K2 here: its
     whole-set schedule at the decode shape; K1 on its register-tiled f32
     and tensor-core bf16 schedules, the schedule the library reports and
     the profiler names checked); time the kernel (event loop and device
     time), the twin and one `scaled_dot_product_attention` call on the
     same tensors (a yardstick only: the port never calls it); work out each
     kernel's bound. K1's first CUDA-core kernel runs and is timed at both
     shapes through an unaligned copy (the before of the same run); in f32
     it must equal the register-tiled schedule bit for bit.
  3. Full-width flagship DiT (24 blocks, hidden 1024, bf16) plus the 6-block
     decoder, random weights from a seed: the two halves of `generate` (a
     short sampler run; the decoder on N(0, 1) latents) through the kernels
     and through the plain attention, same weights and draws, held within a
     stated limit; launch counts checked.
  4. The whole `generate`: 1000 ancestral steps plus the decode to
     [B, 2048, 3], with the launch counters set to 0 just before and read
     just after; prints clouds/min with the card's name and power limit.
  5. Where the time goes: a short generation under `torch.profiler`, device
     time by kernel and the device's idle share.
  6. A reference on a small input: cut to two blocks in f32, the sampler
     and the decoder on the card against the CPU run of the port (the path
     the CPU tests hold against ldt_tpu) on the same inputs. It runs last,
     so that its CPU work does not share the host with the timed phases.
The int8 serving path (W8A8, `generate(..., int8=True)`; bench.py's
default), in this order among the phases above:
  7. (after 2) Kernel K8 against its plain twin on the card and on the CPU
     at the main path's shape, and against wrong variants that must fail
     (scales per batch element, weights left unquantized before AV, k and
     v swapped); on the int8 tensor cores (the library's report and the
     profiler's kernel name), equal bit for bit to its CUDA-core kernels run
     through an unaligned copy; both timed by the event loop and by device
     time, with the bound and the twin's time.
  8. (after 7) The int8 GEMMs at the DiT's four block shapes: `_int_mm`,
     the whole dynamic `int8_matmul` and a bf16 matmul, timed; the int8
     product on the card equal to the CPU's bit for bit.
  9. (after 4) Two full int8 generations, 1000 steps + decode at B=64:
     attention through K1 (bench.py's default), then through K8; launch
     counts checked (every K8 launch on the int8 tensor cores, as the
     library reports), clouds/min printed.
 10. (after 9) A 32-step DDIM generation through the int8 path and K8 (its
     launch counts checked as phase 9's).
     Phase 5 then profiles the bf16 and the int8 (K8) paths.
 11. (before 6) One int8 step at flagship width cut to two blocks, on the
     card against the CPU run of the port, and against wrong variants.
Stage-2 training (`ldt_torch.training.latent_sde_trainer.Trainer.update`):
 12. (after 8) K3 (the backward of K1) at the train step's shape, K2's
     long-key schedule at the posterior's shape (M=2048) and its whole-set
     schedule at the encoder's (N=M=32, f32) against their plain twins on
     the card and on the CPU and against wrong variants, each kernel
     repeating its bits; K3 on its register-tiled kernel (the library's
     report and the profiler's name), equal bit for bit to its scalar
     kernel run through an unaligned copy; their times (K3's scalar kernel
     and the SDPA backward yardstick by device time too), bounds, twin
     times and the SDPA yardsticks.
 13. (after 10) The flagship train step at B=64, f32: the frozen full
     Compressor encodes synthetic [64, 2048, 3] clouds, then loss, K1
     forward / K3 backward through the 24-block Score, clip, Adam, EMA;
     launch counts K1 24 (register-tiled), K3 24 (register-tiled), K2 24
     per step; ms per step; one step under torch.profiler by kernel
     class.
 14. (after 11) One train step at flagship width cut to two Score blocks,
     f32, same weights, clouds and pinned draws, on the card (K3 on its
     register-tiled kernel) against the CPU, and against a K3 with dq and
     dk swapped.
Stage-1 training (`ldt_torch.training.compressor_trainer.Trainer.update`):
 15. (after 12) K4 (the backward of K2) at the stage-1 step's three shapes
     (B=16, 32x32, 32x2048 long-key, 2048x32 long-query) against its plain
     twin on the card and on the CPU and against wrong variants (no rowsum;
     dk/dv or dq/dk swapped; one dk/dv partial tile dropped; bf16: ds from
     the rounded weights), f32 and bf16, on its register-tiled kernels (the
     library's report and the profiler's names); equal bit for bit to the
     scalar kernels run through unaligned copies; both timed (event loop and
     device time), with the bounds, twin times and the SDPA backward
     yardstick.
 16. (after 13) The flagship stage-1 train step (B=16, 2048 points, 6
     layers, f32) on synthetic clouds: 10 steps timed, launch counts K2 24
     (5 tiled) and K4 24 (5 long-key, 6 long-query, all 24 register-tiled)
     per step, one step's parts by CUDA events, one step under
     torch.profiler by class, and the chamfer and auction-EMD losses alone
     under it.
 17. (after 14) One stage-1 step at flagship width cut to two layers, f32,
     same weights, clouds, pinned noise, chamfer neighbours and EMD
     assignment, on the card (K4 on its tiled kernels) against the CPU, and
     against a K4 with dq and dk swapped; the auction alone on dyadic-grid
     clouds, card == CPU.
Evaluation (`ldt_torch.eval.metrics`, the trainers' `valsample` and
`reconstruction`), on clouds at ShapeNet's scale (`synthetic_shapes`):
 18. (after 15) K5 (`pairwise_cd_means`) and K6/K7 (`approx_match_cost`,
     d streamed / built on the fly) on 32 pairs of 2048-point clouds against
     their twins on the card and on the CPU and against wrong variants (K5:
     one direction, on sqrt d, one row tile's column minima dropped; K6: 8
     levels, no consumption clamp, the cost on d); K5 on its split schedule
     (the cluster size the library reports against the rule), a pair alone
     equal to it in its tile, its block schedule (unaligned y) within the
     limit too; K6 == K7 bit for bit, each repeating itself; one pair against
     the exact optimum (scipy's linear_sum_assignment); times, bounds and
     twin times at a full eval tile (64 pairs), K5's split and block
     schedules in both units.
 19. (after 16) The eval path at full width on 64 references and 64
     samples of 2048 points: `compute_all_metrics(smp, ref, 128)` (pairs/s),
     `compute_CD_metrics(smp, ref, 256)`, `EMD_CD` through K7, the JSD, the
     phase-16 stage-1 trainer's `reconstruction` and `valsample` on a test
     loader of 4 batches of 16, and a stage-2 `valsample` (one batch, 32
     steps); K5/K6/K7 launch counts against those `_tile_shape` predicts
     (every K5 launch on its split schedule, every K6/K7 one on the cluster
     schedule); one matrix's tiles under torch.profiler.
 20. (after 17) 8 x 8 pairs, card against CPU: the CD and EMD matrices of
     `compute_all_metrics` (and against a card run with wrong kernels), the
     metric dicts on sets with margin, and the JSD.

The training entries (`ldt_torch.entries`), from config files:
 21. (last) Config files copied from experiments/Compressor_Trainer/airplane
     and experiments/Latent_Diffusion_Trainer/airplane (the models at full
     width and depth; the epochs, the save / eval / log cadences, the data
     and the stage-2 eval's sample_N cut, each cut printed) and a synthetic
     PC15k tree of 64 train and 16 val clouds: `train_compressor` for 2
     epochs (B=16, a save each, one reconstruction eval),
     `train_latent_diffusion` through `load_pretrain` from stage 1's `.pt`
     for 2 epochs (B=64, one save of f32 params and EMA and bf16 moments,
     one `valsample`), a `--resume True` leg that trains epoch 3, and
     `val_sample` on the saved samples. The restored tensors must equal the
     state at the save (the moments their bf16 rounding) with the counters
     continuing, training.csv must gain the leg's row, every loss and
     metric must be finite and K1-K6 must have run; prints seconds per
     epoch and the checkpoint's save and load seconds and GB. The tree and
     the checkpoints are deleted at the end, pass or fail.

The reference's head merge and the 55-category configs:
 22. (last) a) The flagship Score cut to 2 blocks (hidden 1024, 16 heads)
     and the full 6-block decoder, bf16, built with `ref_merge=True` on
     random weights from the seed: a 32-step sampler run and the decode of
     N(0, 1) latents through K1 and K2 against the plain attention with the
     same merge and against the standard merge (`MERGE_TOL`); then phases
     14 and 17's f32 train steps (K1-K3, K2 + K4) with both nets merged as
     the reference does, card vs CPU, the standard merge as the wrong
     variant. b) The configs of experiments/Compressor_Trainer/all and
     experiments/Latent_Diffusion_Trainer/all (55 categories, class
     conditioning, full width and depth; epochs, cadences and the stage-2
     eval's sample_N cut, each cut printed) on a synthetic PC15k tree of
     three synsets (airplane, car, chair = category 14, the config's
     val_cate): `train_compressor` (B=16, labels) with a save and a resume
     leg that runs one `reconstruction` at val_cate, then
     `train_latent_diffusion` through `load_pretrain` (B=32, labels) with a
     save and a resume leg that runs one `valsample` at val_cate. Finite
     logs and metrics, the label tables' rows of the data's categories (and
     no other) moved by Adam, K1-K5 run; seconds per epoch, checkpoint
     sizes. c) `Trainer.sample(32, label=14)` of that stage-2 trainer with
     the full 1000 steps: the whole f32 Score each step (no hoisted
     modulations), launch counts K1 24 x 1000 and K2 6; clouds/min with
     the card's name and power limit.

ViPC completion (the conditional Score, its ConditionNet, the completion
trainers and entries):
 23. (last) a) K2 (whole-set, dh 64) and K4 (register-tiled long-query, one
     tile of 32 rows) at the DiT's cross-attention shape (q, k, v [32, 32,
     1024], 16 heads, f32) against their twins on the card and on the CPU,
     f64 products and wrong variants, each repeating its bits; timed by
     the event loop and by device time beside the bound, the twin and SDPA
     (forward; backward). b) The conditional Score at flagship width cut
     to 2 blocks and its ConditionNet (64 x 64 views, 2048-point partial
     clouds), f32, card (cuDNN's global TF32 on) vs CPU, same weights
     through `ldt_torch.weights`: the condition's tokens and embedding, the
     Score's output and one completion train step (loss, gradients,
     params, EMA, Adam's mu, BatchNorm statistics); the wrong variant runs
     the trunk in TF32. c) The completion entries from
     experiments/*/completion/plane (full width and depth; epochs,
     cadences, the stage-2 eval's sample_N and the data cut, each cut
     printed) on a synthetic ViPC tree written here
     (`ldt_torch.tools.synth_vipc`: 32 train and 16 test planes x 24 RGBA
     137 x 137 views, resized by the loader): stage 1 from a stage-1
     checkpoint written here, 2 epochs with a save and a reconstruction,
     a resume leg; stage 2 from stage 1's checkpoint through
     `load_pretrain`, 2 epochs with a save and a valsample, a resume leg;
     restored tensors equal to the saved state, counters continued, finite
     logs and scores, K1-K4 run; seconds per epoch, checkpoint sizes and
     save and load seconds. d) `Trainer.sample(32, condition=...)` with the
     config's 1000 steps: the trunk run once, launches K1 12 x 1000
     (register-tiled), K2 12 x 1000 + 6; clouds/min with the card's name
     and power limit; CD x 1000 and F1 against the batch's GT.

Stage 3, the Hybrid finetune (`ldt_torch.training.hybrid_trainer`, the
entry `train_hybrid`) and the SDE families' importance sampling:
 24. (last) a) The flagship Score cut to 2 blocks and the full 6-layer
     Compressor, f32, B=4, the same weights, clouds and pinned draws on the
     card and on the CPU: one `hybrid_comp_loss` (loss, kl, rec, eps, every
     Compressor gradient; the Score's parameters unchanged and without a
     gradient, K1 and K3 on their register-tiled kernels), then one whole
     `update` (both nets, the EMA, both Adam mus, the BatchNorm
     statistics); the wrong variant leaves the Score live in the KL term
     with its gradient reaching the score step. `iw_quantities` of every
     SDE family and mode, card vs CPU on the same rho. b) The entry from a
     copy of experiments/Hybrid_Trainer/airplane (full width and depth,
     B=32; epochs, cadences, the valsample's sample_N and the data cut,
     each cut printed) on phase 21's synthetic tree, bootstrapped through
     `load_pretrain` from a stage-2 dual checkpoint written here as a JAX
     `.msgpack`: 2 epochs with a save and a `valsample`, one `valrecon`, a
     `--resume` leg that trains epoch 3; restored tensors equal to the
     saved state, counters continued, finite logs and scores, K1 f32 48 and
     K3 48 a step, K2 and K4 as a stage-1 step; ms per step, seconds per
     epoch, the checkpoint's size, save and load seconds.

The training options (`opt.moment_dtype`, `common.train_dtype`, the
Score's dropout):
 25. (last) a) The shipped `airplane_synth_mbf16` config (bf16 Adam
     moments) and its f32 control `airplane_synth_m32ctl` through
     `train_latent_diffusion` at full width and depth (457M Score, B=64)
     on phase 21's tree, from a stage-1 checkpoint written here: 3 epochs
     with a save, a resume leg; live moments bf16 (f32 in the control),
     the optimizer state's bytes (half the control's), both legs' peak
     memory, the losses within MOMENT_LOSS_REL; each config's checkpoint
     restored into the other's trainer. b) `common.train_dtype: bfloat16`
     added to copies of the airplane configs: 10 stage-2 steps (B=64), 10
     stage-1 steps (B=16), 2 hybrid steps (B=32), each launch's dtype
     counted (K1 24 on its bf16 tensor-core schedule, K3 24, K2 24 a
     stage-2 step; K2, K4 24 a stage-1 step; K1, K3 48 and K2, K4 24 a
     hybrid step), every parameter, EMA, moment and gradient f32; the wrong
     variant (a Dense casting to its f32 weight) fails the count; median ms
     a step beside the f32 steps of the same configs; 4 stage-2 steps of
     each dtype profiled by class with `ldt_torch.tools.profiling`; a
     2-block step card vs CPU within MP_STEP_TOL (wrong: K3 with dq and dk
     swapped). c) A flagship stage-2 step with `score.dropout` 0.1: the
     same seed gives the same step bit for bit, another draw seed another;
     the kept share within 5 binomial sigmas of 0.9; `val_loss` and a
     32-step `sample(8)` equal the rate-0 ones on the same weights; a
     Compressor's training forward and a conditional Score's training step
     with dropout raise.

The last two lines of standard output before the final one are the kernel
table (JSON) and the card's `nvidia-smi` name and power limit; the final line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import subprocess
import sys
import time
from unittest import mock

# H100 SXM data-sheet peaks (dense): device memory 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s, int8 1979 TOP/s; f32 outside the tensor cores 67
# TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
# Every limit below is read in each run against the value it holds the
# port to, against right answers that round elsewhere ("f64": the plain
# attention with f64 products, the weights rounded to the input dtype as the
# kernels round them; "cpu twin"; "card"), and against wrong ones ("wrong":
# the weights rounded to the other dtype before AV, the slip of a kernel
# template: unrounded in bf16, rounded to bf16 in f32; "kv swapped": keys
# and values exchanged, a wiring slip). The right readings must pass and the
# wrong ones named beside each limit must fail, or the run fails. Each limit
# sits between the two (PERF.md keeps the readings).
# Phase 2, kernel vs plain twin on the same inputs: (max, mean) of
# |kernel - twin| over the output. The mean tells the rounding slip in bf16:
# a right answer's bf16 outputs differ by rare one-ulp flips.
KERNEL_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (8e-3, 1e-5)}
# Phase 3, kernels vs plain attention through the bf16 networks: (max,
# mean) relative to the largest |value| of the plain run, and the readings
# that must fail. In the chaotic random-weight sampler any other rounding of
# the attention, right or wrong, moves the latents alike, so there only the
# wiring slip can be told; the decoder, on N(0, 1) latents, tells both.
PATH_TOL = {"sampler": ((5e-3, 5e-4), ("kv swapped",)),
            "decoder": ((1e-2, 6e-5), ("wrong", "kv swapped"))}
# Phase 22a, the bf16 path with the reference's head merge, kernels vs the
# plain attention with the same merge, (max, mean) relative: phase 3's
# sampler limit for both halves. Under that merge a decoder point's next
# state takes the attention rows of 4 other points (the [B, H, N, dh] ->
# [B, N, D] reshape), so each bf16 rounding flip spreads over the set as it
# does over the sampler's steps (read on the H100: decoder 3.8e-3 /
# 2.4e-4, beyond phase 3's decoder mean of 6e-5; sampler 1.1e-3 / 1.6e-5).
# Wrong: "standard merge", the same weights merged the standard way
# (decoder 0.32 / 6.7e-2; the sampler's 4.4e-3 / 6.8e-4 is printed only).
MERGE_TOL = PATH_TOL["sampler"][0]
# Phase 6, card vs CPU in f32, (max, mean) relative to the largest |value|,
# for the sampler and the decoder: the sums run in other orders.
REF_TOL = {"sampler": (1e-5, 1.2e-7), "decoder": (1e-5, 2e-6)}
# Phase 7, K8 vs its twin, (max, mean) of |kernel - twin|, f32 and bf16:
# a right answer differs only where exp or the row sum rounds a weight code
# to its neighbour, moving one (element, row, head) slice by at most one v
# code step (max|v| / 127, ~0.04 for N(0, 1) inputs) plus an output ulp.
# Wrong: "E=1" (scales per batch element, not per group of 4), "w
# unquantized" (f32 weights into AV), "kv swapped".
K8_TOL = (0.08, 1e-5)
# Phase 11, one int8 step at flagship width (two blocks, bf16, K8), card vs
# CPU, (max, mean) relative to the largest |value|: the bf16 GEMMs and the
# LayerNorm sums round differently on the two devices, and an int8 code
# downstream can follow (read 6.1e-3 / 6.1e-5). Wrong: "E=1" (K8's scales
# per batch element, 6.1e-3 / 2.7e-4), "bf16 weights" (no weight
# quantization, 6.1e-3 / 3.2e-4), "kv swapped". The mean tells them apart.
INT8_STEP_TOL = (1e-2, 1.3e-4)
# Phase 12, K3 vs its plain twin, (max, mean) of |kernel - twin| relative to
# the largest |twin|: in f32 the sums run in other orders; in bf16 a ds or
# gradient element can round to its neighbour (one bf16 ulp, 2^-8 of its
# value). Wrong: "no rowsum" (ds = w * dw), "dv unrounded" (bf16: dv from
# the f32 weights, read 4.4e-3 / 3.1e-5 against a right 1.1e-3 / 1.1e-8:
# the mean tells them apart), "dq dk swapped".
K3_TOL = {"float32": (1e-5, 1e-7), "bfloat16": (8e-3, 1e-5)}
# Phase 12, K2's long-key schedule (M=2048): phase 2's limits (the outputs
# are means over 2048 values, so |out| is smaller and the same limits
# stricter; right readings 8.9e-7 / 2.1e-8 in f32, 4.9e-4 / 6.6e-8 in bf16;
# the weights rounded in the wrong dtype read 1.8e-3 / 4.8e-5 in f32 and
# 9.8e-4 / 4.9e-5 in bf16, and fail).
# Phase 14, one train step, card vs CPU, (max, mean) relative to the largest
# |value| of each of loss, gradients, params, EMA and Adam's mu: f32 GEMMs
# and sums in other orders (gradients read 1.5e-5 / 1.1e-8). Wrong: "dq dk
# swapped" (K3's dq and dk exchanged: gradients 1.5e-3 / 1.3e-5; at the
# first step's warm-up lr it cannot move the params past the limit).
TRAIN_STEP_TOL = (1e-4, 1e-6)
# Phase 23b, one completion train step (the conditional Score and its
# ConditionNet), card vs CPU, the gradients and Adam's mu, (max, mean)
# relative to the largest |value|: the f32 GEMMs of the Score's head and
# MLPs sum in other orders (read on the H100: 2.3e-4 / 6.5e-7, the largest
# difference 4.2e-6 in ln_out's weight against a largest gradient of
# 1.9e-2, smaller than phase 14's because the completion loss's gradients
# are). Wrong: "tf32 trunk" (the trunk's convolutions in TF32, which moves
# the image embedding and so every gradient: 1.7e-2 / 9.9e-6). The other
# parts keep TRAIN_STEP_TOL.
COND_STEP_TOL = (1e-3, 1e-6)
# Phase 15, K4 vs its twin, (max, mean) of |kernel - twin| relative to the
# largest |twin|, the largest over dq, dk and dv, at the three shapes: in f32
# the dk and dv sums over 2048 query rows (and the long-key schedule's
# softmax sums) run in other orders (right readings up to 2.5e-6 / 1.2e-7);
# in bf16 a rounded w, ds or gradient can land one ulp away (up to 3.0e-3 /
# 5.4e-7). Wrong: "no rowsum", "dk dv swapped", "dq dk swapped" (N = M),
# "one dk/dv partial tile dropped" (the long-query reduction), all >= 0.2 /
# 1.1e-2; bf16 "ds from rounded w" 3.2e-3-7.8e-3 / 1.9e-4-3.8e-4: the mean
# tells it.
K4_TOL = {"float32": (1e-5, 1e-6), "bfloat16": (8e-3, 1e-5)}
# Phase 18, K5 vs its twin, (max, mean) over pairs of |kernel - twin| /
# |twin|: the minima have the twin's bits (the same direct-form roundings),
# only the means' sums run in another order (read on the H100: 2.3e-7 /
# 4.9e-8, card and CPU twins). Wrong: "one direction" (2 mean dist1: 0.35 /
# 0.10), "on sqrt d" (the means of sqrt(dist)), "one row tile's column
# minima dropped" (the split schedule's merge losing a block of the
# cluster).
K5_TOL = (1e-5, 1e-6)
# Phase 18, K6/K7 vs their twin, the same readings: sums over 2048 rows and
# columns in another order through nine levels (read on the H100: twin
# 2.5e-6 / 1.7e-7, CPU twin 4.5e-6 / 5.4e-7, f64 6.9e-6 / 3.5e-7). Wrong:
# "8 levels" (-4^-1 dropped: 6.1e-3 / 1.9e-3; ~2e-6 on a jittered copy
# alone), "no clamp" (the consumption min(., 1) dropped: 0.72 / 0.47),
# "cost on d" (sum match d, not sqrt(d)). Phase 20 holds the card's CD and
# EMD matrices to the CPU's with K5_TOL and K6_TOL.
K6_TOL = (3e-5, 2e-6)
# The kernel each schedule of K1 launches, as torch.profiler names it.
K1_KERNELS = {"mma": "packed_self_attention_mma_kernel",
              "tiled": "packed_self_attention_tiled_kernel",
              "fma": "packed_self_attention_kernel<"}
EVAL_PAIRS = 32    # phase 18's pairs
EVAL_SET = 64      # phase 19's references and samples
EVAL_POINTS = 2048  # points per cloud in phases 18-20 (the eval's)
TRAIN_STEPS = 10   # timed flagship train steps (phases 13, 16)
STAGE1_BATCH = 16  # the stage-1 config's batch (phase 15's K4 shapes)
BATCH = 64         # clouds per generation, as bench.py
STEPS = 1000       # ancestral steps of the main path
CHECK_STEPS = 32   # phases 3, 5 and 6 (beta_end / N must stay below 1)
SEED = 0


def synthetic_shapes(count: int, points: int, rng):
    """[count, points, 3] float32 clouds at ShapeNet's scale, from a numpy
    Generator: surface points of random ellipsoids and boxes (alternating),
    randomly rotated, centred and scaled to unit max radius (the
    normalization of ldt_tpu/tools/utils.py::normalize_point_clouds)."""
    import numpy as np

    out = np.empty((count, points, 3), np.float64)
    for k in range(count):
        axes = rng.uniform(0.2, 1.0, 3)
        if k % 2 == 0:  # ellipsoid: unit directions scaled by the semi-axes
            v = rng.standard_normal((points, 3))
            pts = v / np.linalg.norm(v, axis=1, keepdims=True) * axes
        else:  # box: a face by its area, then a point on it
            area = np.array([axes[1] * axes[2], axes[0] * axes[2],
                             axes[0] * axes[1]])
            face = rng.choice(3, points, p=area / area.sum())
            pts = rng.uniform(-1.0, 1.0, (points, 3)) * axes
            pts[np.arange(points), face] = rng.choice([-1.0, 1.0],
                                                      points) * axes[face]
        q, r = np.linalg.qr(rng.standard_normal((3, 3)))
        pts = pts @ (q * np.sign(np.diag(r)))
        pts -= pts.mean(axis=0)
        out[k] = pts / np.linalg.norm(pts, axis=1).max()
    return out.astype(np.float32)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def smi_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from ldt_torch.ops import _build, _eval_kernels
    from ldt_torch.ops import attention as attn_ops

    sources = ("attention", "eval")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    attn_ops._lib()
    _eval_kernels.lib()
    dt = time.perf_counter() - t0
    print(f"[1] build: {dt:.3f} s (" + ", ".join(
        f"{k} {'cached' if v is None else 'compiled'}"
        for k, v in logs.items()) + ")")
    for name, log in logs.items():
        for line in (log or "").splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warning")):
                print(f"    nvcc {name}: {line.strip()}")


def _bound(nbytes: int, ops: dict):
    """(ms, "bytes" or "operations"): the bytes over the memory rate
    against `ops` {type: count} over each type's peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[t] for t, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_variant(q, k, v, num_heads: int, acc, weights):
    """The attention of `ops.attention.attention_plain` with the products
    in `acc` and the weights rounded to `weights` before AV: the "f64" and
    "wrong" readings of the checks (see the limits above)."""
    b, n, d = q.shape
    dh = d // num_heads

    def heads(t):
        return t.reshape(b, t.shape[1], num_heads, dh).transpose(1, 2).to(acc)

    s = heads(q) @ heads(k).transpose(-1, -2) * dh ** -0.5
    w = s.softmax(dim=-1).to(weights).to(acc)
    return (w @ heads(v)).transpose(1, 2).reshape(b, n, d).to(q.dtype)


def variants(dtype):
    """{reading: (products dtype, weights dtype)} for inputs of `dtype`."""
    import torch

    wrong = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    return {"f64": (torch.float64, dtype), "wrong": (torch.float32, wrong)}


def attention_patches(acc, weights, swap_kv: bool = False):
    """Patches that route the model's attention through a variant; with
    `swap_kv` the keys and values change places (a wiring slip)."""
    from ldt_torch.ops import attention as attn_ops

    def cross(q, k, v, h):
        if swap_kv:
            k, v = v, k
        return attention_variant(q, k, v, h, acc, weights)

    def self_attn(qkv, h):
        d = qkv.shape[-1] // 3
        return cross(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], h)

    return (mock.patch.object(attn_ops, "packed_self_attention", self_attn),
            mock.patch.object(attn_ops, "cross_attention", cross))


def errs(got, want, rel: bool = False):
    """(max, mean) of |got - want|, relative to max |want| if `rel`."""
    diff = (got.float().cpu() - want.float().cpu()).abs()
    scale = want.float().abs().max().item() if rel else 1.0
    return diff.max().item() / scale, diff.mean().item() / scale


def held(name: str, readings: dict, tol, right=("twin", "f64"),
         wrong=("wrong",)) -> None:
    """Fail unless the `right` readings pass `tol` (max, mean) and the
    `wrong` ones fail it; any other reading is printed only."""
    def ok(r):
        return r[0] <= tol[0] and r[1] <= tol[1]

    text = ", ".join(f"{k} {r[0]:.3e}/{r[1]:.3e}" for k, r in readings.items())
    print(f"    {name}: max/mean {text} (tol {tol[0]:g}/{tol[1]:g})")
    for k in right:
        if not ok(readings[k]):
            fail(f"{name}: {k} reading {readings[k]} exceeds {tol}")
    for k in wrong:
        if ok(readings[k]):
            fail(f"{name}: the {k} reading {readings[k]} passes {tol}: "
                 "the limit cannot tell a wrong kernel")


def phase_kernels(batch: int, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from ldt_torch.ops import attention as attn_ops

    n, d, h = 32, 1024, 16            # DiT self-attention (score_cfg)
    nq, m, dc, hc = 2048, 32, 128, 4  # decoder cross-attention
    rows, f32_rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        qkv = torch.randn(batch, n, 3 * d, device="cuda", dtype=dtype,
                          generator=gen)
        q = torch.randn(batch, nq, dc, device="cuda", dtype=dtype,
                        generator=gen)
        k = torch.randn(batch, m, dc, device="cuda", dtype=dtype,
                        generator=gen)
        v = torch.randn(batch, m, dc, device="cuda", dtype=dtype,
                        generator=gen)

        def heads(t, hh):
            return t.unflatten(-1, (hh, -1)).transpose(1, 2)

        cases = {
            "packed_self_attention": dict(
                kernel=lambda: attn_ops.packed_self_attention(qkv, h),
                plain=lambda: attn_ops.packed_self_attention_plain(qkv, h),
                plain_cpu=lambda: attn_ops.packed_self_attention_plain(
                    qkv.cpu(), h),
                variant=lambda acc, w: attention_variant(
                    qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], h,
                    acc, w),
                library=lambda: F.scaled_dot_product_attention(
                    heads(qkv[..., :d], h), heads(qkv[..., d:2 * d], h),
                    heads(qkv[..., 2 * d:], h)),
                nbytes=qkv.numel() * qkv.element_size()
                + batch * n * d * qkv.element_size(),
                flops=batch * h * (4 * n * n * (d // h) + 5 * n * n),
                shape=f"qkv {list(qkv.shape)}, H={h}",
                source="ldt_torch/csrc/attention.cu",
                replaces="ldt_tpu/ops/pallas_attention.py:214"),
            "cross_attention": dict(
                kernel=lambda: attn_ops.cross_attention(q, k, v, hc),
                plain=lambda: attn_ops.attention_plain(q, k, v, hc),
                plain_cpu=lambda: attn_ops.attention_plain(
                    q.cpu(), k.cpu(), v.cpu(), hc),
                variant=lambda acc, w: attention_variant(q, k, v, hc, acc, w),
                library=lambda: F.scaled_dot_product_attention(
                    heads(q, hc), heads(k, hc), heads(v, hc)),
                nbytes=(2 * q.numel() + k.numel() + v.numel())
                * q.element_size(),
                flops=batch * hc * (4 * nq * m * (dc // hc) + 5 * nq * m),
                shape=f"q {list(q.shape)}, k/v {list(k.shape)}, H={hc}",
                source="ldt_torch/csrc/attention.cu",
                replaces="ldt_tpu/ops/pallas_attention.py:49"),
        }
        schedules = {
            "packed_self_attention": attn_ops.packed_schedule(n, d // h,
                                                              dtype),
            "cross_attention": attn_ops.cross_schedule(nq, m, dc // hc)}
        for name, c in cases.items():
            before = k1_schedule_counts()
            got = c["kernel"]()
            if not torch.equal(got, c["kernel"]()):
                fail(f"phase 2: {name} ({dn}) did not repeat its bits")
            if name == "packed_self_attention" and \
                    k1_schedule_counts() != k1_schedule_counts(
                        before, schedules[name], 2):
                fail(f"phase 2: K1 ({dn}) did not take the "
                     f"{schedules[name]} schedule")
            readings = {"twin": errs(got, c["plain"]()),
                        "cpu twin": errs(got, c["plain_cpu"]())}
            for vname, (acc, w) in variants(dtype).items():
                readings[vname] = errs(got, c["variant"](acc, w))
            err = readings["twin"][0]
            # `ms` and `library_ms`: the event loop over back-to-back calls,
            # the wrapper's host work included (K1's is more than its
            # device time); `device_ms` and `library_device_ms`: the
            # device time per call alone, from torch.profiler
            ms = cuda_ms(c["kernel"])
            plain_ms = cuda_ms(c["plain"], iters=20)
            library_ms = cuda_ms(c["library"])
            parts = launch_us(c["kernel"], 100)
            device_ms = sum(parts.values()) / 1e3
            library_device_ms = sum(launch_us(c["library"],
                                              100).values()) / 1e3
            bound_ms, bound_by = _bound(c["nbytes"], {dn: c["flops"]})
            print(f"[2] {name} {dn} {c['shape']} ({schedules[name]} "
                  f"schedule): max_abs_err {err:.3e}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {c['nbytes'] / 1e6:.1f} MB, "
                  f"{c['flops'] / 1e9:.3f} GFLOP)")
            print(f"    device time per call: kernel {device_ms:.4f} ms ("
                  + ", ".join(f"{k} {us:.2f} us" for k, us in parts.items())
                  + f"), sdpa {library_device_ms:.4f} ms")
            row = {"name": name, "route": "cuda", "source": c["source"],
                   "replaces": c["replaces"], "launches": 0,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library_ms, "device_ms": device_ms,
                   "library_device_ms": library_device_ms}
            if name == "packed_self_attention":
                # the schedule the library launched, seen by the profiler
                names = " ".join(parts)
                if any((kernel in names) != (sched == schedules[name])
                       for sched, kernel in K1_KERNELS.items()):
                    fail(f"phase 2: K1 ({dn}) launched {list(parts)}, not "
                         f"the {schedules[name]} schedule")
                if schedules[name] != "fma":
                    row.update(k1_cuda_cores(qkv, h, dn, got,
                                             schedules[name]))
            held(f"{name} {dn} vs", readings, KERNEL_TOL[dn],
                 right=("twin", "cpu twin", "f64"))
            if dtype == torch.bfloat16:  # the main path's dtype
                rows[name] = row
            else:
                f32_rows[name] = row
    # K1 at f32 is the stage-2 train step's: its numbers ride in K1's row
    rows["packed_self_attention"]["float32"] = {
        k: v for k, v in f32_rows["packed_self_attention"].items()
        if k.endswith("ms") or k in ("max_abs_err", "bound_by")}
    return rows


def unaligned_copy(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary: K1 and K8 then take their earlier kernels (their rules)."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = flat[1:].view(t.shape)
    off.copy_(t)
    return off


def k1_schedule_counts(before=None, schedule=None, calls=0) -> tuple:
    """K1's (launches, tensor-core, register-tiled) counts now, or, given
    `before`, what they must read after `calls` calls on `schedule`."""
    from ldt_torch.ops import attention as attn_ops

    if before is None:
        fn = attn_ops.packed_self_attention
        return fn.launches, fn.mma_launches, fn.tiled_launches
    return (before[0] + calls, before[1] + calls * (schedule == "mma"),
            before[2] + calls * (schedule == "tiled"))


def k1_cuda_cores(qkv, h: int, dn: str, got, schedule: str) -> dict:
    """K1's first CUDA-core kernel at the shape where `schedule` ran, for the
    before and after in one run: an unaligned copy of qkv takes it (the
    rule). Held against the twin, and equal to `got` bit for bit where the
    new schedule is the register-tiled one (the same f32 FMA chains); timed
    by the event loop and by the profiler, as phase 2 times the kernel."""
    import torch

    from ldt_torch.ops import attention as attn_ops

    off = unaligned_copy(qkv)
    fn = attn_ops.packed_self_attention
    before = k1_schedule_counts()
    old = fn(off, h)
    parts = launch_us(lambda: fn(off, h), 100)
    if k1_schedule_counts() != k1_schedule_counts(before, "fma", 102) or \
            K1_KERNELS["fma"] not in " ".join(parts):
        fail(f"phase 2: the unaligned K1 copy ({dn}) did not take the first "
             f"CUDA-core kernel: {list(parts)}")
    if not torch.equal(old, fn(off, h)):
        fail(f"phase 2: K1's CUDA-core kernel ({dn}) did not repeat its bits")
    if schedule == "tiled" and not torch.equal(got, old):
        fail("phase 2: K1's register-tiled schedule and the CUDA-core kernel "
             f"differ (max {errs(got, old)[0]:.3e})")
    err = errs(old, attn_ops.packed_self_attention_plain(qkv, h))
    out = {"fma_ms": cuda_ms(lambda: fn(off, h)),
           "fma_device_ms": sum(parts.values()) / 1e3}
    print(f"    the first CUDA-core kernel at this shape (unaligned copy): "
          f"max_abs_err {err[0]:.3e}, kernel {out['fma_ms']:.4f} ms, device "
          f"time per call {out['fma_device_ms']:.4f} ms"
          + ("; == the register-tiled schedule bit for bit"
             if schedule == "tiled" else ""))
    held(f"packed_self_attention {dn} first CUDA-core kernel vs",
         {"twin": err},
         KERNEL_TOL[dn], right=("twin",), wrong=())
    return out


def k8_weights_unquantized(qkv, num_heads: int, elems: int = 4):
    """K8's twin with the f32 softmax weights in the AV product instead of
    their codes / 127: a wrong variant of phase 7."""
    import torch

    from ldt_torch.ops import attention as attn_ops

    b, n, d3 = qkv.shape
    dh = d3 // 3 // num_heads
    x = qkv.float().reshape(b // elems, elems, n, 3, num_heads, dh)
    x = x.permute(0, 3, 1, 4, 2, 5)
    s = attn_ops.true_divide(x.abs().amax(dim=(2, 3, 4, 5), keepdim=True),
                             127.0) + 1e-20
    q8, k8, v8 = (attn_ops._int8_codes(x[:, i], s[:, i]) for i in range(3))
    w = attn_ops._softmax_rows(torch.matmul(q8, k8.transpose(-1, -2)).float()
                               * ((s[:, 0] * s[:, 1]) * dh ** -0.5))
    out = torch.matmul(w.double(), v8).float() * s[:, 2]
    return out.permute(0, 1, 3, 2, 4).reshape(b, n, d3 // 3).to(qkv.dtype)


def phase_k8(batch: int, gen) -> dict:
    import torch

    from ldt_torch.ops import attention as attn_ops

    n, d, h = 32, 1024, 16            # DiT self-attention (score_cfg)
    dh = d // h
    row = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        qkv = torch.randn(batch, n, 3 * d, device="cuda", dtype=dtype,
                          generator=gen)
        swapped = torch.cat([qkv[..., :d], qkv[..., 2 * d:],
                             qkv[..., d:2 * d]], dim=-1).contiguous()

        def kernel():
            return attn_ops.packed_self_attention_int8(qkv, h)

        def plain():
            return attn_ops.packed_self_attention_int8_plain(qkv, h)

        mma = attn_ops.packed_self_attention_int8.mma_launches
        got = kernel()
        if attn_ops.packed_self_attention_int8.mma_launches - mma != 1:
            fail(f"phase 7: K8 ({dn}) did not take the int8 tensor cores")
        if not torch.equal(got, kernel()):
            fail(f"phase 7: K8 ({dn}) did not repeat its bits")
        readings = {
            "twin": errs(got, plain()),
            "cpu twin": errs(got, attn_ops.packed_self_attention_int8_plain(
                qkv.cpu(), h)),
            "E=1": errs(got, attn_ops.packed_self_attention_int8_plain(
                qkv, h, 1)),
            "w unquantized": errs(got, k8_weights_unquantized(qkv, h)),
            "kv swapped": errs(got, attn_ops.packed_self_attention_int8_plain(
                swapped, h))}
        diff = (got.float() - plain().float()).abs().reshape(batch, n, h, dh)
        flips = int((diff.amax(dim=-1) > 0).sum())
        step = qkv[..., 2 * d:].float().abs().amax().item() / 127
        ms = cuda_ms(kernel)
        plain_ms = cuda_ms(plain, iters=20)
        parts = launch_us(kernel, 100)
        device_ms = sum(parts.values()) / 1e3
        if "packed_self_attention_int8_mma_kernel" not in " ".join(parts):
            fail(f"phase 7: K8 ({dn}) launched {list(parts)}, not the int8 "
                 "tensor cores")
        # the CUDA-core kernels at this shape, through an unaligned copy
        off = unaligned_copy(qkv)
        mma = attn_ops.packed_self_attention_int8.mma_launches
        old = attn_ops.packed_self_attention_int8(off, h)
        old_parts = launch_us(
            lambda: attn_ops.packed_self_attention_int8(off, h), 100)
        if attn_ops.packed_self_attention_int8.mma_launches != mma or \
                "int8_mma" in " ".join(old_parts):
            fail(f"phase 7: the unaligned K8 copy ({dn}) took the tensor "
                 "cores")
        if not torch.equal(got, old):
            fail(f"phase 7: K8's tensor-core schedule and the CUDA-core "
                 f"kernels differ ({dn}, max {errs(got, old)[0]:.3e})")
        fma_ms = cuda_ms(lambda: attn_ops.packed_self_attention_int8(off, h))
        fma_device_ms = sum(old_parts.values()) / 1e3
        nbytes = qkv.numel() * qkv.element_size() \
            + batch * n * d * qkv.element_size()
        ops = {"int8": batch * h * 4 * n * n * dh,
               "float32": batch * h * (5 * n * n + 9 * n * dh)}
        bound_ms, bound_by = _bound(nbytes, ops)
        print(f"[7] packed_self_attention_int8 (K8) {dn} qkv "
              f"{list(qkv.shape)}, H={h}, E=4: max_abs_err "
              f"{readings['twin'][0]:.3e}, (element, row, head) slices off "
              f"the twin {flips} of {batch * n * h} (v code step "
              f"{step:.4f}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{ops['int8'] / 1e9:.3f} G int8 ops, "
              f"{ops['float32'] / 1e9:.3f} GFLOP f32); library: none")
        print(f"    device time per call: kernel {device_ms:.4f} ms ("
              + ", ".join(f"{k} {us:.2f} us" for k, us in parts.items())
              + f"); the CUDA-core kernels (unaligned copy, == the tensor "
              f"cores bit for bit) {fma_ms:.4f} ms, device "
              f"{fma_device_ms:.4f} ms ("
              + ", ".join(f"{k} {us:.2f} us" for k, us in old_parts.items())
              + ")")
        held(f"K8 {dn} vs", readings, K8_TOL, right=("twin", "cpu twin"),
             wrong=("E=1", "w unquantized", "kv swapped"))
        if dtype == torch.bfloat16:  # the main path's dtype
            row = {"packed_self_attention_int8": {
                "name": "packed_self_attention_int8", "route": "cuda",
                "source": "ldt_torch/csrc/attention.cu",
                "replaces": "ldt_tpu/ops/pallas_attention.py:253",
                "launches": 0, "max_abs_err": readings["twin"][0], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "device_ms": device_ms, "fma_ms": fma_ms,
                "fma_device_ms": fma_device_ms}}
    return row


def phase_int8_gemms(gen) -> None:
    """The four GEMMs of an int8 block at M = 2048 (B=64 x 32 tokens)."""
    import torch

    from ldt_torch.serving import int8 as int8_serving

    m = 2048
    for k, n in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)):
        x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
        w_i8, w_s = int8_serving.quantize_weight(w)
        x_i8 = torch.clamp(torch.round(x.float() * 40), -127, 127).to(
            torch.int8)
        w_bf16 = w.bfloat16().t()
        got = int8_serving.int8_matmul(x[:256], w_i8, w_s)
        want = int8_serving.int8_matmul(
            x[:256].cpu(), *int8_serving.quantize_weight(w.cpu()))
        if not torch.equal(got.cpu(), want):
            fail(f"int8_matmul [{m}, {k}] x [{k}, {n}]: card and CPU differ "
                 f"(max {errs(got, want)[0]:.3e})")
        int_mm = cuda_ms(lambda: torch._int_mm(x_i8, w_i8.t()))
        whole = cuda_ms(lambda: int8_serving.int8_matmul(x, w_i8, w_s))
        bf16 = cuda_ms(lambda: x @ w_bf16)
        int8_bound, _ = _bound(m * k + n * k + 4 * m * n,
                               {"int8": 2 * m * k * n})
        bf16_bound, _ = _bound(2 * (m * k + n * k + m * n),
                               {"bfloat16": 2 * m * k * n})
        print(f"[8] GEMM M={m} K={k} N={n}: _int_mm {int_mm:.4f} ms "
              f"(bound {int8_bound:.4f}), int8_matmul (dynamic quantize + "
              f"_int_mm + dequantize) {whole:.4f} ms, bf16 matmul "
              f"{bf16:.4f} ms (bound {bf16_bound:.4f}); int8_matmul card == "
              "CPU bit for bit on 256 rows")


def k3_variant(qkv, g, num_heads: int, acc=None, rowsum: bool = True,
               round_dv: bool = True, swap_dq_dk: bool = False):
    """K3's plain twin with its products in `acc` (the "f64" reading) or one
    step changed (the wrong readings of phases 12 and 14)."""
    import torch

    b, n, d3 = qkv.shape
    d = d3 // 3
    dh = d // num_heads
    scale = dh ** -0.5
    dt, acc = qkv.dtype, acc or torch.float32

    def heads(t):
        return t.reshape(b, n, num_heads, dh).transpose(1, 2).to(acc)

    q, k, v = (heads(qkv[..., i * d:(i + 1) * d]) for i in range(3))
    gh = heads(g)
    w = (q @ k.transpose(-1, -2) * scale).softmax(dim=-1)
    dv = (w.to(dt).to(acc) if round_dv else w).transpose(-1, -2) @ gh
    dw = gh @ v.transpose(-1, -2)
    ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True)) if rowsum else w * dw
    ds = ds.to(dt).to(acc)
    dq = ds @ k * scale
    dk = ds.transpose(-1, -2) @ q * scale
    if swap_dq_dk:
        dq, dk = dk, dq
    return torch.cat([t.to(dt).transpose(1, 2).reshape(b, n, d)
                      for t in (dq, dk, dv)], dim=-1)


def sdpa_backward_device_ms(q, k, v, g) -> float:
    """The device time of one `scaled_dot_product_attention` backward on
    [B, H, N, dh] heads: every kernel that `torch.autograd.grad` launches on
    a retained forward, by torch.profiler (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(q, k, v)
        parts = launch_us(lambda: torch.autograd.grad(out, (q, k, v), g,
                                                      retain_graph=True))
    return sum(parts.values()) / 1e3


def k3_scalar_kernel(qkv, g, h: int, got, dn: str) -> dict:
    """K3's scalar kernel at the shape where the register-tiled one ran
    (`got`), for the before and after in one run: an unaligned copy of qkv
    takes it (the rule). It must give `got` bit for bit; timed by the event
    loop and by the profiler, as the tiled kernel is."""
    import torch

    from ldt_torch.ops import attention as attn_ops

    fn = attn_ops.packed_self_attention_bwd
    off = unaligned_copy(qkv)
    before = (fn.launches, fn.tiled_launches)
    old = fn(off, g, h)
    counts = (fn.launches, fn.tiled_launches)
    parts = launch_us(lambda: fn(off, g, h))
    if counts != (before[0] + 1, before[1]) or not any(
            "packed_self_attention_bwd_kernel" in k for k in parts):
        fail(f"phase 12: the unaligned K3 copy ({dn}) did not take the "
             f"scalar kernel: {list(parts)}")
    if not torch.equal(got, old):
        fail(f"phase 12: K3's tiled and scalar kernels differ ({dn}: max "
             f"{errs(got, old)[0]:.3e})")
    out = {"pr3_ms": cuda_ms(lambda: fn(off, g, h)),
           "pr3_device_ms": sum(parts.values()) / 1e3}
    print(f"    the scalar kernel (unaligned copy): == the tiled kernel bit "
          f"for bit; kernel {out['pr3_ms']:.4f} ms, device time per call "
          f"{out['pr3_device_ms']:.4f} ms (" + ", ".join(
              f"{k} {us:.2f} us" for k, us in parts.items()) + ")")
    return out


def sdpa_backward_ms(q, k, v, g) -> float:
    """One `scaled_dot_product_attention` backward on [B, H, N, dh] heads:
    forward + backward time minus forward time (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(q, k, v)

    def fwd_bwd():
        fwd().backward(g)

    with torch.enable_grad():
        return cuda_ms(fwd_bwd, iters=50) - cuda_ms(fwd, iters=50)


def phase_train_kernels(batch: int, gen) -> dict:
    """K3 at the train step's shape and K2's long-key schedule at the
    posterior's, against their twins and wrong variants; rows for f32, the
    train step's dtype."""
    import torch
    import torch.nn.functional as F

    from ldt_torch.ops import attention as attn_ops

    n, d, h = 32, 1024, 16            # DiT self-attention (score_cfg)
    nq, m, dc, hc = 32, 2048, 128, 4  # posterior: 32 tokens over 2048 points
    rows = {}

    def heads(t, hh):
        return t.unflatten(-1, (hh, -1)).transpose(1, 2)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        qkv = torch.randn(batch, n, 3 * d, device="cuda", dtype=dtype,
                          generator=gen)
        g = torch.randn(batch, n, d, device="cuda", dtype=dtype,
                        generator=gen)

        def k3():
            return attn_ops.packed_self_attention_bwd(qkv, g, h)

        def k3_plain():
            return attn_ops.packed_self_attention_bwd_plain(qkv, g, h)

        fn = attn_ops.packed_self_attention_bwd
        before = (fn.launches, fn.tiled_launches)
        got = k3()
        if (fn.launches, fn.tiled_launches) != (before[0] + 1,
                                                before[1] + 1):
            fail(f"phase 12: K3 {dn} at the train step's shape did not take "
                 "its register-tiled kernel")
        if not torch.equal(got, k3()):
            fail(f"phase 12: K3 {dn} did not repeat its bits")
        twin = k3_plain()
        readings = {
            "twin": errs(got, twin, rel=True),
            "cpu twin": errs(got, attn_ops.packed_self_attention_bwd_plain(
                qkv.cpu(), g.cpu(), h), rel=True),
            "f64": errs(got, k3_variant(qkv, g, h, acc=torch.float64),
                        rel=True),
            "no rowsum": errs(got, k3_variant(qkv, g, h, rowsum=False),
                              rel=True),
            "dq dk swapped": errs(got, k3_variant(qkv, g, h,
                                                  swap_dq_dk=True),
                                  rel=True)}
        wrong = ("no rowsum", "dq dk swapped")
        if dtype == torch.bfloat16:
            readings["dv unrounded"] = errs(
                got, k3_variant(qkv, g, h, round_dv=False), rel=True)
            wrong += ("dv unrounded",)
        ms = cuda_ms(k3)
        k3_parts = launch_us(k3)
        if not any("packed_self_attention_bwd_tiled_kernel" in k
                   for k in k3_parts):
            fail(f"phase 12: K3 {dn} ran {list(k3_parts)}: the profiler did "
                 "not see packed_self_attention_bwd_tiled_kernel")
        plain_ms = cuda_ms(k3_plain, iters=20)
        sdpa_heads = [heads(qkv[..., i * d:(i + 1) * d], h)
                      for i in range(3)] + [heads(g, h)]
        library_ms = sdpa_backward_ms(*sdpa_heads)
        library_device_ms = sdpa_backward_device_ms(*sdpa_heads)
        nbytes = (2 * qkv.numel() + g.numel()) * qkv.element_size()
        flops = batch * h * (10 * n * n * (d // h) + 8 * n * n)
        bound_ms, bound_by = _bound(nbytes, {dn: flops})
        print(f"[12] packed_self_attention_bwd (K3) {dn} qkv "
              f"{list(qkv.shape)}, g {list(g.shape)}, H={h}: max|twin| "
              f"{twin.float().abs().max().item():.4f}, kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms "
              f"(device {library_device_ms:.4f} ms), bound {bound_ms:.4f} "
              f"ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP)")
        print("    device time per call: " + ", ".join(
            f"{k} {us:.2f} us" for k, us in k3_parts.items()))
        pr3 = k3_scalar_kernel(qkv, g, h, got, dn)
        held(f"K3 {dn} (relative) vs", readings, K3_TOL[dn],
             right=("twin", "cpu twin", "f64"), wrong=wrong)
        if dtype == torch.float32:  # the train step's dtype
            rows["packed_self_attention_bwd"] = {
                "name": "packed_self_attention_bwd", "route": "cuda",
                "source": "ldt_torch/csrc/attention.cu",
                "replaces": "ldt_tpu/ops/pallas_attention.py:312",
                "launches": 0, "max_abs_err": errs(got, twin)[0], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms,
                "library_device_ms": library_device_ms,
                "device_ms": sum(k3_parts.values()) / 1e3, **pr3}

        q = torch.randn(batch, nq, dc, device="cuda", dtype=dtype,
                        generator=gen)
        k = torch.randn(batch, m, dc, device="cuda", dtype=dtype,
                        generator=gen)
        v = torch.randn(batch, m, dc, device="cuda", dtype=dtype,
                        generator=gen)

        def k2():
            return attn_ops.cross_attention(q, k, v, hc)

        def k2_plain():
            return attn_ops.attention_plain(q, k, v, hc)

        tiled = attn_ops.cross_attention.tiled_launches
        got = k2()
        if attn_ops.cross_attention.tiled_launches != tiled + 1:
            fail("phase 12: K2 at M=2048 did not take its long-key schedule")
        if not torch.equal(got, k2()):
            fail(f"phase 12: K2's long-key schedule ({dn}) did not repeat "
                 "its bits")
        readings = {"twin": errs(got, k2_plain()),
                    "cpu twin": errs(got, attn_ops.attention_plain(
                        q.cpu(), k.cpu(), v.cpu(), hc)),
                    "kv swapped": errs(got, attention_variant(
                        q, v, k, hc, torch.float32, dtype))}
        for vname, (acc, w) in variants(dtype).items():
            readings[vname] = errs(got, attention_variant(q, k, v, hc, acc,
                                                          w))
        ms = cuda_ms(k2)
        plain_ms = cuda_ms(k2_plain, iters=20)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            heads(q, hc), heads(k, hc), heads(v, hc)))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        flops = batch * hc * (4 * nq * m * (dc // hc) + 5 * nq * m)
        bound_ms, bound_by = _bound(nbytes, {dn: flops})
        print(f"[12] cross_attention, long-key schedule (K2) {dn} q "
              f"{list(q.shape)}, k/v {list(k.shape)}, H={hc}: max|twin| "
              f"{k2_plain().float().abs().max().item():.4f}, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        print(f"    device time per call: {k2_launch_us(k2)}")
        held(f"K2 long-key {dn} vs", readings, KERNEL_TOL[dn],
             right=("twin", "cpu twin", "f64"), wrong=("wrong", "kv swapped"))
        if dtype == torch.float32:
            k2_encoder_f32(batch, gen)
            rows["cross_attention_tiled"] = {
                "name": "cross_attention_tiled", "route": "cuda",
                "source": "ldt_torch/csrc/attention.cu",
                "replaces": "ldt_tpu/ops/pallas_attention.py:49",
                "launches": 0, "max_abs_err": readings["twin"][0], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}
    return rows


def launch_us(fn, iters: int = 20) -> dict:
    """{kernel: device microseconds per call} of each CUDA launch that `fn`
    makes, from torch.profiler (without the host's share). A session that
    records no kernel at all (the profiler has dropped a whole session's
    records in a long process; three sessions in a row once, at phase
    23a's K4) is taken again, five times at most."""
    import re

    import torch

    def short(key):
        m = re.search(r"::(\w+(?:<[^>]*>)?)\(", key)
        return m.group(1) if m else key[:60]

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {short(k): us / iters
               for k, us in device_time_by_kernel(prof).items()}
        if out:
            break
    return out


def k2_launch_us(fn, iters: int = 20) -> str:
    """`launch_us` as text: K2's schedules' parts."""
    return ", ".join(f"{k} {us:.2f} us" for k, us in launch_us(fn,
                                                                iters).items())


def k2_encoder_f32(batch: int, gen) -> None:
    """K2's whole-set schedule at the encoder's shape (32 tokens over
    themselves, f32, 13 launches per train step): held as phase 2 holds the
    decode shape, timed beside its bound and SDPA (printed only)."""
    import torch
    import torch.nn.functional as F

    from ldt_torch.ops import attention as attn_ops

    n, dc, hc = 32, 128, 4
    q, k, v = (torch.randn(batch, n, dc, device="cuda", generator=gen)
               for _ in range(3))

    def k2():
        return attn_ops.cross_attention(q, k, v, hc)

    got = k2()
    if not torch.equal(got, k2()):
        fail("phase 12: K2's whole-set schedule did not repeat its bits")
    readings = {"twin": errs(got, attn_ops.attention_plain(q, k, v, hc)),
                "cpu twin": errs(got, attn_ops.attention_plain(
                    q.cpu(), k.cpu(), v.cpu(), hc)),
                "kv swapped": errs(got, attention_variant(
                    q, v, k, hc, torch.float32, torch.float32))}
    for vname, (acc, w) in variants(torch.float32).items():
        readings[vname] = errs(got, attention_variant(q, k, v, hc, acc, w))
    ms = cuda_ms(k2)
    plain_ms = cuda_ms(lambda: attn_ops.attention_plain(q, k, v, hc),
                       iters=20)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *(t.unflatten(-1, (hc, -1)).transpose(1, 2) for t in (q, k, v))))
    nbytes = 4 * q.numel() * q.element_size()
    flops = batch * hc * (4 * n * n * (dc // hc) + 5 * n * n)
    bound_ms, bound_by = _bound(nbytes, {"float32": flops})
    print(f"[12] cross_attention, whole-set schedule (K2, encoder) float32 "
          f"q/k/v {list(q.shape)}, H={hc}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.3f} GFLOP)")
    print(f"    device time per call: {k2_launch_us(k2)}")
    held("K2 encoder float32 vs", readings, KERNEL_TOL["float32"],
         right=("twin", "cpu twin", "f64"), wrong=("wrong", "kv swapped"))


def k4_variant(q, k, v, g, num_heads: int, acc=None, rowsum: bool = True,
               ds_from_rounded_w: bool = False, drop_rows=None,
               swap: str = ""):
    """K4's plain twin with its products in `acc` (the "f64" reading) or one
    step changed (the wrong readings of phases 15 and 17): no rowsum; ds
    from the rounded weights; the dk/dv contributions of the query rows
    `drop_rows` (a slice) dropped; two outputs swapped ("dq dk", "dk dv")."""
    import torch

    from ldt_torch.ops import attention as attn_ops

    dh = q.shape[-1] // num_heads
    scale = dh ** -0.5
    dt, acc = q.dtype, acc or torch.float32

    def heads(t):
        return t.unflatten(-1, (num_heads, dh)).transpose(1, 2).to(acc)

    qh, kh, vh, gh = (heads(t) for t in (q, k, v, g))
    w = (qh @ kh.transpose(-1, -2) * scale).softmax(dim=-1)
    wr = w.to(dt).to(acc)
    dw = gh @ vh.transpose(-1, -2)
    wd = wr if ds_from_rounded_w else w
    ds = wd * (dw - (dw * wd).sum(dim=-1, keepdim=True)) if rowsum \
        else wd * dw
    ds = ds.to(dt).to(acc)
    dq = ds @ kh * scale
    if drop_rows is not None:
        ds, wr = ds.clone(), wr.clone()
        ds[..., drop_rows, :] = 0
        wr[..., drop_rows, :] = 0
    out = [attn_ops._merge(t, dt) for t in (
        dq, ds.transpose(-1, -2) @ qh * scale, wr.transpose(-1, -2) @ gh)]
    if swap == "dq dk":
        out[0], out[1] = out[1], out[0]
    elif swap == "dk dv":
        out[1], out[2] = out[2], out[1]
    return tuple(out)


def errs3(got, want):
    """`errs` of (dq, dk, dv), each relative to its largest |want|: the
    largest of the three maxima and of the three means."""
    e = [errs(a, b, rel=True) for a, b in zip(got, want)]
    return max(x[0] for x in e), max(x[1] for x in e)


# Phase 15 (and tests/test_torch_port_cuda.py): the cross-attention
# backward's three shapes in the stage-1 step, (N queries, M keys), at B=16,
# D=128, 4 heads.
K4_SHAPES = {"encoder": (32, 32), "posterior": (32, 2048),
             "decoder": (2048, 32)}
K4_ROWS = {"encoder": "cross_attention_bwd",
           "posterior": "cross_attention_bwd_long_key",
           "decoder": "cross_attention_bwd_long_query"}


def k4_pr4_kernels(q, k, v, g, h: int, got, what: str):
    """K4's scalar kernels at the shape where the register-tiled ones ran
    (`got`), for the before and after in one run: unaligned copies of q, k,
    v and g take them (the rule). They must give `got` bit for bit; timed by
    the event loop and by the profiler, as the tiled kernels are."""
    import torch

    from ldt_torch.ops import attention as attn_ops

    fn = attn_ops.cross_attention_bwd
    off = [unaligned_copy(t) for t in (q, k, v, g)]
    before = (fn.launches, fn.tiled_launches)
    old = fn(*off, h)
    counts = (fn.launches, fn.tiled_launches)
    parts = launch_us(lambda: fn(*off, h))
    if counts != (before[0] + 1, before[1]) or not parts or \
            ", true>" in " ".join(parts):
        fail(f"phase 15: the unaligned K4 copy ({what}) did not take the "
             f"scalar kernels: {list(parts)}")
    if not all(torch.equal(a, b) for a, b in zip(got, old)):
        fail(f"phase 15: K4's tiled and scalar kernels differ ({what}: max "
             f"{max(errs(a, b)[0] for a, b in zip(got, old)):.3e})")
    out = {"pr4_ms": cuda_ms(lambda: fn(*off, h)),
           "pr4_device_ms": sum(parts.values()) / 1e3}
    print(f"    the scalar kernels (unaligned copies): == the tiled kernels "
          f"bit for bit; kernel {out['pr4_ms']:.4f} ms, device time per "
          f"call {out['pr4_device_ms']:.4f} ms (" + ", ".join(
              f"{k} {us:.2f} us" for k, us in parts.items()) + ")")
    return out


def phase_k4(batch: int, gen) -> dict:
    """K4 at the stage-1 step's three shapes against its twin, f64 products
    and wrong variants, in f32 and bf16, on its register-tiled kernels (the
    library's report and the profiler's names), equal bit for bit to the
    scalar kernels run through unaligned copies; rows for f32, the step's
    dtype."""
    import torch

    from ldt_torch.ops import attention as attn_ops

    d, h = 128, 4
    fn = attn_ops.cross_attention_bwd
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for shape, (n, m) in K4_SHAPES.items():
            q, g = (torch.randn(batch, n, d, device="cuda", dtype=dtype,
                                generator=gen) for _ in range(2))
            k, v = (torch.randn(batch, m, d, device="cuda", dtype=dtype,
                                generator=gen) for _ in range(2))
            sched = attn_ops.cross_bwd_schedule(n, m, d // h)

            def k4():
                return fn(q, k, v, g, h)

            def plain():
                return attn_ops.cross_attention_bwd_plain(q, k, v, g, h)

            before = fn.tiled_launches
            got = k4()
            if not attn_ops.cross_bwd_tiled(n, m, d // h) or \
                    fn.tiled_launches != before + 1:
                fail(f"phase 15: K4 {dn} {shape} did not take its "
                     "register-tiled kernels")
            twin = plain()
            readings = {
                "twin": errs3(got, twin),
                "cpu twin": errs3(got, attn_ops.cross_attention_bwd_plain(
                    q.cpu(), k.cpu(), v.cpu(), g.cpu(), h)),
                "f64": errs3(got, k4_variant(q, k, v, g, h,
                                             acc=torch.float64)),
                "no rowsum": errs3(got, k4_variant(q, k, v, g, h,
                                                   rowsum=False)),
                "dk dv swapped": errs3(got, k4_variant(q, k, v, g, h,
                                                       swap="dk dv"))}
            wrong = ("no rowsum", "dk dv swapped")
            if n == m:
                readings["dq dk swapped"] = errs3(
                    got, k4_variant(q, k, v, g, h, swap="dq dk"))
                wrong += ("dq dk swapped",)
            if sched and n > sched:  # the long-query reduction
                readings["one dk/dv partial tile dropped"] = errs3(
                    got, k4_variant(q, k, v, g, h,
                                    drop_rows=slice(sched, 2 * sched)))
                wrong += ("one dk/dv partial tile dropped",)
            if dtype == torch.bfloat16:
                readings["ds from rounded w"] = errs3(
                    got, k4_variant(q, k, v, g, h, ds_from_rounded_w=True))
                wrong += ("ds from rounded w",)
            ms = cuda_ms(k4)
            parts = launch_us(k4)
            if not parts or not all(", true>" in k for k in parts
                                    if "reduce" not in k):
                fail(f"phase 15: K4 {dn} {shape} ran {list(parts)}, not the "
                     "register-tiled kernels")
            device_ms = sum(parts.values()) / 1e3
            plain_ms = cuda_ms(plain, iters=20)
            library_ms = sdpa_backward_ms(*(
                t.unflatten(-1, (h, -1)).transpose(1, 2) for t in (q, k, v,
                                                                   g)))
            nbytes = (3 * q.numel() + 4 * k.numel()) * q.element_size()
            flops = batch * h * (10 * n * m * (d // h) + 8 * n * m)
            bound_ms, bound_by = _bound(nbytes, {dn: flops})
            what = ("long-key" if sched == 0 else
                    f"long-query, {sched} rows x {-(-n // sched)} tiles")
            scales = ", ".join(f"{t.float().abs().max().item():.4f}"
                               for t in twin)
            print(f"[15] cross_attention_bwd (K4, {what}) {dn} {shape}: q "
                  f"{list(q.shape)}, k/v {list(k.shape)}, H={h}: max|twin| "
                  f"dq/dk/dv {scales}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                  f"backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.3f} GFLOP)")
            print(f"    device time per call: {device_ms:.4f} ms (" + ", ".join(
                f"{k} {us:.2f} us" for k, us in parts.items()) + ")")
            held(f"K4 {dn} {shape} (relative) vs", readings, K4_TOL[dn],
                 right=("twin", "cpu twin", "f64"), wrong=wrong)
            if not all(torch.equal(a, b) for a, b in zip(got, k4())):
                fail(f"phase 15: K4 {dn} {shape} did not repeat its bits")
            pr4 = k4_pr4_kernels(q, k, v, g, h, got, f"{dn} {shape}")
            if dtype == torch.float32:
                name = K4_ROWS[shape]
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": "ldt_torch/csrc/attention.cu",
                    "replaces": "ldt_tpu/ops/pallas_attention.py:72",
                    "launches": 0,
                    "max_abs_err": max(errs(a, b)[0]
                                       for a, b in zip(got, twin)),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms,
                    "device_ms": device_ms, **pr4}
    return rows


def build_models(gen):
    """The flagship Score in f32 (the source the int8 path quantizes) and in
    bf16 from the same weights, and the bf16 decoder."""
    import torch

    from ldt_torch.configs import compressor_cfg, score_cfg
    from ldt_torch.models import Compressor, Score
    from ldt_torch.weights import is_decode_key

    t0 = time.perf_counter()
    weights = Score(score_cfg(), device="cuda", generator=gen).state_dict()
    score = Score(score_cfg(), dtype=torch.bfloat16, device="cuda").eval()
    score.load_state_dict(weights)
    comp = Compressor(compressor_cfg(), dtype=torch.bfloat16, device="cuda",
                      generator=gen).eval()
    torch.cuda.synchronize()
    n_score = sum(p.numel() for p in score.parameters())
    n_comp = sum(p.numel() for k, p in comp.named_parameters()
                 if is_decode_key(k))
    print(f"[3] flagship Score {n_score / 1e6:.2f}M params (24 blocks, "
          f"hidden 1024; f32 weights, bf16 copy), decoder "
          f"{n_comp / 1e6:.3f}M params, random init from seed 0: "
          f"{time.perf_counter() - t0:.2f} s")
    return score, comp, weights


def phase_path(score, comp, batch: int, steps: int, gen) -> None:
    """The two halves of `generate` through the kernels, through the plain
    attention and through the variants, from the same weights and draws:
    the sampler from noise, and the decoder on N(0, 1) latents (the scale
    of a trained model's; at the random-weight sampler's |latent| ~ 5e3 the
    decoder's softmaxes are near one-hot, and any other rounding of the
    attention, right or wrong, moves the clouds by most of their scale)."""
    import torch

    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import sample_latents
    from ldt_torch.ops import attention as attn_ops

    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    shape = (batch, score.cfg.z_scale, score.cfg.z_dim)
    x0 = torch.randn(shape, device="cuda", generator=gen)
    noise = torch.randn((steps,) + shape, device="cuda", generator=gen)
    eps = torch.randn(shape, device="cuda", generator=gen)

    def run():
        lat = sample_latents(score, sde, batch, steps, device="cuda", x0=x0,
                             noise=noise)
        with torch.inference_mode():
            clouds = comp.sample((batch, comp.cfg.outsize), eps)
        torch.cuda.synchronize()
        return {"sampler": lat.float(), "decoder": clouds.float()}

    k1, k2 = (attn_ops.packed_self_attention.launches,
              attn_ops.cross_attention.launches)
    t0 = time.perf_counter()
    got = run()
    dt = time.perf_counter() - t0
    k1 = attn_ops.packed_self_attention.launches - k1
    k2 = attn_ops.cross_attention.launches - k2
    want = {}
    with mock.patch.object(attn_ops, "packed_self_attention",
                           attn_ops.packed_self_attention_plain), \
            mock.patch.object(attn_ops, "cross_attention",
                              attn_ops.attention_plain):
        want["twin"] = run()
    patches = {k: attention_patches(*v)
               for k, v in variants(torch.bfloat16).items()}
    patches["kv swapped"] = attention_patches(torch.float32, torch.bfloat16,
                                              swap_kv=True)
    for vname, (p_self, p_cross) in patches.items():
        with p_self, p_cross:
            want[vname] = run()
    print(f"[3] {steps} sampler steps at B={batch}, max|latent| "
          f"{want['twin']['sampler'].abs().max().item():.4f}; decode of "
          f"N(0, 1) latents to {list(got['decoder'].shape)}, max|cloud| "
          f"{want['twin']['decoder'].abs().max().item():.4f}; {dt:.2f} s, "
          f"launches K1 {k1} K2 {k2}")
    if k1 != score.cfg.num_blocks * steps or k2 != comp.cfg.n_layers:
        fail(f"phase 3 launches K1 {k1}, K2 {k2}")
    if not all(torch.isfinite(t).all() for t in got.values()):
        fail("phase 3 output is not finite")
    for part, (tol, wrong) in PATH_TOL.items():
        held(f"{part} (relative), kernels vs",
             {k: errs(got[part], w[part], rel=True) for k, w in want.items()},
             tol, wrong=wrong)


def _counters() -> tuple:
    """({kernel: wrapper}, {schedule: (wrapper, attribute)}): every launch
    counter of the port's kernels."""
    from ldt_torch.ops import attention as attn_ops
    from ldt_torch.ops.chamfer import pairwise_cd_means
    from ldt_torch.ops.emd import approx_match_cost

    wrappers = {"packed_self_attention": attn_ops.packed_self_attention,
                "cross_attention": attn_ops.cross_attention,
                "packed_self_attention_int8":
                attn_ops.packed_self_attention_int8,
                "packed_self_attention_bwd":
                attn_ops.packed_self_attention_bwd,
                "cross_attention_bwd": attn_ops.cross_attention_bwd,
                "pairwise_cd_means": pairwise_cd_means,
                "approx_match_cost": approx_match_cost}
    # the schedule counts (each launch is counted in its wrapper's too)
    schedules = {"packed_self_attention_mma": (
                     attn_ops.packed_self_attention, "mma_launches"),
                 "packed_self_attention_tiled": (
                     attn_ops.packed_self_attention, "tiled_launches"),
                 "packed_self_attention_int8_mma": (
                     attn_ops.packed_self_attention_int8, "mma_launches"),
                 "packed_self_attention_bwd_tiled": (
                     attn_ops.packed_self_attention_bwd, "tiled_launches"),
                 "cross_attention_tiled": (attn_ops.cross_attention,
                                           "tiled_launches"),
                 "cross_attention_bwd_long_key": (
                     attn_ops.cross_attention_bwd, "long_key_launches"),
                 "cross_attention_bwd_long_query": (
                     attn_ops.cross_attention_bwd, "long_query_launches"),
                 "cross_attention_bwd_tiled": (attn_ops.cross_attention_bwd,
                                               "tiled_launches"),
                 "pairwise_cd_means_split": (pairwise_cd_means,
                                             "split_launches"),
                 "approx_match_cost_otf": (approx_match_cost,
                                           "otf_launches"),
                 "approx_match_cost_cluster": (approx_match_cost,
                                               "cluster_launches")}
    return wrappers, schedules


def launch_counts() -> dict:
    """Every kernel's and schedule's launch count as it stands."""
    wrappers, schedules = _counters()
    counts = {k: w.launches for k, w in wrappers.items()}
    counts.update({k: getattr(w, attr)
                   for k, (w, attr) in schedules.items()})
    return counts


def counted(fn):
    """Run `fn` with every kernel's launch count set to 0 just before and
    read just after: (its output, wall seconds, {kernel: launches})."""
    import torch

    wrappers, schedules = _counters()
    for w in wrappers.values():
        w.launches = 0
    for w, attr in schedules.values():
        setattr(w, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launch_counts()


def per_step_launches(**counts) -> dict:
    """Every kernel's launch count in one step: `counts`, else 0."""
    names = ("packed_self_attention", "packed_self_attention_mma",
             "packed_self_attention_tiled", "cross_attention",
             "packed_self_attention_int8", "packed_self_attention_int8_mma",
             "packed_self_attention_bwd", "packed_self_attention_bwd_tiled",
             "cross_attention_bwd", "cross_attention_tiled",
             "cross_attention_bwd_long_key",
             "cross_attention_bwd_long_query", "cross_attention_bwd_tiled",
             "pairwise_cd_means", "pairwise_cd_means_split",
             "approx_match_cost", "approx_match_cost_otf",
             "approx_match_cost_cluster")
    return {k: counts.get(k, 0) for k in names}


def k1_schedule_launches(score, k1_launches: int) -> dict:
    """K1's calls by schedule among `k1_launches` of `score`'s blocks (the
    rule at its dtype, 32 tokens and heads of 64: the tensor cores in bf16,
    the register-tiled schedule in f32), as `counted` names them."""
    from ldt_torch.ops import attention as attn_ops

    dtype = next(score.parameters()).dtype
    dh = score.cfg.hidden_size // score.cfg.num_heads
    schedule = attn_ops.packed_schedule(score.cfg.z_scale, dh, dtype)
    return {"packed_self_attention_mma": k1_launches * (schedule == "mma"),
            "packed_self_attention_tiled":
            k1_launches * (schedule == "tiled")}


def checked_generation(tag: str, what: str, fn, batch: int, expect: dict):
    """A counted generation whose output must be finite [batch, 2048, 3]
    and whose launch counts must be `expect`; returns the counts."""
    import torch

    out, dt, launches = counted(fn)
    finite = bool(torch.isfinite(out).all())
    print(f"[{tag}] {what}, B={batch}: out {list(out.shape)} {out.dtype}, "
          f"finite {finite}, {dt:.3f} s, {batch / dt * 60.0:.2f} clouds/min, "
          f"launches {launches} (expected {expect})")
    if tuple(out.shape) != (batch, 2048, 3) or not finite:
        fail(f"{what}: output has the wrong shape or is not finite")
    if launches != expect:
        fail(f"{what}: launch counts {launches} differ from the path's "
             f"{expect}")
    return launches


def expected_launches(score, comp, steps: int, k1: bool, k8: bool) -> dict:
    per_run = score.cfg.num_blocks * steps
    # every K8 call at the DiT's shape must report the int8 tensor cores
    return per_step_launches(
        packed_self_attention=per_run if k1 else 0,
        **k1_schedule_launches(score, per_run if k1 else 0),
        cross_attention=comp.cfg.n_layers,
        packed_self_attention_int8=per_run if k8 else 0,
        packed_self_attention_int8_mma=per_run if k8 else 0)


def phase_generate(score, comp, batch: int, steps: int, gen) -> dict:
    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate

    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    return checked_generation(
        "4", f"generate (bf16): {steps} steps + decode",
        lambda: generate(score, comp, sde, batch, steps, device="cuda",
                         generator=gen),
        batch, expected_launches(score, comp, steps, True, False))


def phase_int8_generate(score, comp, weights, batch: int, steps: int,
                        gen) -> dict:
    """The int8 serving path at full width: W8A8 dynamic with K1, then with
    K8. Returns the launch counts of the K8 run."""
    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate

    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    for attn_int8 in (False, True):
        launches = checked_generation(
            "9", f"generate (int8 W8A8, attention "
            f"{'K8' if attn_int8 else 'K1'}): {steps} steps + decode",
            lambda: generate(score, comp, sde, batch, steps, device="cuda",
                             generator=gen, int8=True, int8_weights=weights,
                             attn_int8=attn_int8),
            batch, expected_launches(score, comp, steps, not attn_int8,
                                     attn_int8))
    return launches


def phase_ddim_int8(score, comp, weights, batch: int, steps: int,
                    gen) -> None:
    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate

    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    checked_generation(
        "10", f"generate (int8 W8A8, K8, DDIM): {steps} steps + decode",
        lambda: generate(score, comp, sde, batch, steps, device="cuda",
                         generator=gen, int8=True, int8_weights=weights,
                         attn_int8=True, predictor="ddim"),
        batch, expected_launches(score, comp, steps, False, True))


def device_time_by_kernel(prof) -> dict:
    """{kernel: device us} of a torch.profiler run."""
    import torch

    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + us
    return kernels


def phase_profile(score, comp, batch: int, steps: int, gen, label: str,
                  **kw) -> None:
    """Device time by kernel and the idle share of a short `generate(**kw)`
    under torch.profiler, and its wall time without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate

    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")

    def run():
        generate(score, comp, sde, batch, steps, device="cuda",
                 generator=gen, **kw)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_time_by_kernel(prof)
    busy = sum(kernels.values())
    if busy == 0:
        print(f"[5] profile ({label}): the profiler recorded no device time "
              "(not measured)")
        return
    groups = {"K1 packed_self_attention": 0.0, "K2 cross_attention": 0.0,
              "K8 packed_self_attention_int8": 0.0, "GEMM": 0.0,
              "other": 0.0}
    for key, us in kernels.items():
        low = key.lower()
        if "int8_group_scales" in low or "self_attention_int8" in low:
            groups["K8 packed_self_attention_int8"] += us
        elif "packed_self_attention" in low:
            groups["K1 packed_self_attention"] += us
        elif "cross_attention" in low:
            groups["K2 cross_attention"] += us
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma",
                                    "imma")):
            groups["GEMM"] += us
        else:
            groups["other"] += us
    print(f"[5] profile of generate ({label}, {steps} steps + decode, "
          f"B={batch}): device busy {busy / 1e3:.2f} ms; wall "
          f"{wall_us / 1e3:.2f} ms profiled (idle share "
          f"{1 - busy / wall_us:.3f}), {plain_wall_us / 1e3:.2f} ms not "
          f"profiled (idle share {1 - busy / plain_wall_us:.3f})")
    for g, us in groups.items():
        print(f"    {g}: {us / 1e3:.2f} ms ({us / busy:.3f} of busy)")
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.2f} ms  {key[:110]}")


def phase_int8_step(steps: int) -> None:
    """One int8 denoise step (K8 attention) at flagship width cut to two
    blocks, B=4, the same f32 weights, modulations and input on the card
    and on the CPU (the path the CPU tests hold against ldt_tpu)."""
    import torch

    from ldt_torch.configs import score_cfg
    from ldt_torch.diffusion.sampling import timesteps
    from ldt_torch.generate import TIME_EPS
    from ldt_torch.models import Score
    from ldt_torch.ops import attention as attn_ops
    from ldt_torch.serving import int8 as int8_serving

    batch, step = 4, steps // 2
    g = torch.Generator().manual_seed(SEED)
    cfg = score_cfg(num_blocks=2)
    weights = Score(cfg, device="cpu", generator=g).state_dict()
    score = Score(cfg, dtype=torch.bfloat16, device="cpu")
    score.load_state_dict(weights)
    x = torch.randn((batch, cfg.z_scale, cfg.z_dim), generator=g)
    with torch.inference_mode():
        mods = score.precompute_mods(timesteps(steps, TIME_EPS))
    mods = {k: v[step] for k, v in mods.items()}

    def run(dev, bf16_tail=0):
        q = int8_serving.quantize_score_params(weights, cfg.num_blocks,
                                               bf16_tail, device=dev)
        with torch.inference_mode():
            return int8_serving.denoise_with_mods_int8(
                x.to(dev), {k: v.to(dev) for k, v in mods.items()}, q,
                cfg.num_heads, attn_int8=True).float().cpu()

    out = {"cpu": run("cpu")}
    k8 = attn_ops.packed_self_attention_int8.launches
    out["card"] = run("cuda")
    if attn_ops.packed_self_attention_int8.launches - k8 != cfg.num_blocks:
        fail("phase 11: the card's int8 step did not go through K8")
    with mock.patch.object(
            attn_ops, "packed_self_attention_int8",
            lambda qkv, h, elems=4: attn_ops.packed_self_attention_int8_plain(
                qkv, h, 1)):
        out["E=1"] = run("cuda")
    d = cfg.hidden_size
    with mock.patch.object(
            attn_ops, "packed_self_attention_int8",
            lambda qkv, h, elems=4: attn_ops.packed_self_attention_int8_plain(
                torch.cat([qkv[..., :d], qkv[..., 2 * d:], qkv[..., d:2 * d]],
                          dim=-1), h, elems)):
        out["kv swapped"] = run("cuda")
    out["bf16 weights"] = run("cuda", bf16_tail=cfg.num_blocks)
    if not torch.isfinite(out["card"]).all():
        fail("phase 11: the int8 step is not finite")
    print(f"[11] one int8 step (K8) at flagship width, 2 blocks, B={batch}, "
          f"step {step} of {steps}, card vs CPU; max|out| "
          f"{out['cpu'].abs().max().item():.4f}")
    held("int8 step (relative), CPU vs",
         {k: errs(v, out["cpu"], rel=True) for k, v in out.items()
          if k != "cpu"}, INT8_STEP_TOL, right=("card",),
         wrong=("E=1", "kv swapped", "bf16 weights"))


TRAIN_CLASSES = (
    ("K3 packed_self_attention_bwd", ("packed_self_attention_bwd",)),
    ("K1 packed_self_attention", ("packed_self_attention",)),
    ("K4 cross_attention_bwd", ("cross_attention_bwd",)),
    ("K2 cross_attention", ("cross_attention",)),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "sm80_")),
    ("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
    ("FPS / kNN / gather", ("topk", "sort", "radix", "bitonic", "argmax",
                            "gather", "index")),
)


def phase_train(batch: int, steps: int, gen) -> dict:
    """The flagship stage-2 train step: returns the launch counts of the
    timed steps."""
    import torch

    from ldt_torch.configs import latent_trainer_cfg
    from ldt_torch.training.latent_sde_trainer import Trainer

    cfg = latent_trainer_cfg()
    trainer = Trainer(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(SEED))
    data = {"tr_points": torch.randn(batch, cfg.data.tr_max_sample_points,
                                     3, device="cuda", generator=gen)}
    t0 = time.perf_counter()
    trainer.maybe_init(data)
    torch.cuda.synchronize()
    n_score = sum(p.numel() for p in trainer.score.parameters())
    n_comp = sum(p.numel() for p in trainer.compressor.parameters())
    print(f"[13] stage-2 trainer: Score {n_score / 1e6:.2f}M params (f32), "
          f"frozen Compressor {n_comp / 1e6:.3f}M params, random init from "
          f"seed {SEED} (ActNorm from the first 2 clouds): "
          f"{time.perf_counter() - t0:.2f} s")
    for _ in range(2):  # warm-up
        trainer.update(data)
    torch.cuda.reset_peak_memory_stats()
    losses, dt, launches = counted(
        lambda: torch.stack([trainer.update(data) for _ in range(steps)]))
    losses = losses.cpu()
    per_step = per_step_launches(
        packed_self_attention=24, packed_self_attention_bwd=24,
        packed_self_attention_bwd_tiled=24, cross_attention=24,
        cross_attention_tiled=5,
        **k1_schedule_launches(trainer.score, 24))
    expect = {k: v * steps for k, v in per_step.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[13] {steps} train steps at B={batch}, f32: {dt * 1e3 / steps:.2f}"
          f" ms/step, {steps / dt:.3f} steps/s ({smi_name_and_power()}); "
          f"losses {[round(x, 4) for x in losses.tolist()]}; peak memory "
          f"{peak:.2f} GiB; launches {launches} (expected {expect})")
    if not torch.isfinite(losses).all():
        fail("phase 13: a loss is not finite")
    if launches != expect:
        fail(f"phase 13: launch counts {launches} differ from the train "
             f"step's {expect}")

    # the encode and the rest of the step apart, by CUDA events
    pts = trainer._points(data["tr_points"])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    eps = trainer.encode(pts)
    ev[1].record()
    trainer.train_step(eps, trainer.current_lr())
    ev[2].record()
    ev[2].synchronize()
    print(f"[13] one step by CUDA events: encode {ev[0].elapsed_time(ev[1]):.2f}"
          f" ms, loss + backward + clip + Adam + EMA "
          f"{ev[1].elapsed_time(ev[2]):.2f} ms")

    profile_step("13", lambda: trainer.update(data), batch)
    return launches


def kernel_classes(kernels: dict) -> dict:
    """{class: device us} of {kernel: device us}, by TRAIN_CLASSES."""
    groups = {name: 0.0 for name, _ in TRAIN_CLASSES}
    groups["elementwise and other"] = 0.0
    for key, us in kernels.items():
        low = key.lower()
        name = next((n for n, words in TRAIN_CLASSES
                     if any(w in low for w in words)),
                    "elementwise and other")
        groups[name] += us
    return groups


def profile_step(tag: str, step, batch: int) -> None:
    """One `step()` under torch.profiler: device time by kernel class
    (TRAIN_CLASSES), the top kernels, and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_time_by_kernel(prof)
    busy = sum(kernels.values())
    if busy == 0:
        print(f"[{tag}] profile: the profiler recorded no device time (not "
              "measured)")
        return
    groups = kernel_classes(kernels)
    print(f"[{tag}] profile of one train step (B={batch}): device busy "
          f"{busy / 1e3:.2f} ms; wall {wall_us / 1e3:.2f} ms profiled (idle "
          f"share {1 - busy / wall_us:.3f})")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {name}: {us / 1e3:.2f} ms ({us / busy:.3f} of busy)")
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.2f} ms  {key[:110]}")


def phase_stage1_train(steps: int, gen):
    """The flagship stage-1 train step (`compressor_trainer_cfg()`: B=16,
    2048 points, 6 layers, f32) on synthetic clouds: returns the launch
    counts of the timed steps and the trainer (phase 19 evaluates it)."""
    import torch

    from ldt_torch.configs import compressor_trainer_cfg
    from ldt_torch.training import compressor_trainer as ct

    cfg = compressor_trainer_cfg()
    batch = cfg.data.batch_size
    trainer = ct.Trainer(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(SEED))
    data = {"tr_points": torch.randn(batch, cfg.data.tr_max_sample_points,
                                     3, device="cuda", generator=gen)}
    t0 = time.perf_counter()
    trainer.maybe_init(data)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[16] stage-1 trainer: Compressor {n_params / 1e6:.3f}M params "
          f"(f32), random init from seed {SEED}, ActNorm from the batch "
          f"after train-mode BatchNorms: {time.perf_counter() - t0:.2f} s")
    for _ in range(2):  # warm-up
        trainer.update(data)
    torch.cuda.reset_peak_memory_stats()
    losses, dt, launches = counted(lambda: torch.stack(
        [torch.stack(trainer.update(data)) for _ in range(steps)]))
    losses = losses.cpu()
    per_step = per_step_launches(
        cross_attention=24, cross_attention_tiled=5, cross_attention_bwd=24,
        cross_attention_bwd_long_key=5, cross_attention_bwd_long_query=6,
        cross_attention_bwd_tiled=24)
    expect = {k: v * steps for k, v in per_step.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[16] {steps} stage-1 train steps at B={batch}, f32: "
          f"{dt * 1e3 / steps:.2f} ms/step, {steps / dt:.3f} steps/s "
          f"({smi_name_and_power()}); (loss, kl, rec, max) first "
          f"{[round(x, 4) for x in losses[0].tolist()]}, last "
          f"{[round(x, 4) for x in losses[-1].tolist()]}; peak memory "
          f"{peak:.2f} GiB; launches {launches} (expected {expect})")
    if not torch.isfinite(losses).all():
        fail("phase 16: a loss is not finite")
    if launches != expect:
        fail(f"phase 16: launch counts {launches} differ from the stage-1 "
             f"step's {expect}")

    # one step's parts by CUDA events around the objective's pieces
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    def marked(fn, before, after):
        def run(*a, **kw):
            mark(before)
            out = fn(*a, **kw)
            mark(after)
            return out
        return run

    with mock.patch.object(ct, "CD_loss", marked(ct.CD_loss, "cd0", "cd1")), \
            mock.patch.object(ct, "EMD_loss", marked(ct.EMD_loss, "emd0",
                                                     "emd1")), \
            mock.patch.object(ct, "apply_update",
                              marked(ct.apply_update, "opt0", "opt1")):
        torch.cuda.synchronize()
        mark("start")
        trainer.update(data)
        mark("end")
    ev["end"].synchronize()
    parts = {"forward (train-mode encode + decode)": ("start", "cd0"),
             "chamfer": ("cd0", "cd1"), "auction EMD": ("emd0", "emd1"),
             "backward (K4 in every attention)": ("emd1", "opt0"),
             "clip + Adam + batch stats": ("opt0", "opt1")}
    print(f"[16] one step by CUDA events: total "
          f"{ev['start'].elapsed_time(ev['end']):.2f} ms; " + ", ".join(
              f"{k} {ev[a].elapsed_time(ev[b]):.2f} ms"
              for k, (a, b) in parts.items()))
    profile_step("16", lambda: trainer.update(data), batch)
    # the two losses alone, on the step's decoded set: their kernels' time
    from torch.profiler import ProfilerActivity, profile

    pts = trainer._points(data["tr_points"])
    rec = trainer.encode(pts)["set"]
    busy = {}
    for name, loss in (("chamfer", ct.CD_loss), ("auction EMD", ct.EMD_loss)):
        loss(rec, pts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss(rec, pts)
            torch.cuda.synchronize()
        busy[name] = sum(device_time_by_kernel(prof).values()) / 1e3
    print("[16] device busy of each loss alone on the decoded set: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in busy.items()))
    return launches, trainer


def pinned_rec(rec: "torch.Tensor", pts: "torch.Tensor"):
    """(CD_loss, EMD_loss) stand-ins that take the chamfer neighbours and
    the EMD assignment of the decoded set `rec` against `pts`, computed
    here once (on the CPU), and otherwise compute as the losses do: two
    devices' decoded sets differ in their last bits, and a discrete choice
    could flip between them."""
    import torch

    from ldt_torch.ops.chamfer import chamfer_distance
    from ldt_torch.ops.emd import auction_emd
    from ldt_torch.ops.geometry import index_points, sum_square_diff

    _, _, idx1, idx2 = chamfer_distance(rec, pts)
    assignment = auction_emd(rec, pts)[1]

    def l1(d):
        return torch.mean(torch.sqrt(torch.clamp(d, min=1e-12)))

    def cd(s, p):
        return (l1(sum_square_diff(s, index_points(p, idx1.to(s.device))))
                + l1(sum_square_diff(p, index_points(s, idx2.to(s.device)))))

    def emd(s, p):
        return l1(sum_square_diff(s, index_points(p.detach(),
                                           assignment.to(s.device))))

    return cd, emd


def merged_nets(module, merge: bool, names=("Score", "Compressor")):
    """Patches that make the trainer module `module` build its nets with
    the reference's head merge (`ref_merge=True`) when `merge`."""
    import functools

    if not merge:
        return ()
    return tuple(mock.patch.object(module, name, functools.partial(
        getattr(module, name), ref_merge=True)) for name in names
        if hasattr(module, name))


def phase_stage1_reference(ref_merge: bool = False) -> None:
    """One stage-1 step at flagship width cut to two layers, f32, B=4: the
    same weights, clouds, pinned noise, chamfer neighbours and EMD
    assignment on the card and on the CPU (the path the CPU tests hold
    against ldt_tpu), and against a K4 with dq and dk swapped; then the
    auction alone on clouds on a dyadic grid, card against CPU. With
    `ref_merge` (phase 22a) the nets merge heads as the reference does, and
    the wrong variant is the standard merge on the card."""
    import torch

    from ldt_torch.configs import compressor_trainer_cfg
    from ldt_torch.models import Compressor
    from ldt_torch.ops import attention as attn_ops
    from ldt_torch.ops.emd import auction_emd
    from ldt_torch.training import compressor_trainer as ct

    tag = "22a" if ref_merge else "17"
    batch = 4
    cfg = compressor_trainer_cfg(model=dict(n_layers=2))
    mc = cfg.model
    g = torch.Generator().manual_seed(SEED)
    comp = Compressor(mc, device="cpu", generator=g, ref_merge=ref_merge)
    pts = torch.randn(batch, 2048, 3, generator=g)
    comp.init_actnorm(pts, train=True)
    weights = comp.state_dict()
    noise = [torch.randn(batch, mc.z_scales, mc.z_dim, generator=g)
             for _ in range(mc.n_layers)]
    with torch.no_grad():
        rec = comp(pts, noise=noise, train=True)["set"]
    cd, emd = pinned_rec(rec, pts)
    k4 = attn_ops.cross_attention_bwd

    def k4_dq_dk_swapped(q, k, v, gg, h):
        dq, dk, dv = k4(q, k, v, gg, h)
        return (dk, dq, dv) if q.shape == k.shape else (dq, dk, dv)

    # K4 counts its launches on whatever its module name holds
    for attr in ("launches", "long_key_launches", "long_query_launches",
                 "tiled_launches"):
        setattr(k4_dq_dk_swapped, attr, 0)

    def run(dev, merge=ref_merge):
        with contextlib.ExitStack() as stack:
            for patch in merged_nets(ct, merge):
                stack.enter_context(patch)
            tr = ct.Trainer(cfg, device=dev)
            tr.maybe_init({"tr_points": pts}, weights=weights)
            with mock.patch.object(ct, "CD_loss", cd), \
                    mock.patch.object(ct, "EMD_loss", emd):
                loss = tr.update({"tr_points": pts}, noise=noise)[0]
        st = tr.state

        def flat(tree):
            return torch.cat([t.detach().reshape(-1).cpu()
                              for t in tree.values()])

        return {"loss": loss.reshape(1).cpu(),
                "gradients": flat({k: p.grad for k, p in st.params.items()}),
                "params": flat(st.params),
                "batch stats": flat(st.batch_stats),
                "Adam mu": flat(st.opt_state.mu)}

    out = {"cpu": run("cpu")}
    k2 = attn_ops.cross_attention
    before = (k4.launches, k4.tiled_launches, k2.launches)
    out["card"] = run("cuda")
    # per layer: 2 encoder blocks, a posterior and a decoder block, all on
    # the register-tiled kernels
    if (k4.launches - before[0], k4.tiled_launches - before[1],
            k2.launches - before[2]) != (4 * mc.n_layers,) * 3:
        fail(f"phase {tag}: the card's step did not go through K2 and K4's "
             "tiled kernels")
    if ref_merge:
        wrong = "standard merge"
        out[wrong] = run("cuda", merge=False)
    else:
        wrong = "dq dk swapped"
        with mock.patch.object(attn_ops, "cross_attention_bwd",
                               k4_dq_dk_swapped):
            out[wrong] = run("cuda")
    print(f"[{tag}] one stage-1 step at flagship width, {mc.n_layers} "
          f"layers, f32, B={batch}, {'reference head merge, ' * ref_merge}"
          f"card vs CPU (chamfer neighbours and EMD assignment from the "
          f"CPU): loss {out['cpu']['loss'].item():.6f}")
    for part in out["cpu"]:
        if not torch.isfinite(out["card"][part]).all():
            fail(f"phase {tag}: {part} on the card is not finite")
        held(f"{part} (relative), CPU vs",
             {k: errs(out[k][part], out["cpu"][part], rel=True)
              for k in ("card", wrong)}, TRAIN_STEP_TOL,
             right=("card",),
             wrong=(wrong,) if part in ("gradients", "Adam mu") else ())
    if ref_merge:
        return

    # the auction alone: distances exact in f32 on a grid of eighths
    x, y = (torch.randint(-8, 9, (2, 2048, 3), generator=g).float() / 8
            for _ in range(2))
    cpu = auction_emd(x, y)[1]
    card = auction_emd(x.cuda(), y.cuda())[1].cpu()
    d = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
    ties = int(((d == d.amin(dim=2, keepdim=True)).sum(-1) > 1).sum())
    bijective = all(len(set(a.tolist())) == a.numel() for a in cpu)
    print(f"[17] auction EMD on dyadic-grid clouds [2, 2048, 3], card vs "
          f"CPU: assignments equal {torch.equal(cpu, card)} (rows whose "
          f"nearest column ties: {ties} of 4096; a bijection: {bijective})")
    if not torch.equal(cpu, card):
        fail(f"phase 17: the auction's assignments differ in "
             f"{int((cpu != card).sum())} rows")


def phase_train_reference(ref_merge: bool = False,
                          mixed: bool = False) -> None:
    """One stage-2 train step at flagship width cut to two Score blocks,
    f32, B=4: the same weights, clouds and pinned draws on the card and on
    the CPU (the path the CPU tests hold against ldt_tpu), and against a K3
    with dq and dk swapped. With `ref_merge` (phase 22a) both nets merge
    heads as the reference does, and the wrong variant is the standard
    merge on the card. `mixed` (phase 25b): bf16 compute over f32
    parameters (`common.train_dtype: bfloat16`, K1 on its tensor-core
    schedule), held to MP_STEP_TOL."""
    import torch

    from ldt_torch.configs import latent_trainer_cfg
    from ldt_torch.models import Compressor, Score
    from ldt_torch.ops import attention as attn_ops
    from ldt_torch.training import latent_sde_trainer as lt

    tag = "22a" if ref_merge else "25b" if mixed else "14"
    batch = 4
    cfg = latent_trainer_cfg(score=dict(num_blocks=2), common=dict(
        train_dtype="bfloat16" if mixed else "float32"))
    g = torch.Generator().manual_seed(SEED)
    score_w = Score(cfg.score, device="cpu", generator=g).state_dict()
    comp = Compressor(cfg.compressor, device="cpu", generator=g,
                      ref_merge=ref_merge)
    pts = torch.randn(batch, 2048, 3, generator=g)
    comp.init_actnorm(pts[:2])
    comp_w = comp.state_dict()
    pins = dict(
        t_idx=torch.randint(0, cfg.sde.train_N, (batch,), generator=g),
        eta=torch.randn(batch, cfg.score.z_scale, cfg.score.z_dim,
                        generator=g),
        enc_noise=[torch.randn(batch, cfg.compressor.z_scales,
                               cfg.compressor.z_dim, generator=g)
                   for _ in range(cfg.compressor.n_layers)])

    def run(dev, merge=ref_merge):
        with contextlib.ExitStack() as stack:
            for patch in merged_nets(lt, merge):
                stack.enter_context(patch)
            tr = lt.Trainer(cfg, device=dev)
            tr.maybe_init({"tr_points": pts}, score_weights=score_w,
                          compressor_weights=comp_w)
            loss = tr.update({"tr_points": pts}, **pins)
        st = tr.state

        def flat(tree):
            return torch.cat([t.detach().reshape(-1).cpu()
                              for t in tree.values()])

        return {"loss": loss.reshape(1).cpu(),
                "gradients": flat({k: p.grad for k, p in st.params.items()}),
                "params": flat(st.params), "EMA": flat(st.ema_params),
                "Adam mu": flat(st.opt_state.mu)}

    out = {"cpu": run("cpu")}
    k1_schedule = "mma" if mixed else "tiled"
    fns = ((attn_ops.packed_self_attention_bwd, "tiled_launches"),
           (attn_ops.packed_self_attention, f"{k1_schedule}_launches"),
           (attn_ops.cross_attention, "tiled_launches"))
    before = [(f.launches, getattr(f, a)) for f, a in fns]
    out["card"] = run("cuda")
    (k3, k3_tiled), (k1, k1_sched), (k2, _) = [
        (f.launches - b[0], getattr(f, a) - b[1])
        for (f, a), b in zip(fns, before)]
    # the 2 blocks' K1 (register-tiled in f32, the tensor cores in bf16)
    # and K3 (register-tiled); the frozen Compressor's encode through K2
    if (k3, k3_tiled, k1, k1_sched) != (2, 2, 2, 2) or not k2:
        fail(f"phase {tag}: the card's step did not go through K1, K2 and "
             f"K3's schedules: K1 {k1} ({k1_sched} {k1_schedule}), K2 "
             f"{k2}, K3 {k3} ({k3_tiled} tiled)")
    if ref_merge:
        wrong = "standard merge"
        out[wrong] = run("cuda", merge=False)
    else:
        wrong = "dq dk swapped"
        with mock.patch.object(
                attn_ops, "packed_self_attention_bwd",
                lambda qkv, gg, h: k3_variant(qkv, gg, h, swap_dq_dk=True)):
            out[wrong] = run("cuda")
    what = "bf16 compute over f32 parameters" if mixed else "f32"
    print(f"[{tag}] one train step at flagship width, 2 Score blocks, "
          f"{what}, B={batch}, {'reference head merge, ' * ref_merge}card vs "
          f"CPU: loss {out['cpu']['loss'].item():.6f}")
    for part in out["cpu"]:
        if not torch.isfinite(out["card"][part]).all():
            fail(f"phase {tag}: {part} on the card is not finite")
        held(f"{part} (relative), CPU vs",
             {k: errs(out[k][part], out["cpu"][part], rel=True)
              for k in ("card", wrong)},
             MP_STEP_TOL[part] if mixed else TRAIN_STEP_TOL,
             right=("card",),
             wrong=(wrong,) if part in ("gradients", "Adam mu") else ())


def phase_reference(steps: int) -> None:
    """Flagship width cut to two blocks, f32, a small batch: the card
    (kernels, cuBLAS) against the CPU (plain twins, the path the CPU tests
    hold against ldt_tpu), same weights and inputs. The sampler and the
    decoder are held apart: with random weights the latents reach |x| ~ 1e3,
    where the decoder's softmaxes are near one-hot and a 1e-6 change of a
    latent moves the cloud by a quarter of its scale. So the decoder is
    checked on N(0, 1) latents, the scale of a trained model's."""
    import torch

    from ldt_torch.configs import compressor_cfg, score_cfg, sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import sample_latents
    from ldt_torch.models import Compressor, Score

    batch = 4
    g = torch.Generator().manual_seed(SEED)
    score = Score(score_cfg(num_blocks=2), device="cpu", generator=g).eval()
    comp = Compressor(compressor_cfg(), device="cpu", generator=g).eval()
    shape = (batch, score.cfg.z_scale, score.cfg.z_dim)
    x0 = torch.randn(shape, generator=g)
    noise = torch.randn((steps,) + shape, generator=g)
    eps = torch.randn(shape, generator=g)
    runs = {"cpu": ("cpu", None), "card": ("cuda", None),
            "wrong": ("cuda", variants(torch.float32)["wrong"])}
    out = {}
    for run, (dev, variant) in runs.items():
        patches = attention_patches(*variant) if variant else ()
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            sde = make_diffusion(sde_cfg(sample_N=steps), device=dev)
            latents = sample_latents(score.to(dev), sde, batch, steps,
                                     device=dev, x0=x0, noise=noise)
            with torch.inference_mode():
                clouds = comp.to(dev).sample((batch, comp.cfg.outsize),
                                             eps.to(dev))
        out[run] = {"sampler": latents.cpu(), "decoder": clouds.cpu()}
    print(f"[6] reference: 2 blocks at flagship width, f32, {steps} sampler "
          f"steps, B={batch}, card vs CPU")
    for part in ("sampler", "decoder"):
        if not torch.isfinite(out["card"][part]).all():
            fail(f"phase 6 {part} output is not finite")
        held(f"{part} (relative), CPU vs",
             {k: errs(out[k][part], out["cpu"][part], rel=True)
              for k in ("card", "wrong")}, REF_TOL[part], right=("card",))


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def rel_errs(got, want):
    """(max, mean) over pairs of |got - want| / |want|."""
    want = want.double().cpu()
    rel = ((got.double().cpu() - want).abs()
           / want.abs().clamp(min=1e-30))  # 0 / 0 (a cloud's CD to itself)
    return rel.max().item(), rel.mean().item()


def eval_pairs(p: int, n: int, seed: int):
    """p pairs of n-point clouds at ShapeNet's scale on the card: even pairs
    a shape and its copy jittered by 0.01, odd pairs two shapes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = synthetic_shapes(p, n, rng)
    y = synthetic_shapes(p, n, rng)
    y[::2] = x[::2] + 0.01 * rng.standard_normal(x[::2].shape)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())


def cd_variant(x, y, one_direction: bool = False, on_sqrt: bool = False,
               drop_rows=None):
    """K5's twin with a slip: 2 mean(dist1) (one direction), the means of
    sqrt(dist) (the l1 loss's form, not the metric's), or the column minima
    taken without the rows `drop_rows` (a slice: one row tile of the split
    schedule left out of the merge)."""
    import torch

    from ldt_torch.ops.chamfer import chamfer_distance

    d1, d2, _, _ = chamfer_distance(x, y)
    if drop_rows is not None:
        keep = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
        keep[drop_rows] = False
        d2 = chamfer_distance(x[:, keep], y)[1]
    if on_sqrt:
        d1, d2 = torch.sqrt(d1), torch.sqrt(d2)
    return 2 * d1.mean(dim=1) if one_direction else d1.mean(dim=1) + \
        d2.mean(dim=1)


def emd_variant(x, y, levels: int = 9, clamp: bool = True,
                on_sqrt: bool = True, dtype=None):
    """The approx-match cost of N == M clouds written out, with knobs for
    the wrong variants: `levels` from -4^7 (9: down to -4^-1), the
    min(., 1) consumption clamp, the cost on sqrt(d) or on d; `dtype`
    float64 gives the "f64" reading."""
    import torch

    from ldt_torch.ops.geometry import square_distance

    d = torch.clamp(square_distance(x, y), min=0.0)
    if dtype is not None:
        d = d.to(dtype)
    p, n, m = d.shape
    cost_d = torch.sqrt(torch.clamp(d, min=1e-20)) if on_sqrt else d
    rl = torch.ones(p, n, dtype=d.dtype, device=d.device)
    rr = torch.ones(p, m, dtype=d.dtype, device=d.device)
    cost = torch.zeros(p, dtype=d.dtype, device=d.device)
    for j in range(7, 7 - levels, -1):
        w = torch.exp(-(4.0 ** j) * d)
        ratio_l = rl / (1e-9 + (w @ rr[:, :, None])[:, :, 0])
        sumr = (ratio_l[:, None, :] @ w)[:, 0, :] * rr
        cons = rr / (sumr + 1e-9)
        ratio_r = (torch.clamp(cons, max=1.0) if clamp else cons) * rr
        cost = cost + (ratio_l[:, None, :] @ (
            (w * cost_d) @ ratio_r[:, :, None]))[:, 0, 0]
        rl = torch.clamp(rl - ratio_l * (w @ ratio_r[:, :, None])[:, :, 0],
                         min=0.0)
        rr = torch.clamp(rr - sumr, min=0.0)
    return cost


def emd_cluster_launched(x, y, otf: bool = False) -> int:
    """The cluster size (0: the block schedule) that the library reports
    for K6 (K7 with `otf`) on x, y; fails unless it is the one
    `_eval_kernels.emd_schedule` expects on this card."""
    import torch

    from ldt_torch.ops import _eval_kernels
    from ldt_torch.ops.geometry import square_distance

    p, n, m = x.shape[0], x.shape[1], y.shape[1]
    d = torch.clamp(square_distance(x, y), min=0.0)
    out = torch.empty(p, device=x.device)
    cluster = ctypes.c_int(-1)
    _eval_kernels.raise_on(_eval_kernels.lib().ldt_approx_match_cost(
        x.data_ptr(), y.data_ptr(), d.data_ptr(), out.data_ptr(), p, n, m,
        int(otf), _eval_kernels.stream(x), ctypes.byref(cluster)),
        "approx_match_cost")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    schedule, c = _eval_kernels.emd_schedule(p, n, m, otf, sms)
    want = c if schedule == "cluster" else 0
    if cluster.value != want:
        fail(f"phase 18: K6/K7 at {p} pairs of {n} x {m} launched cluster "
             f"size {cluster.value}; the rule says {want} on {sms} SMs")
    return cluster.value


def cd_cluster_launched(x, y) -> int:
    """The cluster size (0: the block schedule) that the library reports
    for K5 on x, y; fails unless it is the one its rule
    (`_eval_kernels.cd_schedule`, asked without a launch) gives on this
    card."""
    import torch

    from ldt_torch.ops import _eval_kernels

    p, n, m = x.shape[0], x.shape[1], y.shape[1]
    out = torch.empty(p, device=x.device)
    cluster = ctypes.c_int(-1)
    _eval_kernels.raise_on(_eval_kernels.lib().ldt_pairwise_cd_means(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), p, n, m,
        _eval_kernels.stream(x), ctypes.byref(cluster)), "pairwise_cd_means")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    aligned = y.data_ptr() % 16 == 0
    want = _eval_kernels.cd_schedule(p, n, m, sms, aligned)
    if cluster.value != want:
        fail(f"phase 18: K5 at {p} pairs of {n} x {m} launched cluster size "
             f"{cluster.value}; the rule says {want} on {sms} SMs")
    return cluster.value


def phase_eval_kernels() -> dict:
    """Phase 18: K5 and K6/K7 against their twins and wrong variants, K6 ==
    K7, repeatability, one pair against the exact optimum; times at a full
    eval tile."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment

    from ldt_torch.ops import _eval_kernels
    from ldt_torch.ops import chamfer, emd
    from ldt_torch.ops.geometry import square_distance

    p, n = EVAL_PAIRS, EVAL_POINTS
    x, y = eval_pairs(p, n, SEED)
    xc, yc = x.cpu(), y.cpu()
    # K5, on its split schedule
    cd_fn = chamfer.pairwise_cd_means
    before = cd_fn.split_launches
    got = cd_fn(x, y)
    c = cd_cluster_launched(x, y)
    if cd_fn.split_launches != before + 1 or c == 0:
        fail("phase 18: K5 did not take its split schedule")
    rb = -(-n // c)  # rows of a block of the cluster
    readings = {
        "twin": rel_errs(got, chamfer.pairwise_cd_means_plain(x, y)),
        "cpu twin": rel_errs(got, chamfer.pairwise_cd_means_plain(xc, yc)),
        "one direction": rel_errs(got, cd_variant(x, y, one_direction=True)),
        "on sqrt d": rel_errs(got, cd_variant(x, y, on_sqrt=True)),
        "one row tile's column minima dropped": rel_errs(
            got, cd_variant(x, y, drop_rows=slice(rb, 2 * rb)))}
    alone = cd_fn(x[:1], y[:1])
    print(f"[18] pairwise_cd_means (K5, split schedule, cluster size {c}; "
          f"one pair: {cd_cluster_launched(x[:1], y[:1])}), {p} pairs of "
          f"{n}-point clouds, f32: cd {got.min().item():.6f}.."
          f"{got.max().item():.6f}; pair 0 alone == in the tile: "
          f"{torch.equal(alone, got[:1])}")
    held("K5 (relative per pair) vs", readings, K5_TOL,
         right=("twin", "cpu twin"),
         wrong=("one direction", "on sqrt d",
                "one row tile's column minima dropped"))
    if not torch.equal(got, cd_fn(x, y)):
        fail("phase 18: K5 did not repeat its bits")
    if not torch.equal(alone, got[:1]):
        fail("phase 18: a pair's K5 value depends on its tile")
    old = cd_fn(x, unaligned_copy(y))  # the block schedule (the rule)
    held("K5 block schedule (unaligned y; relative per pair) vs",
         {"twin": rel_errs(old, chamfer.pairwise_cd_means_plain(x, y))},
         K5_TOL, right=("twin",), wrong=())
    # K6 / K7
    k6 = emd.approx_match_cost(x, y)
    k7 = emd.approx_match_cost(x, y, otf=True)
    same = torch.equal(k6, k7)
    repeat = torch.equal(k6, emd.approx_match_cost(x, y)) and torch.equal(
        k7, emd.approx_match_cost(x, y, otf=True))
    t0 = time.perf_counter()
    cpu_twin = emd.approx_match_cost_plain(xc, yc)
    cpu_s = time.perf_counter() - t0
    readings = {
        "twin": rel_errs(k6, emd.approx_match_cost_plain(x, y)),
        "cpu twin": rel_errs(k6, cpu_twin),
        "f64": rel_errs(k6, emd_variant(x, y, dtype=torch.float64)),
        "8 levels": rel_errs(k6, emd_variant(x, y, levels=8)),
        "no clamp": rel_errs(k6, emd_variant(x, y, clamp=False)),
        "cost on d": rel_errs(k6, emd_variant(x, y, on_sqrt=False))}
    print(f"[18] approx_match_cost (K6 d streamed, K7 d on the fly), {p} "
          f"pairs: emd {k6.min().item() / n:.6f}..{k6.max().item() / n:.6f};"
          f" K6 == K7 bit for bit: {same}; each repeats its bits: {repeat}; "
          f"CPU twin {cpu_s:.2f} s")
    held("K6/K7 (relative per pair) vs", readings, K6_TOL,
         right=("twin", "cpu twin", "f64"),
         wrong=("8 levels", "no clamp", "cost on d"))
    if not (same and repeat):
        fail("phase 18: K6 and K7 differ, or a run did not repeat its bits")
    # the cluster schedule: a pair's cost does not depend on its tile (one
    # pair alone runs in a cluster of 8)
    alone = emd.approx_match_cost(x[:1], y[:1])
    print(f"[18] K6/K7 cluster size at {p} pairs: "
          f"{emd_cluster_launched(x, y)}, at 1 pair: "
          f"{emd_cluster_launched(x[:1], y[:1])}; pair 0 alone == "
          f"in the tile: {torch.equal(alone, k6[:1])}")
    if not torch.equal(alone, k6[:1]):
        fail("phase 18: a pair's K6 cost depends on its tile")
    # one pair of two shapes against the exact optimum
    a, b = xc[1].double().numpy(), yc[1].double().numpy()
    dist = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    r, c = linear_sum_assignment(dist)
    exact = dist[r, c].mean()
    approx = k6[1].item() / n
    print(f"[18] pair 1 against the exact optimum (linear_sum_assignment): "
          f"exact {exact:.6f}, approx {approx:.6f}, ratio "
          f"{approx / exact:.4f} (bounds: >= exact - 1e-4, <= 1.35 exact)")
    if not exact - 1e-4 <= approx <= 1.35 * exact:
        fail("phase 18: the approx-match cost leaves the exact bounds")

    # times at a full eval tile: compute_all_metrics(.., 128) on 64 x 64
    # clouds takes 64 pairs per tile
    tp = 64
    x, y = eval_pairs(tp, n, SEED + 1)
    d = torch.clamp(square_distance(x, y), min=0.0)
    out = torch.empty(tp, device=x.device)
    lib, stream = _eval_kernels.lib(), _eval_kernels.stream(x)
    cluster = ctypes.c_int(0)

    def k6_kernel():  # the launch alone, on a d built once
        _eval_kernels.raise_on(lib.ldt_approx_match_cost(
            x.data_ptr(), y.data_ptr(), d.data_ptr(), out.data_ptr(), tp, n,
            n, 0, stream, ctypes.byref(cluster)), "approx_match_cost")

    tile_cluster = {otf: emd_cluster_launched(x, y, otf)
                    for otf in (False, True)}

    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    exp_rate = 16 * sms * clock  # SFU exponentials per second
    nm = tp * n * n
    cloud_bytes = 2 * tp * n * 3 * 4 + 4 * tp
    bounds = {
        # The least work K5's function needs under K5_TOL: 8 instructions
        # per (i, j), three differences, a square, two FMAs (fmaf(dz, dz,
        # fmaf(dy, dy, dx * dx)): each d within 2 ulps of the rounded
        # direct form, and the means the same at the eval's 2048 points,
        # tests/test_torch_port_cd_split.py), a row and a column minimum;
        # issued at 128 lanes per SM per clock. The expanded form
        # |x|^2 - 2 x.y + |y|^2 (4 + 2) misses K5_TOL's mean (2.0e-6 on
        # eight eval pairs, the same test). The two minima run on the ALU
        # pipe (64 lanes per SM per clock in the CUDA C Programming Guide's
        # throughput table for compute capability 9.0: "compare, minimum,
        # maximum"), 2 / 64 = 4 / 128 of a clock per element, below the
        # issue's 8 / 128: issue bounds it. The kernel itself issues 10
        # (no FMA, so that the minima keep the CPU's bits): `model` below.
        "pairwise_cd_means": {"bytes": cloud_bytes,
                              "issue": 8 * nm / (128 * sms * clock),
                              "alu": 2 * nm / (64 * sms * clock)},
        # per level and (i, j): one exponential on the SFUs; four FMAs (the
        # row sum, the column sum, the cost, the row drain) = 8 flops
        "approx_match_cost": {"bytes": 4 * nm + 4 * tp,
                              "exp": 9 * nm / exp_rate,
                              "fma": 9 * 8 * nm / PEAK_FLOPS["float32"]},
        "approx_match_cost_otf": {"bytes": cloud_bytes,
                                  "exp": 9 * nm / exp_rate,
                                  "fma": 9 * 8 * nm / PEAK_FLOPS["float32"]},
    }
    emd_twin_ms = cuda_ms(lambda: emd.approx_match_cost_plain(x, y), 3, 1)
    # K5's split schedule and, through an unaligned copy of y (the rule), the
    # block schedule it replaces: event loop and device time per call
    yu = unaligned_copy(y)
    k5_parts = launch_us(lambda: chamfer.pairwise_cd_means(x, y))
    pr5_parts = launch_us(lambda: chamfer.pairwise_cd_means(x, yu))
    if list(k5_parts) != ["pairwise_cd_split_kernel"] or \
            list(pr5_parts) != ["pairwise_cd_means_kernel"]:
        fail(f"phase 18: K5 ran {list(k5_parts)} (aligned) and "
             f"{list(pr5_parts)} (unaligned y)")
    k5 = {"device_ms": sum(k5_parts.values()) / 1e3,
          "pr5_ms": cuda_ms(lambda: chamfer.pairwise_cd_means(x, yu), 20, 2),
          "pr5_device_ms": sum(pr5_parts.values()) / 1e3}
    # the kernels' own issue model (above the bound's 8): the split
    # schedule ~10.4 instructions per element on the card, the block
    # schedule 18 on min(pairs, SMs) SMs
    model = {"split": 10.44 * nm / (128 * sms * clock) * 1e3,
             "pr5": 18 * nm / (128 * min(tp, sms) * clock) * 1e3}
    times = {
        "pairwise_cd_means": (
            cuda_ms(lambda: chamfer.pairwise_cd_means(x, y), 20, 2),
            cuda_ms(lambda: chamfer.pairwise_cd_means_plain(x, y), 3, 1)),
        "approx_match_cost": (cuda_ms(k6_kernel, 5, 1), emd_twin_ms),
        "approx_match_cost_otf": (cuda_ms(
            lambda: emd.approx_match_cost(x, y, otf=True), 5, 1),
            emd_twin_ms)}
    wrapper_ms = cuda_ms(lambda: emd.approx_match_cost(x, y), 5, 1)
    twin = emd.approx_match_cost_plain(x, y)
    max_err = {
        "pairwise_cd_means": (chamfer.pairwise_cd_means(x, y)
                              - chamfer.pairwise_cd_means_plain(x, y)
                              ).abs().max().item(),
        "approx_match_cost": (emd.approx_match_cost(x, y)
                              - twin).abs().max().item(),
        "approx_match_cost_otf": (emd.approx_match_cost(x, y, otf=True)
                                  - twin).abs().max().item()}
    replaces = {"pairwise_cd_means": "ldt_tpu/ops/chamfer.py:135",
                "approx_match_cost": "ldt_tpu/ops/emd.py:381",
                "approx_match_cost_otf": "ldt_tpu/ops/emd.py:465"}
    rows = {}
    for name, b in bounds.items():
        t_bytes = b["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = max(v for k, v in b.items() if k != "bytes") * 1e3
        bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                              else (t_ops, "operations"))
        ms, plain_ms = times[name]
        otf = name.endswith("otf")
        print(f"[18] {name} at the eval tile ({tp} pairs of {n} points): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}; bytes {t_bytes:.4f} ms, "
              + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in b.items()
                          if k != "bytes")
              + f"; SFU rate at {clock / 1e6:.0f} MHz), library: none"
              + (f"; cluster size {tile_cluster[otf]}"
                 if name.startswith("approx") else "")
              + (f"; with the d build {wrapper_ms:.4f} ms"
                 if name == "approx_match_cost" else "")
              + f" ({smi_name_and_power()})")
        rows[name] = {"name": name, "route": "cuda",
                      "source": "ldt_torch/csrc/eval.cu",
                      "replaces": replaces[name], "launches": 0,
                      "max_abs_err": max_err[name], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None}
    rows["pairwise_cd_means"].update(k5)
    print(f"[18] pairwise_cd_means at the eval tile: split schedule device "
          f"time {k5['device_ms']:.4f} ms (issue model {model['split']:.4f} "
          f"ms); the block schedule it replaces (unaligned y): kernel "
          f"{k5['pr5_ms']:.4f} ms, device {k5['pr5_device_ms']:.4f} ms "
          f"(issue model {model['pr5']:.4f} ms) ({smi_name_and_power()})")
    return rows

def tile_launches(ns: int, nr: int, batch: int, points: int,
                  symmetric: bool = False) -> int:
    """Tiles (= K5 launches, and K6 ones with the EMD) of one pair matrix,
    from `eval.metrics._tile_shape`."""
    from ldt_torch.eval import metrics

    sb, rb = metrics._tile_shape(ns, nr, batch, None, points, points,
                                 symmetric)
    return sum(1 for s0, _ in metrics._iter_blocks(ns, sb)
               for _, r1 in metrics._iter_blocks(nr, rb)
               if not (symmetric and r1 <= s0))


def eval_sets(count: int, points: int, seed: int):
    """(samples, references) numpy [count, points, 3]: references are
    shapes; the first half of the samples are references jittered by 0.01,
    the rest other shapes (so COV and 1-NNA sit away from their ends)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ref = synthetic_shapes(count, points, rng)
    smp = synthetic_shapes(count, points, rng)
    half = count // 2
    smp[:half] = ref[:half] + 0.01 * rng.standard_normal(
        ref[:half].shape).astype(np.float32)
    return smp, ref


def phase_eval(stage1) -> dict:
    """Phase 19: the eval path at full width; returns the K5/K6/K7 launch
    counts summed over its runs."""
    import numpy as np
    import torch

    from ldt_torch.configs import latent_trainer_cfg
    from ldt_torch.eval import metrics
    from ldt_torch.training.latent_sde_trainer import Trainer

    count, n = EVAL_SET, EVAL_POINTS
    smp, ref = eval_sets(count, n, SEED)
    pairs = 3 * count * count
    per = tile_launches(count, count, 128, n)
    # the test loader: 4 batches of normalized clouds (the references), each
    # with the shift and scale of its raw cloud
    rng = np.random.default_rng(SEED + 1)
    bs = count // 4
    loader = [{"te_points": ref[bs * b:bs * (b + 1)],
               "shift": rng.uniform(-1.0, 1.0, (bs, 1, 3)).astype(np.float32),
               "scale": rng.uniform(0.5, 2.0, (bs, 1, 1)).astype(np.float32)}
              for b in range(4)]
    layers = stage1.cfg.model.n_layers
    cfg = latent_trainer_cfg(sde=dict(sample_N=CHECK_STEPS))
    stage2 = Trainer(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(SEED))
    stage2.maybe_init({"tr_points": torch.from_numpy(ref[:2]).cuda()},
                      compressor_weights=stage1.model.state_dict())
    s2_pairs = tile_launches(bs, bs, 64, n)
    blocks = stage2.cfg.score.num_blocks
    runs = {
        "compute_all_metrics(smp, ref, 128)": (
            lambda: metrics.compute_all_metrics(smp, ref, 128,
                                                verbose=False),
            dict(pairwise_cd_means=3 * per, approx_match_cost=3 * per)),
        "compute_CD_metrics(smp, ref, 256)": (
            lambda: metrics.compute_CD_metrics(smp, ref, 256, verbose=False),
            dict(pairwise_cd_means=tile_launches(count, count, 256, n)
                 + 2 * tile_launches(count, count, 256, n, True))),
        "EMD_CD(smp, ref, 64, emd_otf=True)": (
            lambda: metrics.EMD_CD(smp, ref, 64, emd_otf=True),
            dict(pairwise_cd_means=1, approx_match_cost=1,
                 approx_match_cost_otf=1)),
        "jsd_between_point_cloud_sets(smp / 2, ref / 2)": (
            lambda: {"jsd": metrics.jsd_between_point_cloud_sets(
                smp / 2, ref / 2)}, {}),
        # per encode: per layer 2 encoder blocks, a posterior over the
        # decoded set (K2's tiled schedule but in the first layer, which
        # has no decoded set yet) and a decoder block; per decode: a
        # decoder block per layer
        f"stage-1 reconstruction (4 x {bs} clouds)": (
            lambda: stage1.reconstruction(loader),
            dict(cross_attention=4 * 4 * layers,
                 cross_attention_tiled=4 * (layers - 1),
                 pairwise_cd_means=3 * per, approx_match_cost=3 * per)),
        f"stage-1 valsample (4 x {bs} clouds)": (
            lambda: stage1.valsample(loader, n),
            dict(cross_attention=4 * layers, pairwise_cd_means=3 * per,
                 approx_match_cost=3 * per)),
        f"stage-2 valsample ({bs} clouds, {CHECK_STEPS} steps)": (
            lambda: stage2.valsample(loader[:1]),
            dict(packed_self_attention=blocks * CHECK_STEPS,
                 **k1_schedule_launches(stage2.score, blocks * CHECK_STEPS),
                 cross_attention=stage2.cfg.compressor.n_layers,
                 pairwise_cd_means=3 * s2_pairs,
                 approx_match_cost=3 * s2_pairs)),
    }
    totals = dict.fromkeys(("pairwise_cd_means", "approx_match_cost",
                            "approx_match_cost_otf"), 0)
    card = smi_name_and_power()
    for what, (fn, expect) in runs.items():
        with contextlib.redirect_stdout(io.StringIO()):
            res, dt, launches = counted(fn)
        expect = per_step_launches(**expect)
        # every cloud has 2048 points: K5 takes the split schedule, K6/K7
        # the cluster one
        expect["pairwise_cd_means_split"] = expect["pairwise_cd_means"]
        expect["approx_match_cost_cluster"] = expect["approx_match_cost"]
        values = {k: float(v) for k, v in res.items()}
        rate = (f", {pairs / dt:.1f} pairs/s" if what.startswith(
            "compute_all") else "")
        print(f"[19] {what}: {dt:.3f} s{rate} ({card}); "
              + ", ".join(f"{k} {v:.6g}" for k, v in values.items())
              + f"; launches {launches} (expected {expect})")
        if launches != expect:
            fail(f"phase 19 {what}: launch counts differ from the tiles'")
        if not all(np.isfinite(v) for v in values.values()):
            fail(f"phase 19 {what}: a value is not finite")
        emd_key = [k for k in values if k.endswith("mmd-EMD")]
        # the random-weight stage-2 sampler's clouds are ~1e2 across, where
        # the annealing's exp underflows and the EMD may be 0
        if emd_key and not what.startswith("stage-2") and \
                not values[emd_key[0]] > 0:
            fail(f"phase 19 {what}: mmd-EMD is not positive")
        for k in totals:
            totals[k] += launches[k]
    # one matrix's tiles under the profiler: 8 tiles of 64 pairs
    from torch.profiler import ProfilerActivity, profile

    metrics.pairwise_EMD_CD(ref[:1], smp, 128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        metrics.pairwise_EMD_CD(ref[:8], smp, 128)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_kernel = device_time_by_kernel(prof)
    busy = sum(by_kernel.values()) / 1e3
    classes = {"K6 (approx_match_cost_kernel)": "approx_match",
               "K5 (pairwise_cd_split_kernel)": "pairwise_cd",
               "other (the d build's elementwise passes, copies)": ""}
    shares = dict.fromkeys(classes, 0.0)
    for key, us in by_kernel.items():
        for cname, tag in classes.items():
            if tag and tag in key or not tag:
                shares[cname] += us / 1e3
                break
    print(f"[19] profile of pairwise_EMD_CD(ref[:8], smp, 128), 8 tiles of "
          f"64 pairs: device busy {busy:.2f} ms, profiled wall {wall:.2f} ms"
          f" (idle share {1 - busy / wall:.3f}); " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in shares.items()))
    return totals

def margin(mat, axis: int) -> float:
    """The least relative gap, over the lines along `axis`, between the
    smallest entry and the runner-up."""
    import numpy as np

    s = np.sort(mat, axis=axis)
    first, second = np.take(s, 0, axis), np.take(s, 1, axis)
    return float(((second - first) / np.abs(second)).min())


def knn_margin(mxx, mxy, myy) -> float:
    """`margin` of the 1-NN test's nearest neighbours: over the columns of
    the [ref, smp] x [ref, smp] matrix without its diagonal."""
    import numpy as np

    mat = np.block([[mxx, mxy], [mxy.T, myy]]).astype(np.float64)
    np.fill_diagonal(mat, np.inf)
    return margin(mat, 0)


def phase_eval_reference() -> None:
    """Phase 20: `compute_all_metrics` on 8 x 8 clouds on the card (K5, K6)
    and on the CPU (the twins the CPU tests hold against ldt_tpu), and on
    the card with wrong kernels (K5 one direction, K6 without its last
    level): the matrices under K5_TOL / K6_TOL, the metric dicts on sets
    with margin; and the JSD, card == CPU."""
    import torch

    from ldt_torch.eval import metrics

    smp, ref = eval_sets(8, EVAL_POINTS, SEED + 2)
    runs = {"cpu": ("cpu", False), "card": ("cuda", False),
            "wrong": ("cuda", True)}
    out = {}
    for run, (dev, wrong) in runs.items():
        mats = []
        real = metrics.pairwise_EMD_CD

        def record(*a, **kw):
            mats.append(real(*a, **kw))
            return mats[-1]

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(metrics, "pairwise_EMD_CD",
                                                  record))
            if wrong:
                stack.enter_context(mock.patch.object(
                    metrics, "pairwise_cd_means",
                    lambda x, y: cd_variant(x, y, one_direction=True)))
                stack.enter_context(mock.patch.object(
                    metrics, "approx_match_cost",
                    lambda x, y, otf=False: emd_variant(x, y, levels=8)))
            t0 = time.perf_counter()
            res = metrics.compute_all_metrics(smp, ref, 128, verbose=False,
                                              device=dev)
        out[run] = (res, mats, time.perf_counter() - t0)
    print(f"[20] compute_all_metrics on 8 x 8 clouds of {EVAL_POINTS} "
          f"points: CPU {out['cpu'][2]:.2f} s, card {out['card'][2]:.3f} s")
    names = ("ref x smp", "ref x ref", "smp x smp")
    for i, what in enumerate(names):
        for j, (kind, tol) in enumerate((("CD", K5_TOL), ("EMD", K6_TOL))):
            want = torch.from_numpy(out["cpu"][1][i][j]).flatten()
            held(f"{kind} matrix {what} (relative per pair), CPU vs",
                 {k: rel_errs(torch.from_numpy(out[k][1][i][j]).flatten(),
                              want) for k in ("card", "wrong")}, tol,
                 right=("card",), wrong=("wrong",))
    # the argmin-derived metrics: exactly, where every nearest neighbour
    # beats its runner-up by > 1e-4 relative (asserted on the CPU's
    # matrices): two entries within K6_TOL[0] = 3e-5 of their values cannot
    # change places then
    rs_cd, rs_emd = out["cpu"][1][0]
    rr, ss = out["cpu"][1][1], out["cpu"][1][2]
    margins = []
    for m_rs, m_rr, m_ss in ((rs_cd, rr[0], ss[0]), (rs_emd, rr[1], ss[1])):
        margins += [margin(m_rs.T, 1), knn_margin(m_rr, m_rs, m_ss)]
    print(f"[20] nearest-neighbour margins (relative; COV-CD, 1-NNA-CD, "
          f"COV-EMD, 1-NNA-EMD): " + ", ".join(f"{v:.3e}" for v in margins))
    if min(margins) <= 1e-4:
        fail("phase 20: the sets have no margin for the argmin metrics")
    cpu_res, card_res = out["cpu"][0], out["card"][0]
    worst = 0.0
    for k, v in cpu_res.items():
        if "cov" in k or "acc" in k:
            if card_res[k] != v:
                fail(f"phase 20: {k} card {card_res[k]} vs CPU {v}")
        else:
            worst = max(worst, abs(card_res[k] - v) / abs(v))
    print(f"[20] metric dicts, card vs CPU: COV and 1-NNA equal; the MMDs "
          f"within {worst:.3e} relative (limit {K6_TOL[0]:g}): "
          + ", ".join(f"{k} {v:.6g}" for k, v in card_res.items()))
    if worst > K6_TOL[0]:
        fail("phase 20: an MMD differs between the card and the CPU")
    jsd = {dev: metrics.jsd_between_point_cloud_sets(smp / 2, ref / 2,
                                                     device=dev)
           for dev in ("cpu", "cuda")}
    print(f"[20] JSD (clouds halved into the unit grid's sphere): card "
          f"{jsd['cuda']:.8f}, CPU {jsd['cpu']:.8f} (the same nearest "
          f"cells: direct-form distances have the same bits on both)")
    if jsd["cuda"] != jsd["cpu"]:
        fail("phase 20: the JSD differs between the card and the CPU")


# Phase 21: the training entries. The configs' cuts (the models keep their
# published width and depth; the data, the epochs and the cadences shrink
# so that both stages, a save, a resume and the evaluations run in about a
# minute).
ENTRY_TRAIN, ENTRY_VAL = 64, 16   # synthetic PC15k clouds of 15000 points
ENTRY_CUTS = {
    "Compressor_Trainer": {"common.epochs": 2, "log.save_epoch_freq": 1,
                           "log.eval_epoch_freq": 2,
                           "log.log_epoch_freq": 1},
    "Latent_Diffusion_Trainer": {"common.epochs": 2,
                                 "log.save_epoch_freq": 2,
                                 "log.eval_epoch_freq": 2,
                                 "log.log_epoch_freq": 1,
                                 "sde.sample_N": CHECK_STEPS},
}


def synthetic_tree(data_dir: str, synsets, train: int, val: int,
                   seed: int) -> None:
    """A PC15k tree under `data_dir`: for each synset, `train` and `val`
    clouds of 15000 points (`synthetic_shapes`), m000.npy on."""
    import os

    import numpy as np

    per = train + val
    clouds = synthetic_shapes(per * len(synsets), 15000,
                              np.random.default_rng(seed))
    for k, synset in enumerate(synsets):
        part = clouds[k * per:(k + 1) * per]
        for split, sub in (("train", part[:train]), ("val", part[train:])):
            d = os.path.join(data_dir, synset, split)
            os.makedirs(d)
            for i, cloud in enumerate(sub):
                np.save(os.path.join(d, f"m{i:03d}.npy"), cloud)


def copied_config(src: str, dst: str, edits: dict, tag: str,
                  phase: str = "21", added: dict = None) -> None:
    """Copy the YAML file `src` to `dst` with `edits` {"section.key":
    value} replaced on their lines and `added` {"section.key": value} keys
    it lacks written at the head of their section; print each change."""
    import os
    import re

    from ldt_torch.tools.io import load_yaml

    old = load_yaml(src)
    lines = open(src).read().splitlines()
    section, done = None, set()

    def text(value):
        return f"'{value}'" if isinstance(value, str) else str(value)

    for i, line in enumerate(lines):
        top = re.match(r"(\w+):\s*$", line)
        if top:
            section = top.group(1)
        key = re.match(r"  (\w+):", line)
        name = f"{section}.{key.group(1)}" if key else None
        if name in edits:
            value = edits[name]
            lines[i] = f"  {key.group(1)}: {text(value)}"
            done.add(name)
            print(f"[{phase}] {tag}: {name} {old[section][key.group(1)]!r} "
                  f"-> {value!r}")
    if done != set(edits):
        fail(f"phase {phase}: {src} has no {sorted(set(edits) - done)}")
    for name, value in (added or {}).items():
        section, key = name.split(".")
        if section not in old or key in old[section]:
            fail(f"phase {phase}: {src} has no section {section} or has "
                 f"{name} already")
        at = lines.index(f"{section}:") + 1
        lines.insert(at, f"  {key}: {text(value)}")
        print(f"[{phase}] {tag}: {name} (not set) -> {value!r}")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        f.write("\n".join(lines) + "\n")


def csv_rows(path: str) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def finite_rows(path: str, what: str, phase: str = "21") -> list:
    """The rows of a CSV log; fails unless every value but the epoch and
    itr columns is a finite number."""
    import math

    rows = csv_rows(path)
    for row in rows:
        for k, v in row.items():
            if k not in ("epoch", "itr") and not math.isfinite(float(v)):
                fail(f"phase {phase}: {what} {k} = {v} in {row}")
    return rows


def host_state(tree, moments_bf16: bool = False, path=()):
    """A CPU copy of a trainer's state tree (the moments rounded to bf16
    where the save stores them so)."""
    import torch

    if isinstance(tree, dict):
        return {k: host_state(v, moments_bf16, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        moment = moments_bf16 and ("mu" in path or "nu" in path)
        return tree.detach().to("cpu", torch.bfloat16 if moment
                                else tree.dtype, copy=True)
    return tree


def differing(live, saved, path="") -> list:
    """The leaves of the live state tree that are not equal to the saved
    copy (a bf16 moment: to its value cast back to f32)."""
    import torch

    if isinstance(saved, dict):
        if not isinstance(live, dict) or set(live) != set(saved):
            return [path or "/"]
        return [p for k in saved
                for p in differing(live[k], saved[k], f"{path}/{k}")]
    if isinstance(saved, torch.Tensor):
        got = live.detach().cpu()
        if not torch.equal(got, saved.to(got.dtype)):
            return [path]
        return []
    return [] if live == saved else [path]


def phase_entries() -> None:
    """Phase 21: the entries a user runs, on the card, from config files
    copied from `experiments/` (full width and depth, cuts printed) and a
    synthetic PC15k tree: stage 1 (`train_compressor`, 2 epochs, a save
    each, one reconstruction eval), stage 2 (`train_latent_diffusion`)
    through `load_pretrain` from stage 1's `.pt` for 2 epochs with one
    save and one `valsample`, a `--resume` leg that trains epoch 3, and
    `val_sample` on the saved samples. Every restored tensor must equal the
    state at its save, the counters must continue, every loss and metric
    must be finite, and K1-K6 must have run; prints each stage's seconds per
    epoch and the stage-2 checkpoint's save and load seconds and size."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ldt_torch.cli import get_config, get_parser
    from ldt_torch.entries import train_compressor as entry1
    from ldt_torch.entries import train_latent_diffusion as entry2
    from ldt_torch.entries import val_sample
    from ldt_torch.training import checkpoint as ckpt
    from ldt_torch.training.compressor_trainer import Trainer as Stage1
    from ldt_torch.training.latent_sde_trainer import Trainer as Stage2

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ldt_phase21_")
    cwd = os.getcwd()
    try:
        data_dir = os.path.join(tmp, "PC15k")
        synthetic_tree(data_dir, ("02691156",), ENTRY_TRAIN, ENTRY_VAL,
                       SEED + 21)
        print(f"[21] data: {ENTRY_TRAIN} train and {ENTRY_VAL} val clouds of "
              f"15000 points ({tmp}; the airplane split of ShapeNetCore.v2."
              f"PC15k holds thousands)")
        ws = os.path.join(tmp, "experiments")
        paths = {}
        for kind, cuts in ENTRY_CUTS.items():
            paths[kind] = os.path.join(ws, kind, "airplane")
            edits = dict(cuts, **{"data.data_dir": data_dir,
                                  "log.save_path": paths[kind]})
            if kind == "Latent_Diffusion_Trainer":
                edits["compressor.pretrain_path"] = os.path.join(
                    paths["Compressor_Trainer"], "checkpt_2.pt")
            copied_config(os.path.join(root, "experiments", kind, "airplane",
                                       "config.yaml"),
                          os.path.join(paths[kind], "config.yaml"), edits,
                          kind)

        saved, timing, seen = {}, {"epochs": {}}, {}

        def wrap(cls, name, after):
            real = getattr(cls, name)

            def run(self, *a, **kw):
                t0 = time.perf_counter()
                out = real(self, *a, **kw)
                torch.cuda.synchronize()
                after(self, time.perf_counter() - t0)
                return out
            return mock.patch.object(cls, name, run)

        def stage(self):
            return 1 if isinstance(self, Stage1) else 2

        def counters(self):
            return (self.epoch, self.itr, self._itr_epoch_start,
                    self.state.step)

        def before_save(self):
            if stage(self) == 2:
                need = sum(ckpt.tree_nbytes(t) for t in (
                    self.state.params, self.state.ema_params,
                    self.compressor.state_dict())) + sum(
                    ckpt.tree_nbytes(t) // 2 for t in (
                        self.state.opt_state.mu, self.state.opt_state.nu))
                free = shutil.disk_usage(tmp).free
                print(f"[21] before the stage-2 save: {free / 1e9:.2f} GB "
                      f"free under {tmp}, the checkpoint needs "
                      f"{need / 1e9:.2f} GB")
                if free < need * 1.05:
                    fail(f"phase 21: {free / 1e9:.2f} GB free under {tmp} "
                         f"cannot hold the {need / 1e9:.2f} GB checkpoint")

        def after_save(self, dt):
            s = stage(self)
            saved[s] = (host_state(self.state_tree(), s == 2),
                        counters(self))
            timing[f"save{s}"] = dt

        real_save = {1: Stage1.save, 2: Stage2.save}

        def save(self):
            before_save(self)
            t0 = time.perf_counter()
            real_save[stage(self)](self)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if stage(self) == 2:  # the write, on its thread: waited here
                t0 = time.perf_counter()
                ckpt.wait_pending_saves()
                timing["write"] = time.perf_counter() - t0
            after_save(self, dt)

        def after_resume(self, dt):
            timing["load"] = dt
            tree, (epoch, itr, _, step) = saved[2]
            bad = differing(self.state_tree(), tree)
            want = (epoch + 1, itr, itr, step)
            print(f"[21] resume: {dt:.3f} s; counters (epoch, itr, "
                  f"itr at the epoch's start, step) {counters(self)} "
                  f"(saved at {(epoch, itr, step)}); restored tensors "
                  f"that differ from the state at the save: {len(bad)}")
            if bad or counters(self) != want:
                fail(f"phase 21: the resumed state differs from the saved "
                     f"one: {bad[:5]}, counters {counters(self)} != {want}")
            seen["resumed"] = True

        def after_pretrain(self, dt):
            tree = saved[1][0]["state"]
            want = {**tree["params"], **tree["batch_stats"]}
            bad = differing(dict(self.compressor.state_dict()), want)
            print(f"[21] load_pretrain from stage 1's checkpt_2.pt: "
                  f"{dt:.3f} s; Compressor tensors that differ from stage "
                  f"1's at its save: {len(bad)}")
            if bad:
                fail(f"phase 21: load_pretrain gave other weights: {bad[:5]}")
            seen["pretrained"] = True

        def update_start(self):
            if self.itr == self._itr_epoch_start:
                torch.cuda.synchronize()
                timing["epochs"][(stage(self), self.epoch)] = [
                    time.perf_counter()]

        def epoch_end_time(self):
            torch.cuda.synchronize()
            timing["epochs"][(stage(self), self.epoch)].append(
                time.perf_counter())

        def hooked(cls):
            real_update, real_end = cls.update, cls.epoch_end

            def update(self, *a, **kw):
                update_start(self)
                return real_update(self, *a, **kw)

            def epoch_end(self):
                epoch_end_time(self)
                return real_end(self)
            return (mock.patch.object(cls, "update", update),
                    mock.patch.object(cls, "epoch_end", epoch_end))

        def args(kind, *extra):
            a = get_parser(kind).parse_args(["--save", ws, *extra])
            return a, get_config(a)

        def run_all():
            a, cfg = args("Compressor_Trainer")
            entry1.main(a, cfg)
            rows = {"stage1": csv_rows(os.path.join(
                paths["Compressor_Trainer"], "training.csv"))}
            a, cfg = args("Latent_Diffusion_Trainer")
            trainer = entry2.main(a, cfg)
            epochs = trainer.epoch
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            train_csv = os.path.join(paths["Latent_Diffusion_Trainer"],
                                     "training.csv")
            rows["stage2"] = csv_rows(train_csv)
            copied_config(os.path.join(paths["Latent_Diffusion_Trainer"],
                                       "config.yaml"),
                          os.path.join(paths["Latent_Diffusion_Trainer"],
                                       "config.yaml"),
                          {"common.epochs": 3}, "resume leg")
            a, cfg = args("Latent_Diffusion_Trainer", "--resume", "True")
            trainer = entry2.main(a, cfg)
            if (epochs, trainer.epoch) != (3, 4):
                fail(f"phase 21: stage 2 ended at epochs {epochs} and "
                     f"{trainer.epoch}, not 3 and 4")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            rows["resumed"] = csv_rows(train_csv)
            # val_sample reads test/<sample_path>/<dataset>/<sample> and
            # test/val_config.yaml under the working directory
            vs = os.path.join(tmp, "val_sample")
            os.makedirs(os.path.join(vs, "test", "smp", "airplane"))
            shutil.copy(os.path.join(paths["Latent_Diffusion_Trainer"],
                                     "smp_ep3.npy"),
                        os.path.join(vs, "test", "smp", "airplane"))
            copied_config(os.path.join(root, "test", "val_config.yaml"),
                          os.path.join(vs, "test", "val_config.yaml"),
                          {"data.data_dir": data_dir}, "val_sample")
            os.chdir(vs)
            res = val_sample.main(val_sample.get_parser().parse_args(
                ["--sample", "smp_ep3.npy", "--dataset", "airplane"]),
                val_sample.get_config())
            return rows, res

        with contextlib.ExitStack() as stack:
            for cls in (Stage1, Stage2):
                stack.enter_context(mock.patch.object(cls, "save", save))
                for p in hooked(cls):
                    stack.enter_context(p)
            stack.enter_context(wrap(Stage2, "resume", after_resume))
            stack.enter_context(wrap(Stage2, "load_pretrain",
                                     after_pretrain))
            (rows, res), dt, launches = counted(run_all)
        os.chdir(cwd)
        if not (seen.get("resumed") and seen.get("pretrained")):
            fail(f"phase 21: a restore was not checked: {seen}")
        for s, what in ((1, "stage 1 (B=16, 2048 points)"),
                        (2, "stage 2 (B=64)")):
            secs = [round(t[1] - t[0], 3) for (st, _), t in
                    sorted(timing["epochs"].items()) if st == s]
            print(f"[21] {what} seconds per epoch: {secs} "
                  f"({smi_name_and_power()})")
        size = os.path.getsize(os.path.join(paths["Latent_Diffusion_Trainer"],
                                            "checkpt_2.pt"))
        print(f"[21] stage-2 checkpoint: {size / 1e9:.3f} GB (f32 params "
              f"and EMA, bf16 moments); save {timing['save2']:.3f} s on the "
              f"step path (the copy to the host) + {timing['write']:.3f} s "
              f"of write on its thread (waited for at once here), load "
              f"(resume) {timing['load']:.3f} s; stage-1 checkpoint save "
              f"{timing['save1']:.3f} s ({smi_name_and_power()})")
        if len(rows["resumed"]) != len(rows["stage2"]) + 1:
            fail(f"phase 21: training.csv went from {len(rows['stage2'])} "
                 f"to {len(rows['resumed'])} rows over the resume leg")
        for kind in ENTRY_CUTS:
            for name in ("training.csv", "eval.csv", "test.csv"):
                finite_rows(os.path.join(paths[kind], name),
                            f"{kind} {name}")
        if not all(np.isfinite(v) for v in res.values()):
            fail(f"phase 21: val_sample gave {res}")
        print(f"[21] training.csv rows: stage 1 {len(rows['stage1'])}, "
              f"stage 2 {len(rows['stage2'])} then {len(rows['resumed'])}; "
              f"val_sample: {res}")
        k6 = launches["approx_match_cost"] - launches["approx_match_cost_otf"]
        ran = {"K1": launches["packed_self_attention"],
               "K2": launches["cross_attention"],
               "K3": launches["packed_self_attention_bwd"],
               "K4": launches["cross_attention_bwd"],
               "K5": launches["pairwise_cd_means"], "K6": k6}
        print(f"[21] the entries' run: {dt:.2f} s, launches {ran}")
        if not all(ran.values()):
            fail(f"phase 21: a kernel of the path did not run: {ran}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)

# Phase 22: the reference's head merge, and the 55-category configs. The
# categories of the synthetic tree (indices into the 55 of
# `ldt_torch.data.shapenet55`): airplane 0, car 13 and chair 14, the `all`
# config's val_cate.
ALL_SYNSETS = ("02691156", "02958343", "03001627")
VAL_CATE = 14
ALL_TRAIN, ALL_VAL = 16, 6  # synthetic clouds of 15000 points per synset
LABEL_BATCH = 32  # the label-conditioned generation (the config's batch)
# The cuts (the models keep their published width and depth): stage 1 two
# epochs with a save, then a resume leg of two epochs with one
# reconstruction eval; stage 2 one epoch with a save, then a resume leg of
# one epoch with one valsample.
ALL_CUTS = {
    "Compressor_Trainer": ({"common.epochs": 2, "log.save_epoch_freq": 2,
                            "log.eval_epoch_freq": 3,
                            "log.log_epoch_freq": 1},
                           {"common.epochs": 4}),
    "Latent_Diffusion_Trainer": ({"common.epochs": 1,
                                  "log.save_epoch_freq": 1,
                                  "log.eval_epoch_freq": 2,
                                  "log.log_epoch_freq": 1,
                                  "sde.sample_N": CHECK_STEPS},
                                 {"common.epochs": 2,
                                  "log.save_epoch_freq": 3}),
}


def phase_ref_merge_path() -> None:
    """Phase 22a, first half: the flagship Score cut to 2 blocks (hidden
    1024, 16 heads) and the full 6-block decoder, bf16, both built with the
    reference's head merge (`ref_merge=True`) on random weights from a
    generator of its own seeded with the seed (so that the readings do not
    depend on what the phases before drew): a short sampler run and the
    decode of N(0, 1) latents through the kernels (K1, K2), against the
    plain attention with the same merge and against the standard merge on
    the same weights, within phase 3's sampler limit (`MERGE_TOL`)."""
    import torch

    from ldt_torch.configs import compressor_cfg, score_cfg, sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import sample_latents
    from ldt_torch.models import Compressor, Score
    from ldt_torch.ops import attention as attn_ops

    batch, steps = BATCH, CHECK_STEPS
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scfg, ccfg = score_cfg(num_blocks=2), compressor_cfg()
    score_w = Score(scfg, device="cuda", generator=gen).state_dict()
    comp_w = Compressor(ccfg, device="cuda", generator=gen).state_dict()
    nets = {}
    for merge in (True, False):
        score = Score(scfg, dtype=torch.bfloat16, device="cuda",
                      ref_merge=merge).eval()
        score.load_state_dict(score_w)
        comp = Compressor(ccfg, dtype=torch.bfloat16, device="cuda",
                          ref_merge=merge).eval()
        comp.load_state_dict(comp_w)
        nets[merge] = (score, comp)
    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    shape = (batch, scfg.z_scale, scfg.z_dim)
    x0 = torch.randn(shape, device="cuda", generator=gen)
    noise = torch.randn((steps,) + shape, device="cuda", generator=gen)
    eps = torch.randn(shape, device="cuda", generator=gen)

    def run(merge=True):
        score, comp = nets[merge]
        lat = sample_latents(score, sde, batch, steps, device="cuda", x0=x0,
                             noise=noise)
        with torch.inference_mode():
            clouds = comp.sample((batch, ccfg.outsize), eps)
        return {"sampler": lat.float(), "decoder": clouds.float()}

    got, dt, launches = counted(run)
    want = {}
    with mock.patch.object(attn_ops, "packed_self_attention",
                           attn_ops.packed_self_attention_plain), \
            mock.patch.object(attn_ops, "cross_attention",
                              attn_ops.attention_plain):
        want["twin"] = run()
    want["standard merge"] = run(merge=False)
    k1, k2 = launches["packed_self_attention"], launches["cross_attention"]
    print(f"[22a] reference head merge, 2 Score blocks at flagship width "
          f"and the 6-block decoder, bf16: {steps} sampler steps at "
          f"B={batch} and the decode of N(0, 1) latents, {dt:.3f} s, "
          f"launches K1 {k1} K2 {k2}")
    if (k1, k2) != (scfg.num_blocks * steps, ccfg.n_layers):
        fail(f"phase 22a: launches K1 {k1}, K2 {k2}")
    if not all(torch.isfinite(t).all() for t in got.values()):
        fail("phase 22a: the merged path's output is not finite")
    # the 2-block random Score's attention moves its latents little, so
    # the sampler's standard-merge reading sits near the limit (6.0e-4 /
    # 6.8e-4 mean): the decoder and the train steps below tell the merge
    for part, wrong in (("sampler", ()), ("decoder", ("standard merge",))):
        held(f"{part} (relative), kernels vs",
             {k: errs(got[part], w[part], rel=True) for k, w in want.items()},
             MERGE_TOL, right=("twin",), wrong=wrong)


def moved_rows(t) -> tuple:
    """The rows of a [rows, features] tensor that are not all zero."""
    return tuple((t.abs().sum(dim=1) > 0).nonzero().flatten().tolist())


def phase_all_configs():
    """Phase 22b: the 55-category configs (`experiments/*/all`) through the
    entries at full width and depth (cuts printed), on a synthetic PC15k
    tree of three synsets: `train_compressor` (B=16, labels) with a save
    and a resume leg that runs one `reconstruction` at val_cate, then
    `train_latent_diffusion` through `load_pretrain` (B=32, labels) with a
    save and a resume leg that runs one `valsample` at val_cate. Every loss
    and metric must be finite, the labels' rows of both label tables (and
    no other) must have moved, and K1-K5 must have run; prints seconds per
    epoch and the checkpoints' sizes. Returns the stage-2 trainer (its
    tensors on the card) and removes the tree."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ldt_torch.cli import get_config, get_parser
    from ldt_torch.data.shapenet55 import cate_to_synsetid
    from ldt_torch.entries import train_compressor as entry1
    from ldt_torch.entries import train_latent_diffusion as entry2
    from ldt_torch.training.compressor_trainer import Trainer as Stage1
    from ldt_torch.training.latent_sde_trainer import Trainer as Stage2

    gc.collect()
    torch.cuda.empty_cache()
    index = {s: i for i, s in enumerate(cate_to_synsetid.values())}
    labels = {index[s] for s in ALL_SYNSETS}
    if index["03001627"] != VAL_CATE:
        fail(f"phase 22b: chair is category {index['03001627']}")
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ldt_phase22_")
    try:
        data_dir = os.path.join(tmp, "PC15k")
        synthetic_tree(data_dir, ALL_SYNSETS, ALL_TRAIN, ALL_VAL, SEED + 22)
        print(f"[22b] data: {ALL_TRAIN} train and {ALL_VAL} val clouds of "
              f"15000 points for each of {', '.join(ALL_SYNSETS)} "
              f"(categories {sorted(labels)} of 55; ShapeNetCore.v2.PC15k "
              f"holds thousands of each)")
        ws = os.path.join(tmp, "experiments")
        paths = {k: os.path.join(ws, k, "all") for k in ALL_CUTS}
        for kind, (cuts, _) in ALL_CUTS.items():
            edits = dict(cuts, **{"data.data_dir": data_dir,
                                  "log.save_path": paths[kind]})
            if kind == "Latent_Diffusion_Trainer":
                edits["compressor.pretrain_path"] = os.path.join(
                    paths["Compressor_Trainer"], "checkpt_4.pt")
            copied_config(os.path.join(root, "experiments", kind, "all",
                                       "config.yaml"),
                          os.path.join(paths[kind], "config.yaml"), edits,
                          kind, "22b")

        stamps = {}
        real_end = {cls: cls.epoch_end for cls in (Stage1, Stage2)}
        real_update = {cls: cls.update for cls in (Stage1, Stage2)}

        def update(self, *a, **kw):
            if self.itr == self._itr_epoch_start:
                torch.cuda.synchronize()
                stamps[(type(self), self.epoch)] = [time.perf_counter()]
            return real_update[type(self)](self, *a, **kw)

        def epoch_end(self):
            torch.cuda.synchronize()
            stamps[(type(self), self.epoch)].append(time.perf_counter())
            return real_end[type(self)](self)

        def leg(kind, entry, *extra):
            a = get_parser(kind).parse_args(
                ["--save", ws, "--dataset", "all", "--val_cate",
                 str(VAL_CATE), *extra])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer = entry.main(a, get_config(a))
            lines = buf.getvalue().splitlines()
            missing = sum(ln.startswith("Directory missing") for ln in lines)
            for ln in lines:
                if not ln.startswith("Directory missing"):
                    print(f"    {ln}")
            print(f"    ({missing} 'Directory missing' lines: the synsets "
                  "the tree lacks)")
            return trainer

        def run_all():
            out = {}
            kind = "Compressor_Trainer"
            leg(kind, entry1)
            copied_config(os.path.join(paths[kind], "config.yaml"),
                          os.path.join(paths[kind], "config.yaml"),
                          ALL_CUTS[kind][1], "stage 1 resume leg", "22b")
            s1 = leg(kind, entry1, "--resume", "True")
            out["stage1"] = (s1.epoch, s1.state.opt_state.mu[
                "label_embedding.embed.weight"].clone())
            del s1
            gc.collect()
            kind = "Latent_Diffusion_Trainer"
            s2 = leg(kind, entry2)
            out["stage2 first leg"] = s2.epoch
            del s2
            gc.collect()
            torch.cuda.empty_cache()
            copied_config(os.path.join(paths[kind], "config.yaml"),
                          os.path.join(paths[kind], "config.yaml"),
                          ALL_CUTS[kind][1], "stage 2 resume leg", "22b")
            s2 = leg(kind, entry2, "--resume", "True")
            out["stage2"] = (s2.epoch, s2.state.opt_state.mu[
                "label_embedding.embed.weight"].clone())
            return out, s2

        with mock.patch.object(Stage1, "update", update), \
                mock.patch.object(Stage2, "update", update), \
                mock.patch.object(Stage1, "epoch_end", epoch_end), \
                mock.patch.object(Stage2, "epoch_end", epoch_end):
            (out, stage2), dt, launches = counted(run_all)
        if (out["stage1"][0], out["stage2 first leg"],
                out["stage2"][0]) != (5, 2, 3):
            fail(f"phase 22b: the runs ended at epochs {out}")
        for stage in ("stage1", "stage2"):
            moved = moved_rows(out[stage][1])
            print(f"[22b] {stage}: rows of the label table with gradients "
                  f"(Adam's mu moved): {moved}, the data's categories "
                  f"{tuple(sorted(labels))}")
            if moved != tuple(sorted(labels)):
                fail(f"phase 22b: {stage}'s labels did not reach the net "
                     f"as expected: rows {moved}")
        for kind, names in (("Compressor_Trainer", ("training.csv",
                                                    "eval.csv")),
                            ("Latent_Diffusion_Trainer",
                             ("training.csv", "eval.csv", "test.csv"))):
            for name in names:
                rows = finite_rows(os.path.join(paths[kind], name),
                                   f"{kind} {name}", "22b")
                if not rows:
                    fail(f"phase 22b: {kind} {name} has no row")
        # named by the epoch counter after the evaluated epoch's end
        for kind, name in (("Compressor_Trainer", "rec_ep4.npy"),
                           ("Latent_Diffusion_Trainer", "smp_ep3.npy")):
            arr = np.load(os.path.join(paths[kind], name))
            if arr.shape != (ALL_VAL, 2048, 3) or not np.isfinite(arr).all():
                fail(f"phase 22b: {kind} {name} {arr.shape} is not "
                     f"{ALL_VAL} finite clouds of val_cate {VAL_CATE}")
        for cls, what in ((Stage1, "stage 1 (B=16, 2048 points)"),
                          (Stage2, "stage 2 (B=32)")):
            secs = [round(t[1] - t[0], 3) for (c, _), t in
                    sorted(stamps.items(), key=lambda kv: kv[0][1])
                    if c is cls]
            print(f"[22b] {what} seconds per epoch: {secs} "
                  f"({smi_name_and_power()})")
        sizes = {kind: os.path.getsize(os.path.join(paths[kind], name))
                 for kind, name in (("Compressor_Trainer", "checkpt_4.pt"),
                                    ("Latent_Diffusion_Trainer",
                                     "checkpt_1.pt"))}
        print(f"[22b] checkpoints: stage 1 {sizes['Compressor_Trainer']} "
              f"bytes, stage 2 {sizes['Latent_Diffusion_Trainer'] / 1e9:.3f}"
              f" GB")
        k6 = launches["approx_match_cost"] - launches["approx_match_cost_otf"]
        ran = {"K1": launches["packed_self_attention"],
               "K2": launches["cross_attention"],
               "K3": launches["packed_self_attention_bwd"],
               "K4": launches["cross_attention_bwd"],
               "K5": launches["pairwise_cd_means"], "K6": k6}
        print(f"[22b] the all configs' run: {dt:.2f} s, launches {ran}")
        if not all(ran[k] for k in ("K1", "K2", "K3", "K4", "K5")):
            fail(f"phase 22b: a kernel of the path did not run: {ran}")
        return stage2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_label_generate(trainer) -> None:
    """Phase 22c: `Trainer.sample(32, label=14)` of the 55-category stage-2
    trainer with the full 1000 ancestral steps: the whole f32 Score at each
    step (c = t_emb + l_emb: no modulation hoisted), then the decode; launch
    counts K1 24 x 1000 (register-tiled), K2 6, nothing else; clouds/min
    with the card's name and power limit."""
    from ldt_torch.diffusion import make_diffusion

    trainer.cfg.sde.sample_N = STEPS
    trainer.sde = make_diffusion(trainer.cfg.sde, device="cuda")
    blocks = trainer.cfg.score.num_blocks
    expect = per_step_launches(
        packed_self_attention=blocks * STEPS,
        packed_self_attention_tiled=blocks * STEPS,
        cross_attention=trainer.cfg.compressor.n_layers)
    checked_generation(
        "22c", f"label-conditioned generation (label {VAL_CATE}, {STEPS} "
        f"steps, the whole f32 Score each step, {smi_name_and_power()})",
        lambda: trainer.sample(LABEL_BATCH, label=VAL_CATE)[0],
        LABEL_BATCH, expect)


# Phase 23: ViPC completion. The DiT's cross-attention shape (the even
# blocks: 32 latent tokens over 32 condition tokens, hidden 1024, 16 heads,
# dh 64), the stage-2 completion batch.
DIT_CROSS = (32, 32, 1024, 16)  # B, N = M, D, heads
COMPLETION_BATCH = 32           # the completion stage-2 config's batch
# The synthetic ViPC tree: models per split, ViPC's 24 views each, RGBA
# views at the renderings' 137 x 137 (the loader resizes them to 224), GT
# clouds of 2048 points, partial clouds of 1024 (pad-repeated to 3500).
VIPC_TRAIN, VIPC_TEST, VIPC_VIEWS, VIPC_SIZE = 32, 16, 24, 137
# The cuts (the models keep their published width and depth): each stage
# two epochs with a save, then a resume leg (stage 1 two epochs, stage 2
# one); stage 1 scores a reconstruction at epoch 2, stage 2 a valsample at
# epoch 2 with sample_N 32.
COMPLETION_CUTS = {
    # stage 1's loop runs while epoch < epochs (the reference's): its leg
    # asks for 4 and trains epochs 3 and 4
    "Compressor_Trainer": ({"common.epochs": 2, "log.save_epoch_freq": 2,
                            "log.eval_epoch_freq": 2,
                            "log.log_epoch_freq": 1},
                           {"common.epochs": 4, "log.save_epoch_freq": 5}),
    "Latent_Diffusion_Trainer": ({"common.epochs": 2,
                                  "log.save_epoch_freq": 2,
                                  "log.eval_epoch_freq": 2,
                                  "log.log_epoch_freq": 1,
                                  "sde.sample_N": CHECK_STEPS},
                                 {"common.epochs": 3,
                                  "log.save_epoch_freq": 5}),
}


def phase_dit_cross_kernels(gen) -> dict:
    """Phase 23a: K2 (whole-set schedule, dh 64 in its widest register
    width) and K4 (register-tiled long-query schedule, one tile of 32 rows)
    at the DiT's cross-attention shape, f32, against their twins on the
    card and on the CPU, f64 products and wrong variants (K2: the weights
    rounded to bf16, k and v swapped; K4: no rowsum, dk/dv and dq/dk
    swapped), each repeating its bits; timed by the event loop and by
    device time, beside the bound, the twin and SDPA (forward, backward);
    rows `cross_attention_dit_cross` and `cross_attention_bwd_dit_cross`."""
    import torch
    import torch.nn.functional as F

    from ldt_torch.ops import attention as attn_ops

    b, n, d, h = DIT_CROSS
    dh = d // h
    q, k, v, g = (torch.randn(b, n, d, device="cuda", generator=gen)
                  for _ in range(4))
    rows = {}

    def heads(t):
        return t.unflatten(-1, (h, -1)).transpose(1, 2)

    if attn_ops.cross_schedule(n, n, dh) != "whole" or \
            attn_ops.whole_width(dh) != 64:
        fail(f"phase 23: K2 at N = M = {n}, dh {dh} is not the whole-set "
             "schedule at width 64")
    fn = attn_ops.cross_attention
    before = (fn.launches, fn.tiled_launches)

    def k2():
        return fn(q, k, v, h)

    got = k2()
    if (fn.launches, fn.tiled_launches) != (before[0] + 1, before[1]):
        fail("phase 23: K2 at the DiT's cross shape did not launch its "
             "whole-set schedule once")
    if not torch.equal(got, k2()):
        fail("phase 23: K2 at the DiT's cross shape did not repeat its bits")
    twin = attn_ops.attention_plain(q, k, v, h)
    readings = {"twin": errs(got, twin),
                "cpu twin": errs(got, attn_ops.attention_plain(
                    q.cpu(), k.cpu(), v.cpu(), h)),
                "kv swapped": errs(got, attention_variant(
                    q, v, k, h, torch.float32, torch.float32))}
    for vname, (acc, w) in variants(torch.float32).items():
        readings[vname] = errs(got, attention_variant(q, k, v, h, acc, w))
    ms = cuda_ms(k2)
    parts = launch_us(k2)
    if not parts or not all("whole" in key for key in parts):
        fail(f"phase 23: K2 ran {list(parts)}, not its whole-set kernel")
    device_ms = sum(parts.values()) / 1e3
    plain_ms = cuda_ms(lambda: attn_ops.attention_plain(q, k, v, h),
                       iters=20)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        heads(q), heads(k), heads(v)))
    nbytes = 4 * q.numel() * q.element_size()
    flops = b * h * (4 * n * n * dh + 5 * n * n)
    bound_ms, bound_by = _bound(nbytes, {"float32": flops})
    print(f"[23a] cross_attention (K2, whole-set, DiT cross) float32 q/k/v "
          f"{list(q.shape)}, H={h} (dh {dh}): max|twin| "
          f"{twin.abs().max().item():.4f}, kernel {ms:.4f} ms, device "
          f"{device_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP) "
          f"({smi_name_and_power()})")
    print("    device time per call: " + ", ".join(
        f"{key} {us:.2f} us" for key, us in parts.items()))
    held("K2 DiT cross float32 vs", readings, KERNEL_TOL["float32"],
         right=("twin", "cpu twin", "f64"), wrong=("wrong", "kv swapped"))
    rows["cross_attention_dit_cross"] = {
        "name": "cross_attention_dit_cross", "route": "cuda",
        "source": "ldt_torch/csrc/attention.cu",
        "replaces": "ldt_tpu/ops/pallas_attention.py:49", "launches": 0,
        "max_abs_err": readings["twin"][0], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "device_ms": device_ms}

    fn = attn_ops.cross_attention_bwd
    rows_per_block = attn_ops.cross_bwd_schedule(n, n, dh)
    if not rows_per_block or not attn_ops.cross_bwd_tiled(n, n, dh):
        fail(f"phase 23: K4 at N = M = {n}, dh {dh} has no register-tiled "
             f"schedule ({rows_per_block})")

    def k4():
        return fn(q, k, v, g, h)

    before = fn.tiled_launches
    got = k4()
    if fn.tiled_launches != before + 1:
        fail("phase 23: K4 at the DiT's cross shape did not take its "
             "register-tiled kernels")
    if not all(torch.equal(x, y) for x, y in zip(got, k4())):
        fail("phase 23: K4 at the DiT's cross shape did not repeat its bits")
    twin = attn_ops.cross_attention_bwd_plain(q, k, v, g, h)
    readings = {
        "twin": errs3(got, twin),
        "cpu twin": errs3(got, attn_ops.cross_attention_bwd_plain(
            q.cpu(), k.cpu(), v.cpu(), g.cpu(), h)),
        "f64": errs3(got, k4_variant(q, k, v, g, h, acc=torch.float64)),
        "no rowsum": errs3(got, k4_variant(q, k, v, g, h, rowsum=False)),
        "dk dv swapped": errs3(got, k4_variant(q, k, v, g, h,
                                               swap="dk dv")),
        "dq dk swapped": errs3(got, k4_variant(q, k, v, g, h,
                                               swap="dq dk"))}
    ms = cuda_ms(k4)
    parts = launch_us(k4)
    if not parts or not all(", true>" in key for key in parts
                            if "reduce" not in key):
        fail(f"phase 23: K4 ran {list(parts)}, not its register-tiled "
             "kernels")
    device_ms = sum(parts.values()) / 1e3
    plain_ms = cuda_ms(lambda: attn_ops.cross_attention_bwd_plain(
        q, k, v, g, h), iters=20)
    sdpa_heads = [heads(t) for t in (q, k, v, g)]
    library_ms = sdpa_backward_ms(*sdpa_heads)
    library_device_ms = sdpa_backward_device_ms(*sdpa_heads)
    nbytes = (3 * q.numel() + 4 * k.numel()) * q.element_size()
    flops = b * h * (10 * n * n * dh + 8 * n * n)
    bound_ms, bound_by = _bound(nbytes, {"float32": flops})
    scales = ", ".join(f"{t.abs().max().item():.4f}" for t in twin)
    print(f"[23a] cross_attention_bwd (K4, long-query, {rows_per_block} rows "
          f"x 1 tile, DiT cross) float32 q/k/v/g {list(q.shape)}, H={h}: "
          f"max|twin| dq/dk/dv {scales}, kernel {ms:.4f} ms, device "
          f"{device_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward "
          f"{library_ms:.4f} ms (device {library_device_ms:.4f} ms), bound "
          f"{bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.3f} GFLOP) ({smi_name_and_power()})")
    print("    device time per call: " + ", ".join(
        f"{key} {us:.2f} us" for key, us in parts.items()))
    held("K4 DiT cross float32 (relative) vs", readings, K4_TOL["float32"],
         right=("twin", "cpu twin", "f64"),
         wrong=("no rowsum", "dk dv swapped", "dq dk swapped"))
    rows["cross_attention_bwd_dit_cross"] = {
        "name": "cross_attention_bwd_dit_cross", "route": "cuda",
        "source": "ldt_torch/csrc/attention.cu",
        "replaces": "ldt_tpu/ops/pallas_attention.py:72", "launches": 0,
        "max_abs_err": max(errs(x, y)[0] for x, y in zip(got, twin)),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "library_device_ms": library_device_ms, "device_ms": device_ms}
    return rows


def tf32_trunk():
    """A wrong variant: the ConditionNet's convolutions under cuDNN's TF32
    (the trap `nn.layers.ieee_cudnn` closes)."""
    import torch

    from ldt_torch.nn import layers

    return mock.patch.object(layers, "ieee_cudnn", lambda: (
        torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                   deterministic=False, allow_tf32=True)))


def phase_condition_reference() -> None:
    """Phase 23b: the conditional Score at flagship width cut to 2 blocks
    and its ConditionNet on 64 x 64 views and 2048-point partial clouds,
    f32, B=4, the same weights (through `ldt_torch.weights` both ways) and
    inputs on the card and on the CPU: the ConditionNet's tokens and image
    embedding and the Score's output (eval mode), then one completion
    train step with pinned draws (loss, gradients, params, EMA, Adam's mu,
    the BatchNorm statistics). The card runs with cuDNN's global TF32 on:
    the trunk's convolutions must stay IEEE f32 by their own scope; the
    wrong variant runs them in TF32."""
    import torch

    from ldt_torch import weights
    from ldt_torch.models import Compressor, Score
    from ldt_torch.ops import attention as attn_ops
    from ldt_torch.training import completion_latent_sde_trainer as clt

    batch = 4
    cfg = completion_cfg(score=dict(num_blocks=2))
    g = torch.Generator().manual_seed(SEED)
    v = weights.score_variables(
        Score(cfg.score, device="cpu", generator=g).state_dict())
    score_w = weights.score_state_dict(v["params"], v["batch_stats"])
    comp = Compressor(cfg.compressor, device="cpu", generator=g)
    pc = torch.randn(batch, 2048, 3, generator=g)
    comp.init_actnorm(pc[:2])
    comp_w = comp.state_dict()
    cond = {"img": torch.rand(batch, 64, 64, 3, generator=g),
            "pts": 0.5 * torch.randn(batch, 2048, 3, generator=g)}
    x = torch.randn(batch, cfg.score.z_scale, cfg.score.z_dim, generator=g)
    t = torch.rand(batch, generator=g)
    pins = dict(
        t_idx=torch.randint(0, cfg.sde.train_N, (batch,), generator=g),
        eta=torch.randn(batch, cfg.score.z_scale, cfg.score.z_dim,
                        generator=g),
        enc_noise=[torch.randn(batch, cfg.compressor.z_scales,
                               cfg.compressor.z_dim, generator=g)
                   for _ in range(cfg.compressor.n_layers)])

    def run(dev):
        tr = clt.Trainer(cfg, device=dev)
        tr.maybe_init({"tr_points": pc}, score_weights=score_w,
                      compressor_weights=comp_w)
        on = {k: v.to(dev) for k, v in cond.items()}
        with torch.no_grad():
            tokens, img_emb = tr.score.encode_condition(on)
            pred = tr.score(x.to(dev), t.to(dev), None, (tokens, img_emb))
        loss = tr.update(pc.to(dev), on, **pins)
        st = tr.state

        def flat(tree):
            return torch.cat([v.detach().reshape(-1).cpu()
                              for v in tree.values()])

        grads = {k: p.grad for k, p in st.params.items()}
        return {"tokens": tokens.cpu(), "image embedding": img_emb.cpu(),
                "score": pred.cpu(), "loss": loss.reshape(1).cpu(),
                "gradients": flat(grads),
                "by name": {k: v.detach().cpu() for k, v in grads.items()},
                "params": flat(st.params), "EMA": flat(st.ema_params),
                "Adam mu": flat(st.opt_state.mu),
                "BatchNorm statistics": flat(st.batch_stats)}

    out = {"cpu": run("cpu")}
    fn = attn_ops.cross_attention_bwd
    before = (fn.launches, fn.tiled_launches)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # the library's default
    try:
        out["card"] = run("cuda")
        with tf32_trunk():
            out["tf32 trunk"] = run("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    k4 = (fn.launches - before[0], fn.tiled_launches - before[1])
    # block 0 cross-attends (K2 forward, K4 backward), in each card run
    if k4 != (2, 2):
        fail(f"phase 23b: the card's steps launched K4 {k4} (tiled), not "
             "once each")
    print(f"[23b] the conditional Score at flagship width, 2 blocks, and its "
          f"ConditionNet (64 x 64 views, 2048-point partial clouds), f32, "
          f"B={batch}, card (cuDNN TF32 on globally) vs CPU: loss "
          f"{out['cpu']['loss'].item():.6f}")
    worst = sorted(((errs(out["card"]["by name"][k], v)[0], k) for k, v in
                    out["cpu"]["by name"].items()), reverse=True)[:4]
    print("    the gradients' largest differences, card vs CPU: " + ", ".join(
        f"{k} {e:.3e}" for e, k in worst))
    for part in out["cpu"]:
        if part == "by name":
            continue
        if not torch.isfinite(out["card"][part]).all():
            fail(f"phase 23b: {part} on the card is not finite")
        held(f"{part} (relative), CPU vs",
             {k: errs(out[k][part], out["cpu"][part], rel=True)
              for k in ("card", "tf32 trunk")},
             COND_STEP_TOL if part in ("gradients", "Adam mu")
             else TRAIN_STEP_TOL, right=("card",),
             wrong=("tf32 trunk",) if part in (
                 "image embedding", "gradients") else ())


def completion_cfg(**over):
    """The completion stage-2 config of experiments/ (flagship widths),
    sections updated by `over`, in memory."""
    import os

    from ldt_torch.configs import dict2namespace
    from ldt_torch.tools.io import load_yaml

    d = load_yaml(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "experiments",
        "Latent_Diffusion_Trainer", "completion", "plane", "config.yaml"))
    for k, v in over.items():
        d[k] = dict(d[k], **v)
    d["log"] = {}
    return dict2namespace(d)


def phase_completion_entries():
    """Phase 23c: the completion entries from the configs of
    experiments/{Compressor_Trainer,Latent_Diffusion_Trainer}/completion/
    plane (full width and depth; the epochs, cadences, the stage-2 eval's
    sample_N and the data cut, each cut printed) on a synthetic ViPC tree
    (`ldt_torch.tools.synth_vipc`: RGBA 137 x 137 views, resized by the
    loader): stage 1 from a stage-1 checkpoint written here (the shipped
    pretrain_path is null), 2 epochs with a save and a reconstruction,
    then a resume leg; stage 2 from stage 1's checkpoint through
    `load_pretrain`, 2 epochs with a save and a valsample, then a resume
    leg. Restored tensors must equal the state at the save (the moments
    their bf16 rounding), the counters continue, every loss and score must
    be finite, and K1-K4 must have run; prints seconds per epoch and each
    checkpoint's size and save and load seconds. Returns (the stage-2
    trainer, a train batch, the stage-2 legs' launch counts)."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ldt_torch.cli import get_completion_config, get_parser
    from ldt_torch.configs import dict2namespace
    from ldt_torch.data.vipc import get_data_loaders
    from ldt_torch.entries import train_completion_compressor as entry1
    from ldt_torch.entries import train_completion_latent_diffusion as entry2
    from ldt_torch.tools import synth_vipc
    from ldt_torch.training import checkpoint as ckpt
    from ldt_torch.training.completion_compressor_trainer import (
        Trainer as Stage1,
    )
    from ldt_torch.training.completion_latent_sde_trainer import (
        Trainer as Stage2,
    )

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ldt_phase23_")
    try:
        data_dir = os.path.join(tmp, "ShapeNetViPC-Dataset")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            synth_vipc.write_tree(data_dir, VIPC_TRAIN, VIPC_TEST,
                                  VIPC_VIEWS, lists_dir=data_dir,
                                  view_size=VIPC_SIZE, view_mode="RGBA")
        print(f"[23c] data: a synthetic ShapeNet-ViPC tree of {VIPC_TRAIN} "
              f"train and {VIPC_TEST} test planes x {VIPC_VIEWS} views "
              f"(RGBA {VIPC_SIZE} x {VIPC_SIZE}, as the renderings), GT "
              f"2048 points, partials 1024, written in "
              f"{time.perf_counter() - t0:.1f} s (ShapeNet-ViPC's plane "
              "split holds thousands of models)")
        ws = os.path.join(tmp, "experiments")
        paths = {k: os.path.join(ws, k, "completion", "plane")
                 for k in COMPLETION_CUTS}
        seed_dir = os.path.join(tmp, "stage1_seed")
        lists = {"data.data_dir": data_dir,
                 "data.train_list": os.path.join(data_dir,
                                                 "train_list2.txt"),
                 "data.test_list": os.path.join(data_dir, "test_list2.txt")}
        for kind, (cuts, _) in COMPLETION_CUTS.items():
            edits = dict(cuts, **lists, **{"log.save_path": paths[kind]})
            if kind == "Compressor_Trainer":
                edits["model.pretrain_path"] = os.path.join(
                    seed_dir, "checkpt_0.pt")
            else:
                edits["compressor.pretrain_path"] = os.path.join(
                    paths["Compressor_Trainer"], "checkpt_2.pt")
            copied_config(os.path.join(root, "experiments", kind,
                                       "completion", "plane", "config.yaml"),
                          os.path.join(paths[kind], "config.yaml"), edits,
                          kind, "23c")

        def args(kind, *extra):
            a = get_parser(kind).parse_args(["--save", ws, "--dataset",
                                             "plane", *extra])
            return a, get_completion_config(a)

        # the stage-1 checkpoint the completion finetune starts from (the
        # pretrain_path the shipped config leaves to the user)
        _, cfg = args("Compressor_Trainer")
        cfg.log = dict2namespace({"save_path": seed_dir})
        os.makedirs(seed_dir)
        seed = Stage1(cfg, device="cuda")
        seed.maybe_init({"tr_points": torch.from_numpy(synthetic_shapes(
            cfg.data.batch_size, 2048, np.random.default_rng(SEED + 23)))})
        seed.epoch = 0
        seed.save()
        seed_tree = host_state(seed.state_tree())
        del seed

        saved, timing, seen = {}, {"epochs": {}}, {}
        real = {m: {cls: getattr(cls, m) for cls in (Stage1, Stage2)}
                for m in ("save", "resume", "update", "epoch_end",
                          "load_pretrain")}

        def stage(self):
            return 1 if isinstance(self, Stage1) else 2

        def counters(self):
            return (self.epoch, self.itr, self._itr_epoch_start,
                    self.state.step)

        def save(self):
            s = stage(self)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real["save"][type(self)](self)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t0 = time.perf_counter()
            ckpt.wait_pending_saves()  # stage 2 writes on a thread
            timing[f"save{s}"] = (dt, time.perf_counter() - t0)
            saved[s] = (host_state(self.state_tree(), s == 2),
                        counters(self))
            timing[f"size{s}"] = os.path.getsize(ckpt.checkpoint_path(
                self.cfg.log.save_path, self.epoch))

        def resume(self, *a, **kw):
            s = stage(self)
            t0 = time.perf_counter()
            real["resume"][type(self)](self, *a, **kw)
            torch.cuda.synchronize()
            timing[f"load{s}"] = time.perf_counter() - t0
            tree, (epoch, itr, _, step) = saved[s]
            bad = differing(self.state_tree(), tree)
            want = (epoch + 1, itr, itr, step)
            print(f"[23c] stage {s} resume: {timing[f'load{s}']:.3f} s; "
                  f"counters {counters(self)} (saved at "
                  f"{(epoch, itr, step)}); restored tensors that differ "
                  f"from the state at the save: {len(bad)}")
            if bad or counters(self) != want:
                fail(f"phase 23c: stage {s}'s resumed state differs from "
                     f"the saved one: {bad[:5]}, counters "
                     f"{counters(self)} != {want}")
            seen[f"resumed{s}"] = True

        def load_pretrain(self):
            real["load_pretrain"][type(self)](self)
            if stage(self) == 1:
                bad = differing(self.state_tree(), seed_tree)
                what = "the stage-1 seed's whole state"
            else:
                tree = saved[1][0]["state"]
                bad = differing(dict(self.compressor.state_dict()),
                                {**tree["params"], **tree["batch_stats"]})
                what = "stage 1's Compressor at its save"
            print(f"[23c] stage {stage(self)} load_pretrain: tensors that "
                  f"differ from {what}: {len(bad)}")
            if bad:
                fail(f"phase 23c: load_pretrain gave other weights: "
                     f"{bad[:5]}")
            seen[f"pretrained{stage(self)}"] = True

        def update(self, *a, **kw):
            if self.itr == self._itr_epoch_start:
                torch.cuda.synchronize()
                timing["epochs"][(stage(self), self.epoch)] = [
                    time.perf_counter()]
            return real["update"][type(self)](self, *a, **kw)

        def epoch_end(self):
            torch.cuda.synchronize()
            timing["epochs"][(stage(self), self.epoch)].append(
                time.perf_counter())
            return real["epoch_end"][type(self)](self)

        launches = {}

        def leg(kind, entry, name, *extra):
            a, cfg = args(kind, *extra)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer, dt, counts = counted(lambda: entry.main(a, cfg))
            for ln in buf.getvalue().splitlines():
                print(f"    {ln}")
            launches[name] = counts
            print(f"[23c] {name}: {dt:.2f} s, launches K1 "
                  f"{counts['packed_self_attention']} K2 "
                  f"{counts['cross_attention']} K3 "
                  f"{counts['packed_self_attention_bwd']} K4 "
                  f"{counts['cross_attention_bwd']}")
            return trainer

        with contextlib.ExitStack() as stack:
            for cls in (Stage1, Stage2):
                for name, fn in (("save", save), ("resume", resume),
                                 ("update", update),
                                 ("epoch_end", epoch_end),
                                 ("load_pretrain", load_pretrain)):
                    stack.enter_context(mock.patch.object(cls, name, fn))
            def resume_cuts(kind):
                copied_config(os.path.join(paths[kind], "config.yaml"),
                              os.path.join(paths[kind], "config.yaml"),
                              COMPLETION_CUTS[kind][1],
                              f"{kind} resume leg", "23c")

            s1 = leg("Compressor_Trainer", entry1, "stage 1")
            epochs1 = s1.epoch
            del s1
            resume_cuts("Compressor_Trainer")
            s1 = leg("Compressor_Trainer", entry1, "stage 1 resume",
                     "--resume", "True")
            epochs1 = (epochs1, s1.epoch)
            del s1
            gc.collect()
            s2 = leg("Latent_Diffusion_Trainer", entry2, "stage 2")
            epochs2 = s2.epoch
            del s2
            gc.collect()
            torch.cuda.empty_cache()
            resume_cuts("Latent_Diffusion_Trainer")
            s2 = leg("Latent_Diffusion_Trainer", entry2, "stage 2 resume",
                     "--resume", "True")
            epochs2 = (epochs2, s2.epoch)
        if (epochs1, epochs2) != ((3, 5), (3, 4)):
            fail(f"phase 23c: the legs ended at epochs {epochs1}, {epochs2}")
        want_seen = {"pretrained1", "pretrained2", "resumed1", "resumed2"}
        if set(seen) != want_seen:
            fail(f"phase 23c: a restore was not checked: {sorted(seen)}")
        for s, what in ((1, "stage 1 (B=16)"),
                        (2, f"stage 2 (B={COMPLETION_BATCH})")):
            secs = [round(t[1] - t[0], 3) for (st, _), t in
                    sorted(timing["epochs"].items()) if st == s]
            save_s, write_s = timing[f"save{s}"]
            print(f"[23c] {what} seconds per epoch: {secs}; checkpoint "
                  f"{timing[f'size{s}'] / 1e9:.4f} GB, save {save_s:.3f} s "
                  f"+ {write_s:.3f} s of write waited for, load (resume) "
                  f"{timing[f'load{s}']:.3f} s ({smi_name_and_power()})")
        for kind, names in (("Compressor_Trainer",
                             ("training.csv", "eval.csv")),
                            ("Latent_Diffusion_Trainer",
                             ("training.csv", "eval.csv"))):
            for name in names:
                rows = finite_rows(os.path.join(paths[kind], name),
                                   f"{kind} {name}", "23c")
                print(f"[23c] {kind} {name}: {rows}")
                if not rows:
                    fail(f"phase 23c: {kind} {name} has no row")
        ran = {"K1": sum(c["packed_self_attention"]
                         for c in launches.values()),
               "K2": sum(c["cross_attention"] for c in launches.values()),
               "K3": sum(c["packed_self_attention_bwd"]
                         for c in launches.values()),
               "K4": sum(c["cross_attention_bwd"]
                         for c in launches.values())}
        if not all(ran.values()):
            fail(f"phase 23c: a kernel of the path did not run: {ran}")
        stage2_k4 = (launches["stage 2"]["cross_attention_bwd"]
                     + launches["stage 2 resume"]["cross_attention_bwd"])
        batch = next(iter(get_data_loaders(s2.cfg.data)["train_loader"]))
        return s2, batch, stage2_k4
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_completion_generate(trainer, batch) -> int:
    """Phase 23d: `Trainer.sample(32, condition=...)` of the completion
    stage-2 trainer on a train batch's views and partial clouds (FPS'd to
    2048) with the config's 1000 ancestral steps: the condition encoded
    once (the trunk runs once), the whole f32 Score each step (12 blocks
    self-attend through K1, 12 cross-attend through K2), then the decode
    (K2 6); clouds/min with the card's name and power limit, and CD x 1000
    and F1 against the batch's GT clouds (meaningless on these weights:
    they show that the scores run). Returns K2's launches at the DiT's
    cross shape."""
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.training.completion_compressor_trainer import (
        completion_scores,
        fps_to,
    )

    trainer.cfg.sde.sample_N = STEPS
    trainer.sde = make_diffusion(trainer.cfg.sde, device="cuda")
    blocks = trainer.cfg.score.num_blocks
    n = COMPLETION_BATCH
    ref = fps_to(batch["pc"][:n], 2048, "cuda")
    cond = {"img": batch["views"][:n],
            "pts": fps_to(batch["pc_part"][:n], 2048, "cuda")}
    runs = trainer.score.c_net.resnet.runs
    cross = blocks // 2 * STEPS  # the even blocks, every step
    expect = per_step_launches(
        packed_self_attention=(blocks - blocks // 2) * STEPS,
        packed_self_attention_tiled=(blocks - blocks // 2) * STEPS,
        cross_attention=cross + trainer.cfg.compressor.n_layers)
    out = {}

    def run():
        out["smp"] = trainer.sample(n, condition=cond)[0]
        return out["smp"]

    checked_generation(
        "23d", f"completion (the condition of {n} views and partial "
        f"clouds, {STEPS} steps, the whole f32 Score each step, "
        f"{smi_name_and_power()})", run, n, expect)
    trunk = trainer.score.c_net.resnet.runs - runs
    scores = completion_scores(out["smp"].cpu().numpy(),
                               ref.cpu().numpy(), "cuda")
    print(f"[23d] the ResNet trunk ran {trunk} time(s) in the {STEPS}-step "
          f"run; CD x 1000 {scores['cd']:.4f}, F1 {scores['f1score']:.4f} "
          "against the batch's GT (random, barely trained weights: the "
          "numbers show that the scores run)")
    if trunk != 1:
        fail(f"phase 23d: the trunk ran {trunk} times, not once")
    return cross


# Phase 24: stage 3, the Hybrid finetune. The importance-sampling
# quantities, card against CPU: each column's largest |card - cpu| over its
# largest |cpu| (as `errs(rel=True)`). The same f32 formulas, but CUDA's
# and the CPU's expf, logf, powf and erfinvf differ by an ulp or so, and
# some columns are ill-conditioned where they peak: the geometric SDE's g2
# divides by 1 - sigma2_0 + sigma2_min - sigma2_geom(t), 1.03e-3 at t = 1
# with sigma2_max 0.999, so an ulp of its pow comes out ~1e3 times larger
# there (read on the H100, elementwise: 20 of the 186 columns past
# rtol 3e-5 + atol 1e-6; as this limit reads them: geometric ll_iw's g2
# 6.9e-4, every other column <= 5.8e-5). The wrong variant draws from rho
# reversed (the smallest family-mode reads 0.99); every family-mode must
# fail it.
IW_REL = 3e-3
IW_FAMILIES = {
    "vpsde": {}, "sub_vpsde": {},
    "geometric_sde": dict(sigma2_min=3e-5, sigma2_max=0.999),
    "vesde": dict(sigma2_0=0.01, sigma2_min=0.01, sigma2_max=50.0)}
# Phase 24a, the Compressor's gradients and Adam's mu under the hybrid
# loss, card vs CPU, (max, mean) relative to the largest |value|: the
# grouping's gradients (kNN over 128 neighbours, its anchor normalization
# and BatchNorms) move by ~1e-3 of the net's largest with the rounding of
# their inputs: the CPU's own run on clouds one ulp up reads 7.0e-4 /
# 1.6e-7 (the largest in `group.extraction.transfer_dense.weight`), the
# card 1.06e-3 / 2.4e-7; both must pass. The other parts keep
# TRAIN_STEP_TOL.
HYBRID_GRAD_TOL = (3e-3, 1e-6)
HYBRID_BATCH = 32  # the shipped hybrid configs' batch
HYBRID_CUTS = {"common.epochs": 2, "log.save_epoch_freq": 2,
               "log.eval_epoch_freq": 2, "log.log_epoch_freq": 1,
               "sde.sample_N": CHECK_STEPS}


def iw_card_vs_cpu() -> None:
    """Phase 24a's `iw_quantities` of every family and mode on the card
    and on the CPU from the same rho (0, 0.5 and 1 - 2^-24 among 256),
    and on the card from rho reversed (the wrong variant): a mode refused
    on one device must be refused on the other."""
    import torch

    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.diffusion.sde import IW_MODES

    rho = torch.cat([torch.tensor([0.0, 0.5, 1.0 - 2.0 ** -24]), torch.rand(
        253, generator=torch.Generator().manual_seed(SEED))])
    names = ("t", "var", "m", "obj", "obj_ll", "g2")
    right, wrong, refused = [], [], 0
    for family, over in IW_FAMILIES.items():
        sdes = {dev: make_diffusion(sde_cfg(sde_type=family, **over),
                                    device=dev) for dev in ("cpu", "cuda")}
        for like in ((False, True) if family == "sub_vpsde" else (False,)):
            for mode in IW_MODES:
                outs = {}
                for key, dev, r in (("cpu", "cpu", rho),
                                    ("card", "cuda", rho),
                                    ("wrong", "cuda", rho.flip(0))):
                    sde = sdes[dev]
                    try:
                        outs[key] = [q.cpu() for q in sde.iw_quantities(
                            rho.numel(), sde.time_eps, mode, like, rho=r)]
                    except (ValueError, NotImplementedError) as e:
                        outs[key] = type(e).__name__
                what = f"{family}{' like_vp' * like} {mode}"
                if any(isinstance(o, str) for o in outs.values()):
                    if not outs["cpu"] == outs["card"] == outs["wrong"]:
                        fail(f"phase 24a: {what}: CPU {outs['cpu']}, card "
                             f"{outs['card']}")
                    refused += 1
                    continue
                for name, c, d in zip(names, outs["cpu"], outs["card"]):
                    if not torch.isfinite(d).all():
                        fail(f"phase 24a: {what} {name} not finite on the "
                             "card")
                    right.append((errs(d, c, rel=True)[0], f"{what} {name}"))
                wrong.append(max((errs(d, c, rel=True)[0], f"{what} {name}")
                                 for name, c, d in zip(names, outs["cpu"],
                                                       outs["wrong"])))
    right.sort(reverse=True)
    print(f"[24a] iw_quantities, card vs CPU, same rho (256, with 0, 0.5, "
          f"1 - 2^-24): {len(wrong)} family-modes, {refused} refused on "
          f"both; each column's max |card - cpu| / max |cpu|, the largest: "
          + ", ".join(f"{w} {e:.3e}" for e, w in right[:4])
          + f" (limit {IW_REL:g}); rho reversed, the smallest "
          f"family-mode: {min(wrong)[1]} {min(wrong)[0]:.3e}")
    if right[0][0] > IW_REL:
        fail(f"phase 24a: {right[0][1]} differs by {right[0][0]:.3e}")
    if min(wrong)[0] <= IW_REL:
        fail(f"phase 24a: rho reversed passes in {min(wrong)[1]}: the "
             "limit cannot tell")


def phase_hybrid_reference() -> None:
    """Phase 24a: the flagship Score cut to 2 blocks and the full 6-layer
    Compressor, f32, B=4, the same weights (`ldt_torch.weights`' state
    dicts), clouds and pinned draws (the KL term's rho and eta, the
    reparameterization noise, the score step's t and eta, the chamfer
    neighbours and EMD assignment from the CPU) on the card and on the CPU:
    one `hybrid_comp_loss` (loss, kl, rec, eps, every Compressor gradient;
    the Score's parameters unchanged, each `.grad` None), then one whole
    `update` (both nets' params, the EMA, both Adam mus, the BatchNorm
    statistics). The wrong variant leaves the Score live in the KL term
    and lets its gradient reach the score step's Adam update; the CPU's
    run on the clouds one ulp up shows how far rounding alone moves each
    part. Then `iw_quantities` of every family and mode, card against
    CPU."""
    import torch

    from ldt_torch.configs import hybrid_trainer_cfg
    from ldt_torch.models import Compressor, Score
    from ldt_torch.ops import attention as attn_ops
    from ldt_torch.training import hybrid_trainer as ht

    batch = 4
    cfg = hybrid_trainer_cfg(score=dict(num_blocks=2))
    mc, ms = cfg.compressor, cfg.score
    g = torch.Generator().manual_seed(SEED)
    score_w = Score(ms, device="cpu", generator=g).state_dict()
    comp = Compressor(mc, device="cpu", generator=g)
    pts = torch.randn(batch, 2048, 3, generator=g)
    comp.init_actnorm(pts[:2])
    comp_w = comp.state_dict()
    noise = [torch.randn(batch, mc.z_scales, mc.z_dim, generator=g)
             for _ in range(mc.n_layers)]
    pins = dict(noise=noise, kl_rho=torch.rand(batch, generator=g),
                kl_eta=torch.randn(batch, ms.z_scale, ms.z_dim, generator=g),
                t_idx=torch.randint(0, cfg.sde.train_N, (batch,),
                                    generator=g),
                eta=torch.randn(batch, ms.z_scale, ms.z_dim, generator=g))
    with torch.no_grad():
        rec = comp(pts, noise=noise, train=True)["set"]
    cd, emd = pinned_rec(rec, pts)
    wrong = "Score live in the KL"
    ulp = "CPU, clouds 1 ulp up"
    ulp_pts = pts * (1 + 2 ** -23)

    def flat(tree):
        return torch.cat([t.detach().reshape(-1).cpu()
                          for t in tree.values()])

    def trainer(dev, clouds):
        tr = ht.Trainer(cfg, device=dev)
        tr.maybe_init({"tr_points": clouds}, score_weights=score_w,
                      compressor_weights=comp_w)
        return tr

    def patched(stack, tr, live):
        stack.enter_context(mock.patch.object(ht, "CD_loss", cd))
        stack.enter_context(mock.patch.object(ht, "EMD_loss", emd))
        if live:  # no freezing, and no zero_grad before the score step
            stack.enter_context(mock.patch.object(
                ht, "frozen", contextlib.nullcontext))
            stack.enter_context(mock.patch.object(
                tr.score, "zero_grad", lambda set_to_none=True: None))

    def loss_run(dev, live=False, clouds=pts):
        tr = trainer(dev, clouds)
        draws = tr.kl_draws(batch, rho=pins["kl_rho"], eta=pins["kl_eta"])
        with contextlib.ExitStack() as stack:
            patched(stack, tr, live)
            loss, (kl, rec_l, eps, _) = ht.hybrid_comp_loss(
                tr.compressor, tr.score, clouds.to(dev), None, *draws[:4],
                tr.ce_const, draws[4], tr.alpha, noise=noise)
            loss.backward()
        grads = sum(p.grad is not None for p in tr.score.parameters())
        moved = [k for k, p in tr.score.named_parameters()
                 if not torch.equal(p.detach().cpu(), score_w[k])]
        return {"loss, kl, rec": torch.stack([loss, kl, rec_l]).detach()
                .cpu(), "eps": eps.detach().cpu(),
                "Compressor gradients": flat(
                    {k: p.grad for k, p in tr.compressor.named_parameters()})
                }, grads, moved

    def update_run(dev, live=False, clouds=pts):
        tr = trainer(dev, clouds)
        with contextlib.ExitStack() as stack:
            patched(stack, tr, live)
            out = tr.update({"tr_points": clouds}, **pins)
        st, cs = tr.state, tr.comp_state
        return {"loss_score, kl, rec": torch.stack(out).cpu(),
                "Score params": flat(st.params),
                "Score EMA": flat(st.ema_params),
                "Score Adam mu": flat(st.opt_state.mu),
                "Compressor params": flat(cs.params),
                "Compressor Adam mu": flat(cs.opt_state.mu),
                "BatchNorm statistics": flat(cs.batch_stats)}

    k1, k3 = attn_ops.packed_self_attention, attn_ops.packed_self_attention_bwd
    out, grads, moved = {}, {}, {}
    out["cpu"], grads["cpu"], moved["cpu"] = loss_run("cpu")
    out[ulp] = loss_run("cpu", clouds=ulp_pts)[0]
    before = (k1.launches, k1.tiled_launches, k3.launches, k3.tiled_launches)
    out["card"], grads["card"], moved["card"] = loss_run("cuda")
    ran = (k1.launches - before[0], k1.tiled_launches - before[1],
           k3.launches - before[2], k3.tiled_launches - before[3])
    out[wrong], grads[wrong], _ = loss_run("cuda", live=True)
    print(f"[24a] one hybrid_comp_loss at flagship width, {ms.num_blocks} "
          f"Score blocks and {mc.n_layers} Compressor layers, f32, "
          f"B={batch}, card vs CPU: (loss, kl, rec) "
          f"{[round(x, 6) for x in out['cpu']['loss, kl, rec'].tolist()]}; "
          f"K1 {ran[0]} ({ran[1]} tiled) and K3 {ran[2]} ({ran[3]} tiled) "
          f"on the card; Score gradients after the KL's backward: CPU "
          f"{grads['cpu']}, card {grads['card']}, {wrong} {grads[wrong]} "
          f"of {len(score_w)}; Score tensors moved: "
          f"{len(moved['cpu']) + len(moved['card'])}")
    if ran != (ms.num_blocks,) * 4:
        fail(f"phase 24a: the KL term's Score ran K1/K3 {ran}, not "
             f"{ms.num_blocks} each on their register-tiled kernels")
    if grads["cpu"] or grads["card"] or moved["cpu"] or moved["card"]:
        fail("phase 24a: the KL term reached the Score's parameters")
    if not grads[wrong]:
        fail("phase 24a: the live Score took no gradient: the check "
             "cannot tell")
    for part in out["cpu"]:
        if not torch.isfinite(out["card"][part]).all():
            fail(f"phase 24a: {part} on the card is not finite")
        grad = part == "Compressor gradients"
        held(f"{part} (relative), CPU vs",
             {k: errs(out[k][part], out["cpu"][part], rel=True)
              for k in ("card", ulp, wrong)},
             HYBRID_GRAD_TOL if grad else TRAIN_STEP_TOL,
             right=("card", ulp) if grad else ("card",), wrong=())

    out = {"cpu": update_run("cpu"), ulp: update_run("cpu", clouds=ulp_pts)}
    before = (k1.launches, k3.launches)
    out["card"] = update_run("cuda")
    ran = (k1.launches - before[0], k3.launches - before[1])
    out[wrong] = update_run("cuda", live=True)
    print(f"[24a] one hybrid update, card vs CPU: K1 {ran[0]} and K3 "
          f"{ran[1]} on the card (the KL term's and the score step's)")
    if ran != (2 * ms.num_blocks,) * 2:
        fail(f"phase 24a: the update ran K1/K3 {ran} times")
    for part in out["cpu"]:
        if not torch.isfinite(out["card"][part]).all():
            fail(f"phase 24a: {part} on the card is not finite")
        grad = part == "Compressor Adam mu"
        held(f"{part} (relative), CPU vs",
             {k: errs(out[k][part], out["cpu"][part], rel=True)
              for k in ("card", ulp, wrong)},
             HYBRID_GRAD_TOL if grad else TRAIN_STEP_TOL,
             right=("card", ulp) if grad else ("card",),
             wrong=(wrong,) if part == "Score Adam mu" else ())
    iw_card_vs_cpu()


def phase_hybrid_entry() -> None:
    """Phase 24b: `python -m ldt_torch.entries.train_hybrid` from a copy of
    experiments/Hybrid_Trainer/airplane/config.yaml (full width and depth,
    B=32; the epochs, the cadences, the valsample's sample_N and the data
    cut, each cut printed) on phase 21's synthetic PC15k tree, bootstrapped
    through `load_pretrain` from a stage-2 dual checkpoint written here as
    the JAX package's `.msgpack` (the smoke and probe configs' format): 2
    epochs with a save and a `valsample`, one `valrecon`, then a
    `--resume` leg that trains epoch 3. Every restored tensor of both train
    states must equal it at the save (the moments their bf16 rounding), the
    counters continue, the logs and scores are finite, and every step
    launches K1 f32 48 and K3 48 (the KL term's and the score step's), K2
    and K4 as a stage-1 step; prints ms per step, seconds per epoch, the
    checkpoint's size and its save and load seconds."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ldt_torch.cli import get_config, get_parser
    from ldt_torch.configs import latent_trainer_cfg
    from ldt_torch.data import get_data_loaders
    from ldt_torch.entries import train_hybrid
    from ldt_torch.training import checkpoint as ckpt
    from ldt_torch.training.hybrid_trainer import Trainer
    from ldt_torch.training.jax_checkpoint import save_jax_checkpoint
    from ldt_torch.training.latent_sde_trainer import Trainer as Stage2

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ldt_phase24_")
    try:
        data_dir = os.path.join(tmp, "PC15k")
        synthetic_tree(data_dir, ("02691156",), ENTRY_TRAIN, ENTRY_VAL,
                       SEED + 21)
        print(f"[24b] data: phase 21's tree, {ENTRY_TRAIN} train and "
              f"{ENTRY_VAL} val clouds of 15000 points ({tmp})")

        # the stage-2 dual checkpoint, as the JAX package writes it
        s2cfg = latent_trainer_cfg()
        s2 = Stage2(s2cfg, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(SEED))
        first = {"tr_points": torch.from_numpy(synthetic_shapes(
            2, 2048, np.random.default_rng(SEED)))}
        s2.maybe_init(first)
        s2.update(first)
        pretrain = os.path.join(tmp, "stage2", "checkpt_400.msgpack")
        os.makedirs(os.path.dirname(pretrain))
        t0 = time.perf_counter()
        tree = host_state(s2.state_tree())
        save_jax_checkpoint(pretrain, tree, s2.tx, s2cfg, epoch=400,
                            itr=400)
        dt = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(os.path.dirname(pretrain),
                                                f)) for f in os.listdir(
            os.path.dirname(pretrain)))
        print(f"[24b] stage-2 dual checkpoint written through the JAX "
              f"bridge: {size / 1e9:.3f} GB (f32, sharded msgpack) in "
              f"{dt:.3f} s")
        del s2
        gc.collect()
        torch.cuda.empty_cache()

        ws = os.path.join(tmp, "experiments")
        save_path = os.path.join(ws, "Hybrid_Trainer", "airplane")
        cfg_path = os.path.join(save_path, "config.yaml")
        copied_config(
            os.path.join(root, "experiments", "Hybrid_Trainer", "airplane",
                         "config.yaml"), cfg_path,
            dict(HYBRID_CUTS, **{"data.data_dir": data_dir,
                                 "log.save_path": save_path,
                                 "opt.pretrain_path": pretrain}),
            "Hybrid_Trainer", phase="24b")

        saved, timing, steps, seen = {}, {"epochs": {}}, [], {}

        real_update, real_end = Trainer.update, Trainer.epoch_end
        real_save, real_resume = Trainer.save, Trainer.resume
        real_pretrain = Trainer.load_pretrain

        def update(self, *a, **kw):
            if self.itr == self._itr_epoch_start:
                torch.cuda.synchronize()
                timing["epochs"][self.epoch] = [time.perf_counter()]
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_update(self, *a, **kw)
            torch.cuda.synchronize()
            after = launch_counts()
            steps.append((time.perf_counter() - t0,
                          {k: after[k] - before[k] for k in after}))
            return out

        def epoch_end(self):
            torch.cuda.synchronize()
            timing["epochs"][self.epoch].append(time.perf_counter())
            return real_end(self)

        def counters(self):
            return (self.epoch, self.itr, self._itr_epoch_start,
                    self.state.step, self.comp_state.step)

        def save(self):
            t0 = time.perf_counter()
            real_save(self)
            torch.cuda.synchronize()
            timing["save"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ckpt.wait_pending_saves()
            timing["write"] = time.perf_counter() - t0
            saved["tree"] = host_state(self.state_tree(), True)
            saved["counters"] = counters(self)

        def resume(self, *a, **kw):
            t0 = time.perf_counter()
            real_resume(self, *a, **kw)
            torch.cuda.synchronize()
            timing["load"] = time.perf_counter() - t0
            bad = differing(self.state_tree(), saved["tree"])
            epoch, itr, _, step, cstep = saved["counters"]
            want = (epoch + 1, itr, itr, step, cstep)
            print(f"[24b] resume: {timing['load']:.3f} s; counters (epoch, "
                  f"itr, itr at the epoch's start, Score step, Compressor "
                  f"step) {counters(self)} (saved at {saved['counters']}); "
                  f"restored tensors that differ from the state at the "
                  f"save: {len(bad)}")
            if bad or counters(self) != want:
                fail(f"phase 24b: the resumed state differs from the saved "
                     f"one: {bad[:5]}, counters {counters(self)} != {want}")
            seen["resumed"] = True

        def load_pretrain(self):
            t0 = time.perf_counter()
            real_pretrain(self)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            bad = differing(self.state.to_tree(), tree["score"]) + differing(
                dict(self.compressor.state_dict()), tree["compressor"])
            fresh = (self.comp_state.step == 0 and not any(
                m.any() for m in self.comp_state.opt_state.mu.values()))
            print(f"[24b] load_pretrain from the stage-2 .msgpack: "
                  f"{dt:.3f} s; tensors that differ from the stage-2 "
                  f"trainer's: {len(bad)}; the Compressor's train state "
                  f"fresh: {fresh}")
            if bad or not fresh:
                fail(f"phase 24b: load_pretrain gave other weights "
                     f"{bad[:5]} or a used Compressor state")
            seen["pretrained"] = True

        def args(*extra):
            a = get_parser("Hybrid_Trainer").parse_args(
                ["--save", ws, *extra])
            return a, get_config(a)

        def run_all():
            a, cfg = args()
            trainer = train_hybrid.main(a, cfg)
            epochs = trainer.epoch
            t0 = time.perf_counter()
            res = trainer.valrecon(get_data_loaders(cfg.data, a)[
                "test_loader"])
            torch.cuda.synchronize()
            timing["valrecon"] = time.perf_counter() - t0
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            rows = {"trained": csv_rows(os.path.join(save_path,
                                                     "training.csv"))}
            copied_config(cfg_path, cfg_path, {"common.epochs": 3},
                          "resume leg", phase="24b")
            a, cfg = args("--resume", "True")
            trainer = train_hybrid.main(a, cfg)
            if (epochs, trainer.epoch) != (3, 4):
                fail(f"phase 24b: the legs ended at epochs {epochs} and "
                     f"{trainer.epoch}, not 3 and 4")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            rows["resumed"] = csv_rows(os.path.join(save_path,
                                                    "training.csv"))
            return rows, res

        with contextlib.ExitStack() as stack:
            for name, fn in (("update", update), ("epoch_end", epoch_end),
                             ("save", save), ("resume", resume),
                             ("load_pretrain", load_pretrain)):
                stack.enter_context(mock.patch.object(Trainer, name, fn))
            (rows, res), dt, launches = counted(run_all)
        if not (seen.get("resumed") and seen.get("pretrained")):
            fail(f"phase 24b: a restore was not checked: {seen}")
        per_step = per_step_launches(
            packed_self_attention=48, packed_self_attention_tiled=48,
            packed_self_attention_bwd=48, packed_self_attention_bwd_tiled=48,
            cross_attention=24, cross_attention_tiled=5,
            cross_attention_bwd=24, cross_attention_bwd_long_key=5,
            cross_attention_bwd_long_query=6, cross_attention_bwd_tiled=24)
        expect = per_step
        bad = [c for _, c in steps if c != expect]
        ms = [t * 1e3 for t, _ in steps]
        print(f"[24b] {len(steps)} hybrid steps at B={HYBRID_BATCH}, f32 "
              f"(457M-param Score, 24 blocks; 6-layer Compressor): ms per "
              f"step {[round(t, 2) for t in ms]} (median "
              f"{sorted(ms)[len(ms) // 2]:.2f}; the first of each leg "
              f"builds its buffers); launches per step {steps[-1][1]} "
              f"(expected {expect}) ({smi_name_and_power()})")
        if bad:
            fail(f"phase 24b: a step's launches {bad[0]} differ from "
                 f"{expect}")
        secs = [round(t[1] - t[0], 3) for _, t in sorted(
            timing["epochs"].items())]
        size = os.path.getsize(os.path.join(save_path, "checkpt_2.pt"))
        print(f"[24b] seconds per epoch {secs} ({ENTRY_TRAIN // HYBRID_BATCH}"
              f" steps each); checkpoint {size / 1e9:.3f} GB (f32 params and "
              f"EMA, bf16 moments, both nets); save {timing['save']:.3f} s "
              f"on the step path + {timing['write']:.3f} s of write on its "
              f"thread, load (resume) {timing['load']:.3f} s; valrecon "
              f"{timing['valrecon']:.3f} s ({smi_name_and_power()})")
        if len(rows["resumed"]) != len(rows["trained"]) + 1:
            fail(f"phase 24b: training.csv went from {len(rows['trained'])}"
                 f" to {len(rows['resumed'])} rows over the resume leg")
        cols = list(rows["trained"][0])
        if cols != ["epoch", "itr", "loss_score", "kl", "rec", "time"]:
            fail(f"phase 24b: training.csv has columns {cols}")
        for name in ("training.csv", "eval.csv"):
            finite_rows(os.path.join(save_path, name), name, phase="24b")
        if not all(np.isfinite(v) for v in res.values()):
            fail(f"phase 24b: valrecon gave {res}")
        k6 = launches["approx_match_cost"] - launches["approx_match_cost_otf"]
        ran = {"K1": launches["packed_self_attention"],
               "K2": launches["cross_attention"],
               "K3": launches["packed_self_attention_bwd"],
               "K4": launches["cross_attention_bwd"],
               "K5": launches["pairwise_cd_means"], "K6": k6}
        print(f"[24b] training.csv rows {len(rows['trained'])} then "
              f"{len(rows['resumed'])}: {rows['resumed']}; valrecon {res}; "
              f"the entry's run {dt:.2f} s, launches {ran}")
        if not all(ran.values()):
            fail(f"phase 24b: a kernel of the path did not run: {ran}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 25: the training options: the shipped bf16-moment config, mixed
# precision (`common.train_dtype: bfloat16`) through the trainers, and the
# Score's dropout.
MOMENT_CONFIGS = ("airplane_synth_mbf16", "airplane_synth_m32ctl")
MOMENT_EPOCHS = 3  # the first leg (one step an epoch at B=64 on the tree)
# The two configs' losses over both legs, epoch by epoch: within 2% of each
# other (the same seed, data and first update; then the bf16 moments'
# rounding).
MOMENT_LOSS_REL = 0.02
MP_STEPS = 10      # timed mixed-precision steps of stages 1 and 2
MP_PROFILED = 4    # profiled stage-2 steps of each dtype
# A 2-block mixed-precision step, card vs CPU, (max, mean) relative to the
# largest |CPU value|, by part: both round every product and sum to bf16
# but cuBLAS and the CPU's GEMMs sum in other orders, so a bf16 value can
# land on its neighbour (2^-8 relative) and the gradients carry it (read
# on the H100: the loss 3.4e-5, gradients 5.9e-3 / 3.9e-6). Wrong: K3 with
# dq and dk swapped (gradients 5.9e-3 / 1.6e-5: the largest gradient is a
# bf16 neighbour in either, the mean tells them apart).
MP_STEP_TOL = {"loss": (1e-3, 1e-3), "gradients": (2e-2, 8e-6),
               "params": (2e-2, 8e-6), "EMA": (2e-2, 8e-6),
               "Adam mu": (2e-2, 8e-6)}
DROPOUT = 0.1


def _opt_bytes(state) -> int:
    """The bytes of a TrainState's Adam moments."""
    from ldt_torch.training import checkpoint as ckpt

    return (ckpt.tree_nbytes(state.opt_state.mu)
            + ckpt.tree_nbytes(state.opt_state.nu))


def phase_moment_dtype() -> None:
    """Phase 25a: the shipped `airplane_synth_mbf16` config (bf16 Adam
    moments) and its f32 control `airplane_synth_m32ctl` through
    `train_latent_diffusion` at full width and depth (457M Score, B=64) on
    phase 21's synthetic tree, from one stage-1 checkpoint written here
    (the configs' own is not in the repository): a leg of MOMENT_EPOCHS
    epochs with a save, then a `--resume` leg of one epoch. The live
    moments must be bf16 (f32 in the control), the optimizer state half the
    control's bytes, the losses within MOMENT_LOSS_REL; an f32-moment
    checkpoint restores into the bf16 config and a bf16 one into the f32
    config. Prints the optimizer state's bytes and each leg's peak
    memory."""
    import gc
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ldt_torch.cli import get_config, get_parser
    from ldt_torch.configs import compressor_trainer_cfg, dict2namespace
    from ldt_torch.entries import train_latent_diffusion as entry
    from ldt_torch.tools.io import load_yaml, namespace2dict
    from ldt_torch.training import checkpoint as ckpt
    from ldt_torch.training.compressor_trainer import Trainer as Stage1
    from ldt_torch.training.latent_sde_trainer import Trainer as Stage2

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ldt_phase25a_")
    kind = "Latent_Diffusion_Trainer"
    try:
        data_dir = os.path.join(tmp, "PC15k")
        synthetic_tree(data_dir, ("02691156",), ENTRY_TRAIN, ENTRY_VAL,
                       SEED + 21)
        src = {name: os.path.join(root, "experiments", kind, name,
                                  "config.yaml") for name in MOMENT_CONFIGS}
        shipped = dict2namespace(load_yaml(src[MOMENT_CONFIGS[0]]))
        if shipped.opt.moment_dtype != "bfloat16":
            fail(f"phase 25a: {src[MOMENT_CONFIGS[0]]} no longer sets "
                 "bf16 moments")
        s1 = Stage1(compressor_trainer_cfg(model=namespace2dict(
            shipped.compressor)), device="cuda",
            generator=torch.Generator("cuda").manual_seed(SEED))
        s1.maybe_init({"tr_points": torch.from_numpy(synthetic_shapes(
            2, 2048, np.random.default_rng(SEED)))})
        stage1 = os.path.join(tmp, "stage1", "checkpt_600.pt")
        os.makedirs(os.path.dirname(stage1))
        ckpt.save_checkpoint(stage1, s1.state_tree(), cfg=s1.cfg, epoch=600)
        del s1
        print(f"[25a] data: phase 21's tree ({ENTRY_TRAIN} train clouds, one "
              f"step an epoch at B=64); the configs' stage-1 checkpoint "
              f"written here from a random Compressor ({stage1})")

        out = {}
        for name in MOMENT_CONFIGS:
            ws = os.path.join(tmp, name)
            save_path = os.path.join(ws, kind, "airplane")
            cfg_path = os.path.join(save_path, "config.yaml")
            copied_config(src[name], cfg_path, {
                "data.data_dir": data_dir, "log.save_path": save_path,
                "compressor.pretrain_path": stage1,
                "common.epochs": MOMENT_EPOCHS,
                "log.save_epoch_freq": MOMENT_EPOCHS,
                "log.eval_epoch_freq": 1000, "log.log_epoch_freq": 1},
                name, phase="25a")
            args = get_parser(kind).parse_args(["--save", ws])
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr = entry.main(args, get_config(args))
            ckpt.wait_pending_saves()
            torch.cuda.synchronize()
            leg = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            moments = {t.dtype for m in (tr.state.opt_state.mu,
                                         tr.state.opt_state.nu)
                       for t in m.values()}
            n_params = sum(p.numel() for p in tr.score.parameters())
            opt = _opt_bytes(tr.state)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
            copied_config(cfg_path, cfg_path,
                          {"common.epochs": MOMENT_EPOCHS + 1}, "resume leg",
                          phase="25a")
            args = get_parser(kind).parse_args(["--save", ws, "--resume",
                                                "True"])
            torch.cuda.reset_peak_memory_stats()
            tr = entry.main(args, get_config(args))
            resumed_peak = torch.cuda.max_memory_allocated()
            resumed = ({t.dtype for m in (tr.state.opt_state.mu,
                                          tr.state.opt_state.nu)
                        for t in m.values()}, tr.epoch, tr.itr)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
            rows = finite_rows(os.path.join(save_path, "training.csv"),
                               name, phase="25a")
            out[name] = dict(moments=moments, resumed=resumed, opt=opt,
                             peak=peak, resumed_peak=resumed_peak,
                             losses=[float(r["loss"]) for r in rows],
                             ckpt=os.path.join(save_path,
                                               f"checkpt_{MOMENT_EPOCHS}.pt"),
                             cfg=cfg_path, leg=leg)
            print(f"[25a] {name}: Score {n_params / 1e6:.2f}M params, live "
                  f"moments {sorted(str(d) for d in moments)}, optimizer "
                  f"state {opt / 1e9:.3f} GB; leg of {MOMENT_EPOCHS} epochs "
                  f"{leg:.2f} s (with a "
                  f"{os.path.getsize(out[name]['ckpt']) / 1e9:.3f} GB save), "
                  f"peak memory {peak / 2 ** 30:.2f} GiB, resume leg's "
                  f"{resumed_peak / 2 ** 30:.2f} GiB; losses "
                  f"{out[name]['losses']} ({smi_name_and_power()})")
        bf, f32 = (out[n] for n in MOMENT_CONFIGS)
        want = {MOMENT_CONFIGS[0]: torch.bfloat16,
                MOMENT_CONFIGS[1]: torch.float32}
        for name, o in out.items():
            if o["moments"] != {want[name]} or o["resumed"] != (
                    {want[name]}, MOMENT_EPOCHS + 2, MOMENT_EPOCHS + 1):
                fail(f"phase 25a: {name} moments {o['moments']}, resumed "
                     f"{o['resumed']}")
        if 2 * bf["opt"] != f32["opt"]:
            fail(f"phase 25a: bf16 moments take {bf['opt']} B, f32 "
                 f"{f32['opt']} B")
        rel = [abs(a - b) / abs(b) for a, b in zip(bf["losses"],
                                                   f32["losses"])]
        print(f"[25a] losses bf16 vs f32 moments, relative: {rel} (limit "
              f"{MOMENT_LOSS_REL}); peak memory "
              f"{bf['peak'] / 2 ** 30:.2f} vs {f32['peak'] / 2 ** 30:.2f} "
              f"GiB; optimizer state {bf['opt'] / 1e9:.3f} vs "
              f"{f32['opt'] / 1e9:.3f} GB")
        if max(rel) > MOMENT_LOSS_REL or len(rel) != MOMENT_EPOCHS + 1:
            fail(f"phase 25a: the two configs' losses {bf['losses']} and "
                 f"{f32['losses']} left the envelope")
        # each config's checkpoint into the other config's trainer
        first = {"tr_points": torch.from_numpy(synthetic_shapes(
            2, 2048, np.random.default_rng(SEED)))}
        for dst, src_name in ((MOMENT_CONFIGS[0], MOMENT_CONFIGS[1]),
                              (MOMENT_CONFIGS[1], MOMENT_CONFIGS[0])):
            cfg = dict2namespace(load_yaml(out[dst]["cfg"]))
            tr = Stage2(cfg, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(SEED))
            tr.maybe_init(first)
            t0 = time.perf_counter()
            tr.resume(pretrain=out[src_name]["ckpt"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            saved = ckpt.load_checkpoint(out[src_name]["ckpt"])["state"]
            bad = [k for n in ("mu", "nu")
                   for k, v in getattr(tr.state.opt_state, n).items()
                   if v.dtype != want[dst] or not torch.equal(
                       v.cpu(), saved["score"]["opt_state"][n][k].to(
                           want[dst]))]
            print(f"[25a] {src_name}'s checkpoint into {dst}'s trainer: "
                  f"{dt:.2f} s; moments {want[dst]}, tensors that differ "
                  f"from the file's: {len(bad)}")
            if bad:
                fail(f"phase 25a: the restore into {dst} gave {bad[:4]}")
            del tr, saved
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dtype_spies(stack) -> dict:
    """Spies on K1-K4's wrappers: {(kernel, dtype name): calls} of their
    inputs' dtype. A spy stands in for its wrapper in `ops.attention`, so
    it carries the wrapper's launch counters, which the wrapper (looking
    itself up there) counts on and `counted` reads."""
    from ldt_torch.ops import attention as attn_ops

    seen = {}
    for name in ("packed_self_attention", "packed_self_attention_bwd",
                 "cross_attention", "cross_attention_bwd"):
        real = getattr(attn_ops, name)

        def spy(*args, _real=real, _name=name):
            key = (_name, str(args[0].dtype).split(".")[1])
            seen[key] = seen.get(key, 0) + 1
            return _real(*args)

        spy.__dict__.update(real.__dict__)
        stack.enter_context(mock.patch.object(attn_ops, name, spy))
    return seen


def _mp_config(name: str, tmp: str, train_dtype: str = "bfloat16"):
    """experiments/<name>/config.yaml copied with `common.train_dtype`
    added and its log under `tmp`, as a namespace."""
    import os

    from ldt_torch.configs import dict2namespace
    from ldt_torch.tools.io import load_yaml

    root = os.path.dirname(os.path.abspath(__file__))
    dst = os.path.join(tmp, name, "config.yaml")
    copied_config(os.path.join(root, "experiments", name, "config.yaml"),
                  dst, {"log.save_path": os.path.dirname(dst)}, name,
                  phase="25b", added={"common.train_dtype": train_dtype})
    return dict2namespace(load_yaml(dst))


def _steps(trainer, data, steps: int, seen=None):
    """`steps` updates, each timed apart: (outputs, [ms]); the spies'
    counts `seen` cleared first."""
    import torch

    if seen is not None:
        seen.clear()
    out, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(trainer.update(data))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _f32_everywhere(trainer, what: str, nets) -> None:
    """Every parameter, EMA, moment and gradient of `trainer`'s states and
    `nets` is f32."""
    import torch

    states = [trainer.state] + ([trainer.comp_state]
                                if getattr(trainer, "comp_state", None)
                                else [])
    bad = [k for st in states for tree in (
        st.params, st.ema_params or {}, st.opt_state.mu, st.opt_state.nu)
        for k, v in tree.items() if v.dtype != torch.float32]
    bad += [k for net in nets for k, p in net.named_parameters()
            if p.grad is not None and p.grad.dtype != torch.float32]
    if bad:
        fail(f"phase 25b: {what}: not f32: {bad[:5]}")


def _profile_by_class(tag: str, step, steps: int, log_dir: str) -> None:
    """`steps` calls of `step()` traced with `ldt_torch.tools.profiling`:
    device busy by class (TRAIN_CLASSES) per step, and the idle share."""
    import os

    import torch

    from ldt_torch.tools import profiling

    spans = [f"ldt_step{i}" for i in range(steps)]
    with profiling.trace(log_dir) as prof:
        t0 = time.perf_counter()
        for span in spans:
            with profiling.annotate(span):
                step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the spans' own device rows (each covers its step's kernels) aside
    kernels = {k: us for k, us in device_time_by_kernel(prof).items()
               if k not in spans}
    busy = sum(kernels.values())
    if busy == 0:
        print(f"[{tag}] profile: no device time recorded (not measured)")
        return
    groups = kernel_classes(kernels)
    trace = os.path.join(log_dir, "trace.json")
    print(f"[{tag}] profile of {steps} steps (ldt_torch.tools.profiling, "
          f"trace {os.path.getsize(trace) / 1e6:.1f} MB): device busy "
          f"{busy / 1e3 / steps:.2f} ms a step, wall "
          f"{wall * 1e3 / steps:.2f} ms a step profiled (idle share "
          f"{1 - busy / (wall * 1e6):.3f})")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {name}: {us / 1e3 / steps:.2f} ms a step "
              f"({us / busy:.3f} of busy)")
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3 / steps:9.2f} ms a step  {key[:110]}")


def phase_mixed_precision(gen) -> None:
    """Phase 25b: `common.train_dtype: bfloat16` (copies of the shipped
    airplane configs with the key added): MP_STEPS stage-2 steps at B=64,
    MP_STEPS stage-1 steps at B=16 and 2 hybrid steps at B=32, full width
    and depth, on random weights; each kernel launch's dtype counted by
    spies (a stage-2 step: K1 24 on its bf16 tensor-core schedule, K3 24,
    K2 24; a stage-1 step: K2 24, K4 24; a hybrid step: K1 48, K3 48, K2
    and K4 24), every parameter, EMA, moment and gradient f32; the wrong
    variant (a Dense that casts its input to its f32 weight) must fail the
    bf16 count. Median ms a step beside the f32 steps' in this run;
    MP_PROFILED stage-2 steps of each dtype profiled by class; a 2-block
    step card vs CPU within MP_STEP_TOL."""
    import gc
    import os
    import shutil
    import statistics
    import tempfile

    import torch
    import torch.nn.functional as F

    from ldt_torch.nn.layers import Dense
    from ldt_torch.ops import attention as attn_ops
    from ldt_torch.training import compressor_trainer as ct
    from ldt_torch.training import hybrid_trainer as ht
    from ldt_torch.training import latent_sde_trainer as lt

    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ldt_phase25b_")
    bf = torch.bfloat16
    try:
        cfg2 = _mp_config("Latent_Diffusion_Trainer/airplane", tmp)
        batch = cfg2.data.batch_size
        data = {"tr_points": torch.randn(batch, 2048, 3, device="cuda",
                                         generator=gen)}
        dh = cfg2.score.hidden_size // cfg2.score.num_heads
        k1_mma = attn_ops.packed_schedule(cfg2.score.z_scale, dh, bf)
        k3_tiled = attn_ops.self_bwd_tiled(cfg2.score.z_scale, dh)
        med = {}
        with contextlib.ExitStack() as stack:
            seen = _dtype_spies(stack)
            tr = lt.Trainer(cfg2, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(SEED))
            if tr.dtype != bf:
                fail(f"phase 25b: the stage-2 trainer computes in {tr.dtype}")
            tr.maybe_init(data)
            _steps(tr, data, 2)
            torch.cuda.reset_peak_memory_stats()
            (losses, ms), _, launches = counted(
                lambda: _steps(tr, data, MP_STEPS, seen))
            peak = torch.cuda.max_memory_allocated()
            per_step = {k: v / MP_STEPS for k, v in seen.items()}
            want = {("packed_self_attention", "bfloat16"): 24,
                    ("packed_self_attention_bwd", "bfloat16"): 24,
                    ("cross_attention", "bfloat16"): 24}
            print(f"[25b] stage 2, bf16 compute over f32 parameters, "
                  f"B={batch}: {MP_STEPS} steps, median "
                  f"{statistics.median(ms):.2f} ms a step (all "
                  f"{[round(x, 2) for x in ms]}), "
                  f"peak memory {peak / 2 ** 30:.2f} GiB; launches by "
                  f"dtype a step {per_step} (expected {want}); schedules "
                  f"K1 mma {launches['packed_self_attention_mma']}, K3 "
                  f"tiled {launches['packed_self_attention_bwd_tiled']} "
                  f"({smi_name_and_power()})")
            if (per_step != want or k1_mma != "mma"
                    or launches["packed_self_attention_mma"]
                    != 24 * MP_STEPS
                    or launches["packed_self_attention_bwd_tiled"]
                    != 24 * MP_STEPS * k3_tiled):
                fail("phase 25b: the mixed-precision stage-2 step's "
                     f"launches {per_step}, {launches} differ")
            if not torch.isfinite(torch.stack(losses)).all():
                fail("phase 25b: a stage-2 loss is not finite")
            _f32_everywhere(tr, "stage 2", [tr.score])
            med["stage 2 bf16"] = statistics.median(ms)

            # the wrong variant: a Dense that computes in its weight's f32
            def f32_dense(self, x):
                return F.linear(x.to(self.weight.dtype), self.weight,
                                self.bias)

            with mock.patch.object(Dense, "forward", f32_dense):
                _steps(tr, data, 1, seen)
            wrong = seen.get(("packed_self_attention", "bfloat16"), 0)
            print(f"[25b] wrong variant (Dense casts to its f32 weight): "
                  f"launches by dtype {dict(seen)}")
            if wrong == 24:
                fail("phase 25b: the f32-computing variant passes the bf16 "
                     "launch count")
            _profile_by_class("25b stage 2 bf16", lambda: tr.update(data),
                              MP_PROFILED, os.path.join(tmp, "trace_bf16"))
            del tr
            gc.collect()
            torch.cuda.empty_cache()

            # the f32 step of the same config in this run
            cfg32 = _mp_config("Latent_Diffusion_Trainer/airplane", tmp,
                               "float32")
            tr = lt.Trainer(cfg32, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(SEED))
            tr.maybe_init(data)
            _steps(tr, data, 2)
            torch.cuda.reset_peak_memory_stats()
            _, ms = _steps(tr, data, MP_STEPS, seen)
            med["stage 2 f32"] = statistics.median(ms)
            print(f"[25b] stage 2, f32, B={batch}: median "
                  f"{med['stage 2 f32']:.2f} ms a step, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
            _profile_by_class("25b stage 2 f32", lambda: tr.update(data),
                              MP_PROFILED, os.path.join(tmp, "trace_f32"))
            del tr
            gc.collect()
            torch.cuda.empty_cache()

            # stage 1
            for dt in ("bfloat16", "float32"):
                cfg1 = _mp_config("Compressor_Trainer/airplane", tmp, dt)
                b1 = cfg1.data.batch_size
                d1 = {"tr_points": torch.randn(b1, 2048, 3, device="cuda",
                                               generator=gen)}
                tr = ct.Trainer(cfg1, device="cuda",
                                generator=torch.Generator(
                                    "cuda").manual_seed(SEED))
                tr.maybe_init(d1)
                _steps(tr, d1, 2)
                (losses, ms), _, launches = counted(
                    lambda: _steps(tr, d1, MP_STEPS, seen))
                med[f"stage 1 {dt}"] = statistics.median(ms)
                per_step = {k: v / MP_STEPS for k, v in seen.items()}
                print(f"[25b] stage 1, {dt}, B={b1}: median "
                      f"{med[f'stage 1 {dt}']:.2f} ms a step; launches by "
                      f"dtype a step {per_step}; K4 long-key "
                      f"{launches['cross_attention_bwd_long_key']}, "
                      f"long-query "
                      f"{launches['cross_attention_bwd_long_query']}, "
                      f"tiled {launches['cross_attention_bwd_tiled']}")
                if dt == "bfloat16":
                    want = {("cross_attention", "bfloat16"): 24,
                            ("cross_attention_bwd", "bfloat16"): 24}
                    if per_step != want or launches[
                            "cross_attention_bwd_tiled"] != 24 * MP_STEPS:
                        fail(f"phase 25b: the mixed-precision stage-1 "
                             f"step's launches {per_step} differ from "
                             f"{want}")
                    _f32_everywhere(tr, "stage 1", [tr.model])
                if not torch.isfinite(torch.stack(
                        [torch.stack(x) for x in losses])).all():
                    fail(f"phase 25b: a stage-1 {dt} loss is not finite")
                del tr
                gc.collect()
                torch.cuda.empty_cache()

            # the hybrid step
            cfgh = _mp_config("Hybrid_Trainer/airplane", tmp)
            bh = cfgh.data.batch_size
            dh_ = {"tr_points": torch.randn(bh, 2048, 3, device="cuda",
                                            generator=gen)}
            tr = ht.Trainer(cfgh, device="cuda", generator=torch.Generator(
                "cuda").manual_seed(SEED))
            tr.maybe_init(dh_)
            (out, ms), _, _ = counted(lambda: _steps(tr, dh_, 2, seen))
            per_step = {k: v / 2 for k, v in seen.items()}
            want = {("packed_self_attention", "bfloat16"): 48,
                    ("packed_self_attention_bwd", "bfloat16"): 48,
                    ("cross_attention", "bfloat16"): 24,
                    ("cross_attention_bwd", "bfloat16"): 24}
            print(f"[25b] hybrid, bf16, B={bh}: steps "
                  f"{[round(x, 2) for x in ms]} ms; launches by dtype a step "
                  f"{per_step} (expected {want})")
            if per_step != want:
                fail(f"phase 25b: the mixed-precision hybrid step's launches "
                     f"{per_step} differ from {want}")
            if not all(torch.isfinite(torch.stack(o)).all() for o in out):
                fail("phase 25b: a hybrid loss is not finite")
            _f32_everywhere(tr, "hybrid", [tr.score, tr.compressor])
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        print("[25b] median ms a step, this run: " + ", ".join(
            f"{k} {v:.2f}" for k, v in med.items())
            + f" ({smi_name_and_power()})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_train_reference(mixed=True)


def phase_dropout(gen) -> None:
    """Phase 25c: the flagship stage-2 step with `score.dropout` 0.1
    (B=64): two trainers of one seed take the same step bit for bit (loss,
    parameters, masks), the same weights with another draw seed another;
    the kept share within 5 binomial sigmas of 0.9; `val_loss` and a short
    `sample` with dropout 0.1 equal those with 0.0 on the same weights; a
    Compressor's training forward with a nonzero rate, and a conditional
    Score's training step with dropout, raise on the card."""
    import gc
    import math

    import torch

    from ldt_torch.configs import compressor_cfg, latent_trainer_cfg
    from ldt_torch.models import Compressor
    from ldt_torch.nn.layers import DropoutMasks
    from ldt_torch.training import completion_latent_sde_trainer as clt
    from ldt_torch.training import latent_sde_trainer as lt

    gc.collect()
    torch.cuda.empty_cache()
    cfg = latent_trainer_cfg(score=dict(dropout=DROPOUT),
                             sde=dict(sample_N=CHECK_STEPS))
    batch = cfg.data.batch_size
    data = {"tr_points": torch.randn(batch, 2048, 3, device="cuda",
                                     generator=gen)}
    pins = dict(t_idx=torch.arange(batch, device="cuda") * 7,
                eta=torch.randn(batch, cfg.score.z_scale, cfg.score.z_dim,
                                device="cuda", generator=gen))

    def step(draw_seed=None):
        tr = lt.Trainer(cfg, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(SEED))
        tr.maybe_init(data)
        if draw_seed is not None:
            tr.generator.manual_seed(draw_seed)
        masks = DropoutMasks(tr.generator, record=True)
        tr.dropout_masks = lambda m=None: masks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tr.update(data, **pins)
        torch.cuda.synchronize()
        return tr, loss, masks.drawn, (time.perf_counter() - t0) * 1e3

    a, la, ma, ms = step()
    pa = {k: v.detach().clone() for k, v in a.state.params.items()}
    kept = sum(int(m.sum()) for m in ma)
    n = sum(m.numel() for m in ma)
    weights = ({k: v.cpu() for k, v in a.score.state_dict().items()},
               {k: v.cpu() for k, v in a.compressor.state_dict().items()})
    del a
    gc.collect()
    b, lb, mb, _ = step()
    same = (torch.equal(la, lb) and len(ma) == len(mb)
            and all(torch.equal(x, y) for x, y in zip(ma, mb))
            and all(torch.equal(pa[k], v) for k, v in b.state.params.items()))
    del b, mb
    gc.collect()
    c, lc, mc, _ = step(draw_seed=SEED + 1)
    other = not torch.equal(la, lc) and not torch.equal(ma[0], mc[0])
    del c, mc, ma
    gc.collect()
    torch.cuda.empty_cache()
    share = kept / n
    sigma = math.sqrt((1 - DROPOUT) * DROPOUT / n)
    print(f"[25c] stage-2 step with score.dropout {DROPOUT}, B={batch}: "
          f"{ms:.2f} ms; {n} dropout elements over "
          f"{2 * cfg.score.num_blocks} sites, kept share {share:.6f} "
          f"(0.9 +- {5 * sigma:.2e}); same seed, same step bit for bit: "
          f"{same}; another draw seed, another step: {other}")
    if not (same and other) or abs(share - (1 - DROPOUT)) > 5 * sigma:
        fail("phase 25c: the dropout step is not reproducible, or its "
             "kept share is off")

    # eval paths: dropout 0.1 and 0.0 on the same weights and draws
    res = []
    for rate in (DROPOUT, 0.0):
        c2 = latent_trainer_cfg(score=dict(dropout=rate),
                                sde=dict(sample_N=CHECK_STEPS))
        tr = lt.Trainer(c2, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(SEED))
        tr.maybe_init(data, score_weights=weights[0],
                      compressor_weights=weights[1])
        tr.generator.manual_seed(SEED + 2)
        v = tr.val_loss({"te_points": data["tr_points"][:8]},
                        t_idx=pins["t_idx"][:8], eta=pins["eta"][:8])
        clouds, _ = tr.sample(8)
        res.append((v, clouds))
        del tr
        gc.collect()
    eq = torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1],
                                                           res[1][1])
    print(f"[25c] val_loss {res[0][0].item():.6f} and a {CHECK_STEPS}-step "
          f"sample(8) with dropout {DROPOUT} equal those with 0.0: {eq}")
    if not eq:
        fail("phase 25c: dropout reached val_loss or sample")
    del res
    torch.cuda.empty_cache()

    # where the JAX package's dropout raises
    raised = []
    comp = Compressor(compressor_cfg(encoder_dropout_p=DROPOUT),
                      device="cuda", generator=torch.Generator(
                          "cuda").manual_seed(SEED))
    try:
        comp(data["tr_points"][:2], train=True)
    except ValueError:
        raised.append("Compressor")
    del comp
    cc = completion_cfg(score=dict(num_blocks=2, dropout=DROPOUT))
    ctr = clt.Trainer(cc, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(SEED))
    pts = data["tr_points"][:2]
    ctr.maybe_init({"tr_points": pts})
    cond = {"img": torch.rand(2, 64, 64, 3, device="cuda", generator=gen),
            "pts": pts}
    try:
        ctr.update(pts, cond)
    except ValueError:
        raised.append("conditional Score step")
    del ctr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[25c] training with dropout raised on the card for: {raised}")
    if raised != ["Compressor", "conditional Score step"]:
        fail(f"phase 25c: only {raised} raised")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import ldt_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_name_and_power()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} ({card})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    phase_build()
    rows = phase_kernels(BATCH, gen)
    rows.update(phase_k8(BATCH, gen))
    phase_int8_gemms(gen)
    rows.update(phase_train_kernels(BATCH, gen))
    rows.update(phase_k4(STAGE1_BATCH, gen))
    rows.update(phase_eval_kernels())
    score, comp, weights = build_models(gen)
    phase_path(score, comp, BATCH, CHECK_STEPS, gen)
    launches = phase_generate(score, comp, BATCH, STEPS, gen)
    k8_launches = phase_int8_generate(score, comp, weights, BATCH, STEPS,
                                      gen)
    phase_ddim_int8(score, comp, weights, BATCH, CHECK_STEPS, gen)
    phase_profile(score, comp, BATCH, CHECK_STEPS, gen, "bf16")
    phase_profile(score, comp, BATCH, CHECK_STEPS, gen, "int8 W8A8, K8",
                  int8=True, int8_weights=weights, attn_int8=True)
    del score, comp, weights
    train_launches = phase_train(BATCH, TRAIN_STEPS, gen)
    stage1_launches, stage1 = phase_stage1_train(TRAIN_STEPS, gen)
    eval_launches = phase_eval(stage1)
    del stage1
    phase_int8_step(CHECK_STEPS)
    phase_train_reference()
    phase_stage1_reference()
    phase_eval_reference()
    phase_reference(CHECK_STEPS)
    phase_entries()
    phase_ref_merge_path()
    phase_train_reference(ref_merge=True)
    phase_stage1_reference(ref_merge=True)
    stage2 = phase_all_configs()
    phase_label_generate(stage2)
    del stage2
    rows.update(phase_dit_cross_kernels(gen))
    phase_condition_reference()
    completion, batch, k4_dit = phase_completion_entries()
    k2_dit = phase_completion_generate(completion, batch)
    del completion, batch
    phase_hybrid_reference()
    phase_hybrid_entry()
    phase_moment_dtype()
    phase_mixed_precision(gen)
    phase_dropout(gen)
    # each kernel's count from the run of its own path: K1 and K2 from the
    # bf16 generation, K8 from the int8 generation through K8, K3 and the
    # tiled K2 from the timed stage-2 train steps, K4 (all schedules, the
    # long-key and the multi-tile long-query one) from the timed stage-1
    # steps, K5, K6 and K7 from the eval runs of phase 19
    launches["packed_self_attention_int8"] = k8_launches[
        "packed_self_attention_int8"]
    for name in ("packed_self_attention_bwd", "cross_attention_tiled"):
        launches[name] = train_launches[name]
    for name in K4_ROWS.values():
        launches[name] = stage1_launches[name]
    launches.update(eval_launches)
    # the DiT's cross shape: K2 from the completion generation's Score
    # (not its decode), K4 from the completion stage-2 training legs
    launches["cross_attention_dit_cross"] = k2_dit
    launches["cross_attention_bwd_dit_cross"] = k4_dit
    # K6's row counts the launches with d streamed (the wrapper's count
    # holds both modes)
    launches["approx_match_cost"] -= launches["approx_match_cost_otf"]
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
