#!/usr/bin/env python3
"""Bring-up check of the `ldt_torch` port on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository:  python3 chip_smoke.py

Phases (each raises on failure, so the process exits non-zero):
  1. Build the CUDA kernels (ldt_torch/csrc/*.cu) with nvcc; print the time.
  2. Hold each kernel against its plain PyTorch twin on the card at the main
     path's shapes, in f32 and bf16; time the kernel, the twin and one
     `scaled_dot_product_attention` call on the same tensors (a yardstick
     only: the port never calls it); work out each kernel's bound.
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

The last two lines of standard output before the final one are the kernel
table (JSON) and the card's `nvidia-smi` name and power limit; the final line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

# H100 SXM data-sheet peaks (dense): device memory 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; f32 outside the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
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
# Phase 6, card vs CPU in f32, (max, mean) relative to the largest |value|,
# for the sampler and the decoder: the sums run in other orders.
REF_TOL = {"sampler": (1e-5, 1.2e-7), "decoder": (1e-5, 2e-6)}
BATCH = 64         # clouds per generation, as bench.py
STEPS = 1000       # ancestral steps of the main path
CHECK_STEPS = 32   # phases 3, 5 and 6 (beta_end / N must stay below 1)
SEED = 0


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
    from ldt_torch.ops import _build
    from ldt_torch.ops import attention as attn_ops

    t0 = time.perf_counter()
    log = _build.build("attention")
    attn_ops._lib()
    dt = time.perf_counter() - t0
    print(f"[1] build: {dt:.3f} s ({'cached' if log is None else 'compiled'})")
    for line in (log or "").splitlines():
        if any(w in line for w in ("registers", "spill", "error", "warning")):
            print(f"    nvcc: {line.strip()}")


def _bound(nbytes: int, flops: int, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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
    rows = {}
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
        for name, c in cases.items():
            got = c["kernel"]()
            readings = {"twin": errs(got, c["plain"]()),
                        "cpu twin": errs(got, c["plain_cpu"]())}
            for vname, (acc, w) in variants(dtype).items():
                readings[vname] = errs(got, c["variant"](acc, w))
            err = readings["twin"][0]
            ms = cuda_ms(c["kernel"])
            plain_ms = cuda_ms(c["plain"], iters=20)
            library_ms = cuda_ms(c["library"])
            bound_ms, bound_by = _bound(c["nbytes"], c["flops"], dn)
            print(f"[2] {name} {dn} {c['shape']}: max_abs_err {err:.3e}, "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {c['nbytes'] / 1e6:.1f} MB, "
                  f"{c['flops'] / 1e9:.3f} GFLOP)")
            held(f"{name} {dn} vs", readings, KERNEL_TOL[dn],
                 right=("twin", "cpu twin", "f64"))
            if dtype == torch.bfloat16:  # the main path's dtype
                rows[name] = {
                    "name": name, "route": "cuda", "source": c["source"],
                    "replaces": c["replaces"], "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms}
    return rows


def build_models(gen):
    import torch

    from ldt_torch.configs import compressor_cfg, score_cfg
    from ldt_torch.models import Compressor, Score

    t0 = time.perf_counter()
    score = Score(score_cfg(), dtype=torch.bfloat16, device="cuda",
                  generator=gen).eval()
    comp = Compressor(compressor_cfg(), dtype=torch.bfloat16, device="cuda",
                      generator=gen).eval()
    torch.cuda.synchronize()
    n_score = sum(p.numel() for p in score.parameters())
    n_comp = sum(p.numel() for p in comp.parameters())
    print(f"[3] flagship Score {n_score / 1e6:.2f}M params (24 blocks, "
          f"hidden 1024, bf16), decoder {n_comp / 1e6:.3f}M params, "
          f"random init from seed 0: {time.perf_counter() - t0:.2f} s")
    return score, comp


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


def phase_generate(score, comp, batch: int, steps: int, gen) -> dict:
    import torch

    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate
    from ldt_torch.ops import attention as attn_ops

    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    attn_ops.packed_self_attention.launches = 0
    attn_ops.cross_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(score, comp, sde, batch, steps, device="cuda",
                   generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"packed_self_attention":
                attn_ops.packed_self_attention.launches,
                "cross_attention": attn_ops.cross_attention.launches}
    expect = {"packed_self_attention": score.cfg.num_blocks * steps,
              "cross_attention": comp.cfg.n_layers}
    finite = bool(torch.isfinite(out).all())
    print(f"[4] generate: {steps} steps + decode, B={batch}: out "
          f"{list(out.shape)} {out.dtype}, finite {finite}, {dt:.3f} s, "
          f"{batch / dt * 60.0:.2f} clouds/min, launches {launches} "
          f"(expected {expect})")
    if tuple(out.shape) != (batch, 2048, 3) or not finite:
        fail("generate output has the wrong shape or is not finite")
    if launches != expect:
        fail(f"launch counts {launches} differ from the path's {expect}")
    return launches


def phase_profile(score, comp, batch: int, steps: int, gen) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldt_torch.configs import sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate

    sde = make_diffusion(sde_cfg(sample_N=steps), device="cuda")
    generate(score, comp, sde, batch, steps, device="cuda", generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(score, comp, sde, batch, steps, device="cuda", generator=gen)
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(score, comp, sde, batch, steps, device="cuda",
                 generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + us
    busy = sum(kernels.values())
    if busy == 0:
        print("[5] profile: the profiler recorded no device time "
              "(not measured)")
        return
    groups = {"K1 packed_self_attention": 0.0, "K2 cross_attention": 0.0,
              "GEMM": 0.0, "other": 0.0}
    for key, us in kernels.items():
        low = key.lower()
        if "packed_self_attention" in low:
            groups["K1 packed_self_attention"] += us
        elif "cross_attention" in low:
            groups["K2 cross_attention"] += us
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["GEMM"] += us
        else:
            groups["other"] += us
    print(f"[5] profile of generate ({steps} steps + decode, B={batch}): "
          f"device busy {busy / 1e3:.2f} ms; wall {wall_us / 1e3:.2f} ms "
          f"profiled (idle share {1 - busy / wall_us:.3f}), "
          f"{plain_wall_us / 1e3:.2f} ms not profiled (idle share "
          f"{1 - busy / plain_wall_us:.3f})")
    for g, us in groups.items():
        print(f"    {g}: {us / 1e3:.2f} ms ({us / busy:.3f} of busy)")
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us / 1e3:9.2f} ms  {key[:110]}")


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
    score, comp = build_models(gen)
    phase_path(score, comp, BATCH, CHECK_STEPS, gen)
    launches = phase_generate(score, comp, BATCH, STEPS, gen)
    phase_profile(score, comp, BATCH, CHECK_STEPS, gen)
    del score, comp
    phase_reference(CHECK_STEPS)
    for name, n in launches.items():
        rows[name]["launches"] = n
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
