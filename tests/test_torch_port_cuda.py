"""The CUDA kernels K1, K2, K3, K4, K5, K6/K7 and K8 against their plain
twins (K2 and K4 also at the conditional DiT's cross-attention shape),
small stage-1 and stage-2 train steps, the eval metrics and the
ConditionNet's trunk at IEEE f32, on the card.

These tests need an NVIDIA GPU (sm_90a) and nvcc; without a card they skip.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import ctypes
from unittest import mock

import pytest
import torch

from ldt_torch.ops import attention as ops

pytestmark = pytest.mark.cuda

# (max, mean) of |kernel - plain|, the limits of chip_smoke.py's phase 2
# (PERF.md gives the readings they were set from): a right answer that rounds
# elsewhere stays 5x below both; a kernel that rounds the weights in the
# wrong dtype lands 2x above the max in bf16 and 30x above the mean.
TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (8e-3, 1e-5)}
# The sampler's latents and the decoder's clouds, kernels vs plain
# attention, relative to their largest |value| (chip_smoke.py's phase 3).
PATH_TOL = ((5e-3, 5e-4), (1e-2, 6e-5))
# K8 vs its twin, (max, mean) of |kernel - twin| (chip_smoke.py's phase 7):
# only a weight code that exp or the row sum rounds to its neighbour
# differs, by at most one v code step (max|v| / 127) plus an output ulp.
K8_TOL = (0.08, 1e-5)
# K3 vs its twin, (max, mean) of |kernel - twin| relative to the largest
# |twin| (chip_smoke.py's phase 12).
K3_TOL = {torch.float32: (1e-5, 1e-7), torch.bfloat16: (8e-3, 1e-5)}
# K4 vs its twin, each of dq, dk, dv relative to its largest |twin|
# (chip_smoke.py's phase 15): in f32 the dk and dv sums over 2048 query rows
# run in another order than the twin's (read 1.8e-6 / 1.0e-7).
K4_TOL = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (8e-3, 1e-5)}
# K5 and K6/K7 vs their twins, (max, mean) of |kernel - twin| relative to
# each pair's |twin| (chip_smoke.py's phase 18): K5's minima are the twin's
# bits, only the means' sums run in another order; K6/K7's sums over 2048
# rows and columns too, through nine levels.
K5_TOL = (1e-5, 1e-6)
K6_TOL = (3e-5, 2e-6)


def _assert_within(got, want, tol, scale=1.0):
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= tol[0] * scale, diff.max().item()
    assert diff.mean().item() <= tol[1] * scale, diff.mean().item()


def _launched(fn, calls: int = 10) -> str:
    """The names of the CUDA kernels that `fn` launches, from
    torch.profiler over `calls` calls. A session that records no kernel at
    all (the profiler has dropped a whole session's records in a long
    process, as chip_smoke.launch_us also finds) is taken again, twice at
    most."""
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = " ".join(e.key for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        if names:
            break
    return names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, device="cuda", dtype=dtype, generator=gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", [(8, 32, 16, 64),   # the DiT's shape
                                      (3, 17, 3, 24),    # ragged sizes
                                      (2, 64, 2, 128)])  # > 48 KB smem
def test_packed_self_attention_kernel(card, b, n, h, dh, dtype):
    qkv = _randn(card, b, n, 3 * h * dh, dtype=dtype)
    before = ops.packed_self_attention.launches
    got = ops.packed_self_attention(qkv, h)
    torch.cuda.synchronize()
    assert ops.packed_self_attention.launches == before + 1
    want = ops.packed_self_attention_plain(qkv, h)
    assert got.dtype == dtype and got.shape == (b, n, h * dh)
    _assert_within(got, want, TOL[dtype])


BF16, F32 = torch.bfloat16, torch.float32
# (b, n, h, dh, dtype, schedule) of K1: in bf16 the tensor cores at the
# DiT's shape and at the edges of their rule (N = 16, 48, 64; dh = 16, 32,
# 128; B = 1; a head group of 4 left ragged), the CUDA cores past it (N =
# 17, dh = 24); in f32 the register-tiled schedule at the train step's
# shape, at ragged sizes (N = 17, dh = 24, a head pair left ragged) and past
# 48 KB of shared memory, the first CUDA-core kernel past its budget (N =
# 128) or with dh not a multiple of 4
K1_CASES = [(8, 32, 16, 64, BF16, "mma"), (2, 16, 4, 64, BF16, "mma"),
            (2, 48, 4, 64, BF16, "mma"), (2, 64, 2, 64, BF16, "mma"),
            (2, 32, 6, 32, BF16, "mma"), (2, 64, 2, 128, BF16, "mma"),
            (1, 32, 16, 64, BF16, "mma"), (1, 16, 5, 16, BF16, "mma"),
            (2, 17, 4, 64, BF16, "fma"), (2, 32, 4, 24, BF16, "fma"),
            (2, 80, 2, 64, BF16, "fma"),
            (8, 32, 16, 64, F32, "tiled"), (3, 17, 3, 24, F32, "tiled"),
            (2, 64, 2, 96, F32, "tiled"), (1, 5, 1, 4, F32, "tiled"),
            (2, 64, 2, 128, F32, "tiled"), (1, 128, 2, 64, F32, "fma"),
            (2, 32, 2, 30, F32, "fma")]
# the kernel each schedule of K1 launches, as torch.profiler names it
K1_KERNELS = {"mma": "packed_self_attention_mma_kernel",
              "tiled": "packed_self_attention_tiled_kernel",
              "fma": "packed_self_attention_kernel<"}


def _k1_counts():
    fn = ops.packed_self_attention
    return fn.launches, fn.mma_launches, fn.tiled_launches


@pytest.mark.parametrize("b,n,h,dh,dtype,schedule", K1_CASES)
def test_packed_self_attention_schedules_repeat_their_bits(card, b, n, h, dh,
                                                           dtype, schedule):
    """K1 on the schedule `packed_schedule` names, against its twin,
    repeating its bits; `.mma_launches` and `.tiled_launches` count exactly
    the calls the library reports on those schedules, and the profiler sees
    that schedule's kernel run."""
    qkv = _randn(card, b, n, 3 * h * dh, dtype=dtype)
    assert ops.packed_schedule(n, dh, dtype) == schedule
    fn = ops.packed_self_attention
    before = _k1_counts()
    got = fn(qkv, h)
    again = fn(qkv, h)
    torch.cuda.synchronize()
    assert _k1_counts() == (before[0] + 2,
                            before[1] + 2 * (schedule == "mma"),
                            before[2] + 2 * (schedule == "tiled"))
    assert torch.equal(got, again)
    names = _launched(lambda: fn(qkv, h))
    for sched, kernel in K1_KERNELS.items():
        assert (kernel in names) == (sched == schedule), names
    _assert_within(got, ops.packed_self_attention_plain(qkv, h), TOL[dtype])
    _assert_within(got.cpu(), ops.packed_self_attention_plain(qkv.cpu(), h),
                   TOL[dtype])


def _unaligned(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = flat[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    return off


@pytest.mark.parametrize("b,n,h,dh", [(8, 32, 16, 64),   # the DiT's shape
                                      (3, 17, 3, 24),    # ragged sizes
                                      (2, 64, 2, 96)])   # > 48 KB smem
def test_packed_self_attention_unaligned_and_f32_take_the_cuda_cores(
        card, b, n, h, dh):
    """A qkv whose rows start off a 16-byte boundary takes the first CUDA-core
    kernel in either dtype; an aligned f32 qkv takes the register-tiled
    schedule, which gives that kernel's bits."""
    fn = ops.packed_self_attention
    qkv = _randn(card, b, n, 3 * h * dh, dtype=F32)
    assert ops.packed_schedule(n, dh, F32) == "tiled"
    assert ops.packed_schedule(n, dh, F32, aligned=False) == "fma"
    outs = {}
    for x, want in ((qkv, "tiled"), (_unaligned(qkv), "fma"),
                    (_unaligned(qkv.bfloat16()), "fma")):
        before = _k1_counts()
        got = fn(x, h)
        torch.cuda.synchronize()
        assert _k1_counts() == (before[0] + 1, before[1],
                                before[2] + (want == "tiled"))
        names = _launched(lambda: fn(x, h))
        assert K1_KERNELS[want] in names and "mma" not in names, names
        _assert_within(got, ops.packed_self_attention_plain(x, h),
                       TOL[x.dtype])
        outs[(x.dtype, want)] = got
    assert torch.equal(outs[(F32, "tiled")], outs[(F32, "fma")])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,d,h", [(4, 2048, 32, 128, 4),  # decode
                                       (2, 100, 45, 96, 2),    # M, dh > 32
                                       (1, 70, 512, 64, 2)])   # > 48 KB
def test_cross_attention_kernel(card, b, n, m, d, h, dtype):
    q = _randn(card, b, n, d, dtype=dtype)
    k = _randn(card, b, m, d, dtype=dtype)
    v = _randn(card, b, m, d, dtype=dtype)
    before = ops.cross_attention.launches
    got = ops.cross_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert ops.cross_attention.launches == before + 1
    want = ops.attention_plain(q, k, v, h)
    _assert_within(got, want, TOL[dtype])


@pytest.mark.parametrize("entry", ["ldt_packed_self_attention",
                                   "ldt_packed_self_attention_int8",
                                   "ldt_packed_self_attention_bwd"])
def test_a_refused_launch_raises(card, entry):
    """The C entry points return the CUDA error; the wrapper's check turns
    it into an exception (here: an unknown dtype code). K1, K8 and K3
    report no schedule for a launch they refused."""
    qkv = _randn(card, 4, 4, 24, dtype=torch.float32)
    out = torch.empty(4, 4, 8, device="cuda")
    scratch = torch.empty(ops.int8_scratch(4, 4, 4), device="cuda")
    schedule = ctypes.c_int(-1)
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "ldt_packed_self_attention":
        err = ops._lib().ldt_packed_self_attention(
            qkv.data_ptr(), out.data_ptr(), 4, 4, 8, 2, 0.5, 7, stream,
            ctypes.byref(schedule))
    elif entry == "ldt_packed_self_attention_int8":
        err = ops._lib().ldt_packed_self_attention_int8(
            qkv.data_ptr(), scratch.data_ptr(), out.data_ptr(), 4, 4, 8, 2,
            4, 0.5, 7, stream, ctypes.byref(schedule))
    else:
        dqkv = torch.empty_like(qkv)
        err = ops._lib().ldt_packed_self_attention_bwd(
            qkv.data_ptr(), out.data_ptr(), dqkv.data_ptr(), 4, 4, 8, 2, 0.5,
            7, stream, ctypes.byref(schedule))
    assert err != 0 and schedule.value == 0  # no launch, no schedule
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops._raise_on(err, entry)


def test_small_generate_through_the_kernels(card):
    from ldt_torch.configs import compressor_cfg, score_cfg, sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate, sample_latents
    from ldt_torch.models import Compressor, Score

    score = Score(score_cfg(num_blocks=2), dtype=torch.bfloat16,
                  generator=card)
    comp = Compressor(compressor_cfg(), dtype=torch.bfloat16,
                      generator=card)
    sde = make_diffusion(sde_cfg(sample_N=32))
    shape = (4, 32, 120)
    x0 = torch.randn(shape, device="cuda", generator=card)
    noise = torch.randn((32,) + shape, device="cuda", generator=card)
    k1, k2 = ops.packed_self_attention.launches, ops.cross_attention.launches
    got = generate(score, comp, sde, 4, 32, x0=x0, noise=noise).float()
    assert ops.packed_self_attention.launches - k1 == 2 * 32
    assert ops.cross_attention.launches - k2 == 6
    assert got.shape == (4, 2048, 3) and torch.isfinite(got).all()
    # the decoder is chaotic at the random sampler's |latent| ~ 1e3: hold
    # the sampler, and the decoder on N(0, 1) latents, apart
    eps = torch.randn(shape, device="cuda", generator=card)

    def halves():
        lat = sample_latents(score, sde, 4, 32, x0=x0, noise=noise)
        with torch.inference_mode():
            return lat, comp.sample((4, 2048), eps)

    got = halves()
    with mock.patch.object(ops, "packed_self_attention",
                           ops.packed_self_attention_plain), \
            mock.patch.object(ops, "cross_attention", ops.attention_plain):
        want = halves()
    for g, w, tol in zip(got, want, PATH_TOL):
        _assert_within(g, w, tol, w.float().abs().max().item())


# (b, n, h, dh, schedule) of K8: the int8 tensor cores at the DiT's shape,
# at ragged sizes (N = 48 and 16, whose keys pad to 64 and 32; head groups
# of 4 left ragged) and past 48 KB of shared memory; the CUDA-core kernels
# at N = 17, dh = 24
K8_CASES = [(64, 32, 16, 64, "mma"), (8, 48, 3, 96, "mma"),
            (4, 16, 5, 32, "mma"), (4, 64, 2, 128, "mma"),
            (8, 17, 3, 24, "fma")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh,schedule", K8_CASES)
def test_packed_self_attention_int8_kernel(card, b, n, h, dh, schedule,
                                           dtype):
    """K8 against its twin on the card and on the CPU, repeating its bits,
    on the schedule the library reports (`.mma_launches`) and the profiler
    names; per-element scales (E=1) fail the limit."""
    qkv = _randn(card, b, n, 3 * h * dh, dtype=dtype)
    fn = ops.packed_self_attention_int8
    before = (fn.launches, fn.mma_launches)
    got = fn(qkv, h)
    torch.cuda.synchronize()
    assert (fn.launches, fn.mma_launches) == (
        before[0] + 1, before[1] + (schedule == "mma"))
    assert got.dtype == dtype and got.shape == (b, n, h * dh)
    assert torch.equal(got, fn(qkv, h))
    names = _launched(lambda: fn(qkv, h))
    assert ("packed_self_attention_int8_mma_kernel" in names) == (
        schedule == "mma"), names
    _assert_within(got, ops.packed_self_attention_int8_plain(qkv, h), K8_TOL)
    _assert_within(got.cpu(), ops.packed_self_attention_int8_plain(
        qkv.cpu(), h), K8_TOL)
    wrong = ops.packed_self_attention_int8_plain(qkv, h, 1)
    with pytest.raises(AssertionError):
        _assert_within(got, wrong, K8_TOL)


def _k8_direct(qkv, h, elems=4):
    """K8 through its C entry: (out, the group scales, the schedule)."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    out = torch.empty(b, n, d, dtype=qkv.dtype, device=qkv.device)
    scratch = torch.full((ops.int8_scratch(b, n, elems),), float("nan"),
                         device=qkv.device)
    schedule = ctypes.c_int(-1)
    err = ops._lib().ldt_packed_self_attention_int8(
        qkv.data_ptr(), scratch.data_ptr(), out.data_ptr(), b, n, d, h,
        elems, (d // h) ** -0.5, ops._DTYPE_CODES[qkv.dtype],
        torch.cuda.current_stream().cuda_stream, ctypes.byref(schedule))
    ops._raise_on(err, "ldt_packed_self_attention_int8")
    torch.cuda.synchronize()
    return out, scratch[:b // elems * 3].view(b // elems, 3), schedule.value


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", [(64, 32, 16, 64), (8, 48, 3, 96),
                                      (4, 64, 2, 128)])
def test_k8_tensor_cores_give_the_cuda_core_kernels_bits(card, b, n, h, dh,
                                                         dtype):
    """The int8 tensor-core schedule and the CUDA-core kernels (taken by a copy
    off 16-byte alignment) give the same output and group scales bit for
    bit; the scales are max|x| / 127 + 1e-20 per group and part."""
    qkv = _randn(card, b, n, 3 * h * dh, dtype=dtype)
    out, scales, schedule = _k8_direct(qkv, h)
    old_out, old_scales, old_schedule = _k8_direct(_unaligned(qkv), h)
    assert (schedule, old_schedule) == (1, 0)
    assert torch.equal(out, old_out) and torch.equal(scales, old_scales)
    x = qkv.float().reshape(b // 4, 4 * n, 3, h * dh)
    want = ops.true_divide(x.abs().amax(dim=(1, 3)), 127.0) + 1e-20
    assert torch.equal(scales, want)


def test_k8_refuses_a_batch_not_a_multiple_of_its_group(card):
    qkv = _randn(card, 6, 32, 3 * 1024, dtype=torch.bfloat16)
    before = ops.packed_self_attention_int8.launches
    with pytest.raises(ValueError, match="multiple"):
        ops.packed_self_attention_int8(qkv, 16)
    assert ops.packed_self_attention_int8.launches == before
    assert ops.packed_self_attention_int8(qkv, 16, elems=2).shape == (
        6, 32, 1024)


def test_int8_matmul_on_the_card_equals_the_cpu(card):
    """The dynamic and static int8 GEMM: exact integer products and the
    same IEEE scaling on both devices; `_int_mm`'s limits raise."""
    from ldt_torch.serving import int8 as int8_serving

    x = _randn(card, 4, 32, 1024, dtype=torch.bfloat16)
    w = _randn(card, 3072, 1024, dtype=torch.float32) * 0.03
    w_i8, w_s = int8_serving.quantize_weight(w)
    c_i8, c_s = int8_serving.quantize_weight(w.cpu())
    assert torch.equal(w_i8.cpu(), c_i8) and torch.equal(w_s.cpu(), c_s)
    for x_scale in (None, torch.tensor(0.02)):
        got = int8_serving.int8_matmul(
            x, w_i8, w_s, x_scale=None if x_scale is None
            else x_scale.cuda())
        want = int8_serving.int8_matmul(x.cpu(), c_i8, c_s, x_scale=x_scale)
        assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="_int_mm"):
        int8_serving.int8_matmul(x[:, :4], w_i8, w_s)  # M = 16


def test_small_int8_generate_through_k8(card):
    from ldt_torch.configs import compressor_cfg, score_cfg, sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate
    from ldt_torch.models import Compressor, Score

    score = Score(score_cfg(num_blocks=2), generator=card)
    comp = Compressor(compressor_cfg(), dtype=torch.bfloat16,
                      generator=card)
    sde = make_diffusion(sde_cfg(sample_N=32))
    k1, k8, mma = (ops.packed_self_attention.launches,
                   ops.packed_self_attention_int8.launches,
                   ops.packed_self_attention_int8.mma_launches)
    got = generate(score, comp, sde, 4, 32, int8=True, attn_int8=True,
                   generator=card)
    assert ops.packed_self_attention.launches == k1
    assert ops.packed_self_attention_int8.launches - k8 == 2 * 32
    # every K8 launch at the DiT's shape took the int8 tensor cores
    assert ops.packed_self_attention_int8.mma_launches - mma == 2 * 32
    assert got.shape == (4, 2048, 3) and torch.isfinite(got.float()).all()


def _k3_counts():
    fn = ops.packed_self_attention_bwd
    return fn.launches, fn.tiled_launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", [(8, 32, 16, 64),   # the DiT's shape
                                      (3, 17, 3, 24),    # ragged sizes
                                      (2, 64, 2, 96),    # > 48 KB smem
                                      (2, 20, 3, 10)])   # dh = 10
def test_packed_self_attention_bwd_kernel(card, b, n, h, dh, dtype):
    """K3 against its twin under K3_TOL, repeating its bits; the counts
    follow the tiled rule (dh = 10 takes the scalar kernel)."""
    qkv = _randn(card, b, n, 3 * h * dh, dtype=dtype)
    g = _randn(card, b, n, h * dh, dtype=dtype)
    before = _k3_counts()
    got = ops.packed_self_attention_bwd(qkv, g, h)
    torch.cuda.synchronize()
    tiled = ops.self_bwd_tiled(n, dh)
    assert tiled == (dh % 4 == 0)
    assert _k3_counts() == (before[0] + 1, before[1] + tiled)
    want = ops.packed_self_attention_bwd_plain(qkv, g, h)
    assert got.dtype == dtype and got.shape == qkv.shape
    _assert_within(got, want, K3_TOL[dtype], want.float().abs().max().item())
    assert torch.equal(got, ops.packed_self_attention_bwd(qkv, g, h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", [(64, 32, 16, 64),  # the train step's
                                      (8, 30, 16, 64),   # ragged N
                                      (3, 17, 3, 24)])   # ragged sizes
def test_k3_tiled_kernel_gives_the_scalar_kernels_bits(card, b, n, h, dh,
                                                       dtype):
    """An unaligned copy of qkv takes the scalar kernel (the tiled rule
    refuses it), which must give the register-tiled kernel's bits; the
    library reports each schedule, and the profiler sees the one it names
    run."""
    qkv = _randn(card, b, n, 3 * h * dh, dtype=dtype)
    g = _randn(card, b, n, h * dh, dtype=dtype)
    fn = ops.packed_self_attention_bwd
    assert ops.self_bwd_tiled(n, dh)
    assert not ops.self_bwd_tiled(n, dh, aligned=False)
    before = _k3_counts()
    tiled = fn(qkv, g, h)
    off = _unaligned(qkv)
    old = fn(off, g, h)
    torch.cuda.synchronize()
    assert _k3_counts() == (before[0] + 2, before[1] + 1)
    assert torch.equal(tiled, old)
    assert "packed_self_attention_bwd_tiled_kernel" in _launched(
        lambda: fn(qkv, g, h))
    names = _launched(lambda: fn(off, g, h))
    assert "packed_self_attention_bwd_kernel" in names
    assert "tiled" not in names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,d,h", [(4, 32, 2048, 128, 4),   # posterior
                                       (2, 45, 3000, 96, 2),    # ragged
                                       (1, 5, 20000, 64, 1)])   # 157 chunks
def test_cross_attention_tiled_kernel(card, b, n, m, d, h, dtype):
    q = _randn(card, b, n, d, dtype=dtype)
    k = _randn(card, b, m, d, dtype=dtype)
    v = _randn(card, b, m, d, dtype=dtype)
    before = (ops.cross_attention.launches,
              ops.cross_attention.tiled_launches)
    got = ops.cross_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert (ops.cross_attention.launches,
            ops.cross_attention.tiled_launches) == (before[0] + 1,
                                                    before[1] + 1)
    _assert_within(got, ops.attention_plain(q, k, v, h), TOL[dtype])


def test_k2_takes_the_tiled_schedule_past_its_bound(card):
    """At M=512 K2 keeps a head's k and v whole at dh=32 and takes the
    long-key schedule at dh=64; both agree with the twin."""
    q = _randn(card, 2, 40, 64, dtype=torch.float32)
    k = _randn(card, 2, 512, 64, dtype=torch.float32)
    v = _randn(card, 2, 512, 64, dtype=torch.float32)
    assert ops.cross_whole_smem_bytes(512, 32) <= ops.SMEM_LIMIT
    assert ops.cross_whole_smem_bytes(512, 64) > ops.SMEM_LIMIT
    whole = ops.cross_attention(q, k, v, 2)
    tiled_before = ops.cross_attention.tiled_launches
    tiled = ops.cross_attention(q, k, v, 1)
    assert ops.cross_attention.tiled_launches == tiled_before + 1
    _assert_within(whole, ops.attention_plain(q, k, v, 2), TOL[torch.float32])
    _assert_within(tiled, ops.attention_plain(q, k, v, 1), TOL[torch.float32])


# K2's chunk and tile edges, (b, n, m, d, h): the whole-set schedule's
# 32-key register chunks (M = 31, 32, 33) and 128-row tiles (N = 129, 257)
# at dh 16, 32, 48, 64; the long-key schedule's 128-key chunks (M = 127,
# 128, 129 at dh = 96; 2047, 2048, 2049 at dh = 32, 16, 48), its 32-row
# tiles (N = 31, 33, 65), 64- and 32-key chunks (dh = 256, 400), and dh = 20
# (bf16 rows not a multiple of 16 bytes: element loads)
K2_EDGES = [(2, 129, 31, 64, 2), (2, 129, 32, 32, 2), (2, 129, 33, 96, 2),
            (2, 257, 33, 64, 1), (2, 50, 70, 60, 3),
            (1, 40, 127, 96, 1), (1, 40, 128, 96, 1), (1, 40, 129, 96, 1),
            (2, 33, 2047, 64, 2), (2, 31, 2048, 32, 2), (2, 65, 2049, 96, 2),
            (2, 32, 1000, 64, 1), (2, 50, 1500, 60, 3), (1, 20, 300, 256, 1),
            (1, 20, 100, 400, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,d,h", K2_EDGES)
def test_cross_attention_edges_repeat_their_bits(card, b, n, m, d, h, dtype):
    q = _randn(card, b, n, d, dtype=dtype)
    k = _randn(card, b, m, d, dtype=dtype)
    v = _randn(card, b, m, d, dtype=dtype)
    fn = ops.cross_attention
    before = (fn.launches, fn.tiled_launches)
    got = fn(q, k, v, h)
    torch.cuda.synchronize()
    long_key = ops.cross_schedule(n, m, d // h) == "long_key"
    assert (fn.launches, fn.tiled_launches) == (before[0] + 1,
                                                before[1] + long_key)
    _assert_within(got, ops.attention_plain(q, k, v, h), TOL[dtype])
    assert torch.equal(got, fn(q, k, v, h))  # no atomics: the same bits


@pytest.mark.parametrize("m", [32, 2048])
def test_cross_attention_takes_rows_that_are_not_16_byte_aligned(card, m):
    """Contiguous views one element into their storage take element loads
    and stores; the output is the aligned run's, bit for bit."""
    shapes = ((2, 100, 128), (2, m, 128), (2, m, 128))
    q, k, v = (_randn(card, s[0] * s[1] * s[2] + 1, dtype=torch.bfloat16)
               [1:].view(s) for s in shapes)
    assert q.data_ptr() % 16 and q.is_contiguous()
    got = ops.cross_attention(q, k, v, 4)
    want = ops.cross_attention(*(t.clone() for t in (q, k, v)), 4)
    assert torch.equal(got, want)


def test_cross_attention_refuses_a_grad_input_on_the_card(card):
    q = _randn(card, 2, 64, 128, dtype=torch.float32).requires_grad_(True)
    kv = _randn(card, 2, 32, 128, dtype=torch.float32)
    before = ops.cross_attention.launches
    with pytest.raises(RuntimeError, match="CrossAttention"):
        ops.cross_attention(q, kv, kv, 4)
    assert ops.cross_attention.launches == before
    with torch.no_grad():
        ops.cross_attention(q, kv, kv, 4)


def test_packed_self_attention_function_on_the_card(card):
    h = 4
    qkv = _randn(card, 4, 32, 3 * 256, dtype=torch.float32)
    g = _randn(card, 4, 32, 256, dtype=torch.float32)
    x = qkv.clone().requires_grad_(True)
    k1, k3 = ops.packed_self_attention.launches, _k3_counts()
    out = ops.PackedSelfAttention.apply(x, h)
    out.backward(g)
    torch.cuda.synchronize()
    assert ops.packed_self_attention.launches - k1 == 1
    assert _k3_counts() == (k3[0] + 1, k3[1] + 1)  # the tiled kernel
    _assert_within(out.detach(), ops.packed_self_attention_plain(qkv, h),
                   TOL[torch.float32])
    want = ops.packed_self_attention_bwd_plain(qkv, g, h)
    _assert_within(x.grad, want, K3_TOL[torch.float32],
                   want.abs().max().item())


def test_small_train_step_through_the_kernels(card):
    """Two stage-2 steps at a small width: K1 and K3 once per Score block,
    K2 in every Compressor attention; finite losses."""
    from ldt_torch.configs import latent_trainer_cfg
    from ldt_torch.training.latent_sde_trainer import Trainer

    cfg = latent_trainer_cfg(
        score=dict(num_blocks=2, hidden_size=64, t_dim=64, num_heads=4,
                   z_dim=40),
        compressor=dict(outsize=256, max_outputs=256, n_layers=2,
                        hidden_dim=32, p_dim=32, num_heads=2,
                        encoder_layers=1), sde=dict(sample_N=64))
    trainer = Trainer(cfg, generator=torch.Generator("cuda").manual_seed(0))
    data = {"tr_points": _randn(card, 4, 256, 3, dtype=torch.float32)}
    counts = (ops.packed_self_attention.launches,
              ops.packed_self_attention_bwd.launches,
              ops.cross_attention.launches,
              ops.packed_self_attention_bwd.tiled_launches)
    losses = torch.stack([trainer.update(data) for _ in range(2)])
    torch.cuda.synchronize()
    assert torch.isfinite(losses).all()
    # per step: 2 blocks of K1 and K3 (K3 all register-tiled); K2: 2
    # encoder blocks, 2 posteriors, 2 decoder blocks
    assert (ops.packed_self_attention.launches - counts[0],
            ops.packed_self_attention_bwd.launches - counts[1],
            ops.cross_attention.launches - counts[2],
            ops.packed_self_attention_bwd.tiled_launches - counts[3]) == (
                4, 4, 12, 4)
    clouds, _ = trainer.sample(2, 256)
    assert clouds.shape == (2, 256, 3) and torch.isfinite(clouds).all()


def _k4_counts():
    fn = ops.cross_attention_bwd
    return (fn.launches, fn.long_key_launches, fn.long_query_launches,
            fn.tiled_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,d,h", [(16, 32, 32, 128, 4),    # encoder
                                       (16, 32, 2048, 128, 4),  # posterior
                                       (16, 2048, 32, 128, 4),  # decoder
                                       (3, 45, 3000, 96, 2),    # ragged keys
                                       (2, 300, 8, 64, 2),      # 3 row tiles
                                       (2, 8, 300, 64, 2),      # 8 rows
                                       (2, 37, 70, 60, 5),      # dh = 12
                                       (2, 50, 9, 36, 3),       # dh = 12
                                       (2, 40, 50, 30, 3)])     # dh = 10
def test_cross_attention_bwd_kernel(card, b, n, m, d, h, dtype):
    """K4 against its twin under K4_TOL, repeating its bits; the counts
    follow the schedule and the tiled rule (dh = 10 takes the scalar
    kernels)."""
    q = _randn(card, b, n, d, dtype=dtype)
    k = _randn(card, b, m, d, dtype=dtype)
    v = _randn(card, b, m, d, dtype=dtype)
    g = _randn(card, b, n, d, dtype=dtype)
    fn = ops.cross_attention_bwd
    before = _k4_counts()
    got = fn(q, k, v, g, h)
    torch.cuda.synchronize()
    rows = ops.cross_bwd_schedule(n, m, d // h)
    tiled = ops.cross_bwd_tiled(n, m, d // h)
    assert tiled == (d // h % 4 == 0)
    assert _k4_counts() == (
        before[0] + 1, before[1] + (rows == 0),
        before[2] + (rows > 0 and n > rows), before[3] + tiled)
    want = ops.cross_attention_bwd_plain(q, k, v, g, h)
    for got_t, want_t, like in zip(got, want, (q, k, v)):
        assert got_t.dtype == dtype and got_t.shape == like.shape
        _assert_within(got_t, want_t, K4_TOL[dtype],
                       want_t.float().abs().max().item())
    again = fn(q, k, v, g, h)  # no atomics: the same bits every run
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,d,h", [(16, 32, 32, 128, 4),    # encoder
                                       (16, 32, 2048, 128, 4),  # posterior
                                       (16, 2048, 32, 128, 4),  # decoder
                                       (3, 45, 3000, 96, 2),    # ragged keys
                                       (2, 300, 8, 64, 2),      # 3 row tiles
                                       (2, 37, 70, 60, 5)])     # dh = 12
def test_k4_tiled_kernels_give_the_pr4_kernels_bits(card, b, n, m, d, h,
                                                    dtype):
    """Unaligned copies of q, k, v and g take the scalar kernels (the tiled
    rule refuses them), which must give the register-tiled kernels' bits;
    the library reports each schedule, and the profiler sees the one it
    names run."""
    q, k, v, g = (_randn(card, b, x, d, dtype=dtype) for x in (n, m, m, n))
    fn = ops.cross_attention_bwd
    assert not ops.cross_bwd_tiled(n, m, d // h, aligned=False)
    before = _k4_counts()
    tiled = fn(q, k, v, g, h)
    off = [_unaligned(t) for t in (q, k, v, g)]
    old = fn(*off, h)
    torch.cuda.synchronize()
    assert _k4_counts()[0] == before[0] + 2
    assert _k4_counts()[3] == before[3] + 1
    for a, c in zip(tiled, old):
        assert torch.equal(a, c)
    assert ", true>" in _launched(lambda: fn(q, k, v, g, h))
    assert ", true>" not in _launched(lambda: fn(*off, h))


def test_cross_attention_function_on_the_card(card):
    q = _randn(card, 4, 2048, 128, dtype=torch.float32)
    k = _randn(card, 4, 32, 128, dtype=torch.float32)
    v = _randn(card, 4, 32, 128, dtype=torch.float32)
    g = _randn(card, 4, 2048, 128, dtype=torch.float32)
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    k2, k4 = ops.cross_attention.launches, ops.cross_attention_bwd.launches
    out = ops.CrossAttention.apply(*x, 4)
    out.backward(g)
    torch.cuda.synchronize()
    assert (ops.cross_attention.launches - k2,
            ops.cross_attention_bwd.launches - k4) == (1, 1)
    for t, want in zip(x, ops.cross_attention_bwd_plain(q, k, v, g, 4)):
        _assert_within(t.grad, want, K4_TOL[torch.float32],
                       want.abs().max().item())


def test_small_stage1_step_through_the_kernels(card):
    """Two stage-1 steps at a small width: K2 and K4 in every attention of
    the Compressor (2 layers: 2 encoder blocks, 2 posteriors, 2 decoder
    blocks); finite losses."""
    from ldt_torch.configs import compressor_trainer_cfg
    from ldt_torch.training.compressor_trainer import Trainer

    cfg = compressor_trainer_cfg(model=dict(
        outsize=256, max_outputs=256, n_layers=2, hidden_dim=32, p_dim=32,
        num_heads=2, encoder_layers=1))
    trainer = Trainer(cfg, generator=torch.Generator("cuda").manual_seed(0))
    data = {"tr_points": _randn(card, 4, 256, 3, dtype=torch.float32)}
    counts = (ops.cross_attention.launches, ops.cross_attention_bwd.launches)
    losses = torch.stack([trainer.update(data)[0] for _ in range(2)])
    torch.cuda.synchronize()
    assert torch.isfinite(losses).all()
    assert (ops.cross_attention.launches - counts[0],
            ops.cross_attention_bwd.launches - counts[1]) == (12, 12)
    clouds = trainer.sample(2, 256)
    assert clouds.shape == (2, 256, 3) and torch.isfinite(clouds).all()


def _eval_clouds(p, n, m, seed=0):
    """Unit-radius clouds: pairs of a shape and a jittered copy or another
    shape (chip_smoke.synthetic_shapes)."""
    import numpy as np

    from chip_smoke import synthetic_shapes

    rng = np.random.default_rng(seed)
    x = synthetic_shapes(p, n, rng)
    y = synthetic_shapes(p, m, rng)
    if n == m:
        y[::2] = x[::2] + 0.01 * rng.standard_normal(x[::2].shape)
    return (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())


def _rel_within(got, want, tol):
    rel = ((got - want).abs() / want.abs()).double()
    assert rel.max().item() <= tol[0], rel.max().item()
    assert rel.mean().item() <= tol[1], rel.mean().item()


# (p, n, m) of K5: the split schedule at the eval tile and at 8 pairs, one
# pair (a cluster of 8), 132 pairs (of 2), ragged N with N != M, an N that
# no split divides; the block schedule past its rule (M % 4 != 0, M > 2048)
K5_CASES = [(64, 2048, 2048), (8, 2048, 2048), (1, 2048, 2048),
            (132, 256, 512), (3, 1000, 332), (5, 777, 2048), (3, 1000, 333),
            (2, 100, 4000)]


@pytest.mark.parametrize("p,n,m", K5_CASES)
def test_pairwise_cd_means_kernel(card, p, n, m):
    """K5 against its twin and the CPU twin under K5_TOL, repeating its
    bits, on the schedule the library's rule (`cd_schedule`, asked without
    a launch) names: the entry reports the cluster size it launched
    (chip_smoke.py's phase 18 also reads the kernel's name from
    torch.profiler); a split pair alone has the bits it has in its tile."""
    from ldt_torch.ops import _eval_kernels, chamfer

    x, y = _eval_clouds(p, n, m)
    fn = chamfer.pairwise_cd_means
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    c = _eval_kernels.cd_schedule(p, n, m, sms)
    schedule = "split" if c else "block"
    assert schedule == ("split" if m <= 2048 and m % 4 == 0 else "block")
    before = (fn.launches, fn.split_launches)
    got = fn(x, y)
    torch.cuda.synchronize()
    assert (fn.launches, fn.split_launches) == (
        before[0] + 1, before[1] + (schedule == "split"))
    assert got.shape == (p,) and got.dtype == torch.float32
    _rel_within(got, chamfer.pairwise_cd_means_plain(x, y), K5_TOL)
    _rel_within(got.cpu(), chamfer.pairwise_cd_means_plain(x.cpu(), y.cpu()),
                K5_TOL)
    assert torch.equal(got, fn(x, y))  # no order that depends on timing
    cluster = ctypes.c_int(-1)
    out = torch.empty_like(got)
    _eval_kernels.raise_on(_eval_kernels.lib().ldt_pairwise_cd_means(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), p, n, m,
        _eval_kernels.stream(x), ctypes.byref(cluster)), "pairwise_cd_means")
    assert cluster.value == c
    if schedule == "split":
        assert torch.equal(fn(x[:1], y[:1]), got[:1])


def test_k5_split_and_block_schedules_agree(card):
    """An unaligned copy of y takes the first kernel at the eval's shape;
    both hold the twin under K5_TOL (their sums run in other orders)."""
    from ldt_torch.ops import _eval_kernels, chamfer

    x, y = _eval_clouds(8, 2048, 2048)
    fn = chamfer.pairwise_cd_means
    off = _unaligned(y)
    assert _eval_kernels.cd_schedule(8, 2048, 2048, 132, aligned=False) == 0
    before = fn.split_launches
    split, block = fn(x, y), fn(x, off)
    torch.cuda.synchronize()
    assert fn.split_launches == before + 1
    twin = chamfer.pairwise_cd_means_plain(x, y)
    _rel_within(split, twin, K5_TOL)
    _rel_within(block, twin, K5_TOL)


@pytest.mark.parametrize("p,n,m", [(4, 2048, 2048),   # the eval tiles
                                   (3, 700, 300),     # ragged, multi_r = 2
                                   (2, 256, 1000),    # multi_l = 3
                                   (1, 2048, 2048),   # one pair: cluster 8
                                   (64, 1024, 1024),  # the tile: cluster 2
                                   (130, 256, 256),   # past the SMs
                                   (5, 130, 67),      # M % 4 != 0
                                   (2, 1500, 2600)])  # M > 2048: block
def test_approx_match_cost_kernels(card, p, n, m):
    """K6 and K7 against the twin, equal to each other bit for bit, and
    each repeating itself; the default route is K7 at every one of these
    shapes (`emd_route`), its bits and its count; the cluster schedule's
    first pair alone (a cluster of 8) has the bits it has in the tile."""
    from ldt_torch.ops import _eval_kernels, emd

    x, y = _eval_clouds(p, n, m)
    fn = emd.approx_match_cost
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    schedule = _eval_kernels.emd_schedule(p, n, m, False, sms)[0]
    assert schedule == ("block" if m > 2048 else "cluster")
    assert _eval_kernels.emd_route(n, m)
    before = (fn.launches, fn.otf_launches, fn.cluster_launches)
    k6 = fn(x, y, otf=False)
    k7 = fn(x, y, otf=True)
    torch.cuda.synchronize()
    assert (fn.launches, fn.otf_launches, fn.cluster_launches) == (
        before[0] + 2, before[1] + 1,
        before[2] + (2 if schedule == "cluster" else 0))
    before = (fn.launches, fn.otf_launches)
    default = fn(x, y)
    torch.cuda.synchronize()
    assert (fn.launches, fn.otf_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(default, k7)
    assert torch.equal(k6, k7)
    assert torch.equal(k6, fn(x, y, otf=False)) and torch.equal(
        k7, fn(x, y, otf=True))
    names = _launched(lambda: fn(x, y, otf=False))
    assert ("approx_match_cluster_kernel" in names) == (
        schedule == "cluster"), names
    if schedule == "cluster":
        assert torch.equal(fn(x[:1], y[:1], otf=False), k6[:1])
    _rel_within(k6, emd.approx_match_cost_plain(x, y), K6_TOL)
    _rel_within(k6.cpu(), emd.approx_match_cost_plain(x.cpu(), y.cpu()),
                K6_TOL)


def test_the_default_route_falls_back_to_k6_past_k7s_shared_memory(card):
    """At 2048 x 8192 points K7's shared memory does not fit: the default
    takes K6 behind the d build (the block schedule, M > 2048), with K6's
    bits, and a forced K7 refuses the shape."""
    from ldt_torch.ops import _eval_kernels, emd

    x, y = _eval_clouds(2, 2048, 8192)
    fn = emd.approx_match_cost
    assert not _eval_kernels.emd_route(2048, 8192)
    before = (fn.launches, fn.otf_launches)
    default = fn(x, y)
    torch.cuda.synchronize()
    assert (fn.launches, fn.otf_launches) == (before[0] + 1, before[1])
    assert torch.equal(default, fn(x, y, otf=False))
    with pytest.raises(ValueError, match="shared memory"):
        fn(x, y, otf=True)
    _rel_within(default, emd.approx_match_cost_plain(x, y), K6_TOL)


def test_compute_all_metrics_builds_its_distances_in_the_kernel(card):
    """compute_all_metrics at a 64-pair tile of 2048-point clouds (8 x 8
    sets, batch 16: one tile a matrix): every EMD launch takes K7 by the
    rule, the cluster schedule, no `emd.distances` span is entered, and the
    six matrices and the metrics equal an `emd_otf=False` run (K6 behind
    the d build) bit for bit."""
    import numpy as np

    from ldt_torch.eval import metrics
    from ldt_torch.ops import emd
    from ldt_torch.tools import profiling

    x, y = _eval_clouds(8, 2048, 2048, seed=2)
    smp, ref = x.cpu().numpy(), y.cpu().numpy()
    fn = emd.approx_match_cost
    inner = metrics.pairwise_EMD_CD
    runs = {}
    try:
        for otf in (None, False):
            mats = []

            def recorder(*a, **kw):
                out = inner(*a, **kw)
                mats.extend(out)
                return out

            metrics.pairwise_EMD_CD = recorder
            before = (fn.launches, fn.otf_launches, fn.cluster_launches)
            profiling.start()
            try:
                res = metrics.compute_all_metrics(smp, ref, 16,
                                                  verbose=False,
                                                  emd_otf=otf)
                torch.cuda.synchronize()
            finally:
                spans = profiling.stop()
            counts = tuple(a - b for a, b in zip(
                (fn.launches, fn.otf_launches, fn.cluster_launches), before))
            names = [sp.name for sp in spans]
            runs[otf] = (mats, res, counts, names.count("emd.distances"))
    finally:
        metrics.pairwise_EMD_CD = inner
    assert runs[None][2] == (3, 3, 3) and runs[None][3] == 0, runs[None][2:]
    assert runs[False][2] == (3, 0, 3) and runs[False][3] == 3, \
        runs[False][2:]
    assert len(runs[None][0]) == len(runs[False][0]) == 6
    for got, want in zip(runs[None][0], runs[False][0]):
        assert np.array_equal(got, want)
    assert runs[None][1] == runs[False][1]


def test_eval_metrics_on_the_card_match_the_cpu(card):
    """compute_all_metrics through K5 and K6 (and K7) against its CPU run:
    the matrices' tiles do not move a pair's value."""
    from ldt_torch.eval import metrics

    x, y = _eval_clouds(4, 512, 512, seed=1)
    smp, ref = x.cpu().numpy(), y.cpu().numpy()
    cd, emd = metrics.pairwise_EMD_CD(smp, ref, 2)
    cd_cpu, emd_cpu = metrics.pairwise_EMD_CD(smp, ref, 2, device="cpu")
    assert (abs(cd - cd_cpu) / cd_cpu).max() <= K5_TOL[0]
    assert (abs(emd - emd_cpu) / emd_cpu).max() <= K6_TOL[0]
    again = metrics.pairwise_EMD_CD(smp, ref, 8, block=4)
    assert (again[0] == cd).all() and (again[1] == emd).all()
    otf = metrics.pairwise_EMD_CD(smp, ref, 2, emd_otf=True)
    assert (otf[1] == emd).all()
    res = metrics.compute_all_metrics(smp, ref, 4, verbose=False)
    assert res["mmd-EMD"] > 0 and all(v == v for v in res.values())


# --- the conditional Score's cross-attention (the DiT's even blocks: 32
# latent tokens over 32 condition tokens, hidden 1024, 16 heads, dh 64) --

DIT_CROSS = (4, 32, 1024, 16)  # B, N = M, D, heads


def test_k2_and_k4_at_the_dit_cross_shape(card):
    """K2 on its whole-set schedule at its widest register width (dh 64)
    and K4 on its register-tiled long-query kernels (32 rows, one tile)
    against their twins, f32 (chip_smoke.py's phase 23a at B=4)."""
    b, n, d, h = DIT_CROSS
    q, k, v, g = (_randn(card, b, n, d, dtype=torch.float32)
                  for _ in range(4))
    assert ops.cross_schedule(n, n, d // h) == "whole"
    assert ops.whole_width(d // h) == 64
    before = (ops.cross_attention.launches,
              ops.cross_attention.tiled_launches)
    got = ops.cross_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert (ops.cross_attention.launches,
            ops.cross_attention.tiled_launches) == (before[0] + 1, before[1])
    _assert_within(got, ops.attention_plain(q, k, v, h), TOL[torch.float32])
    assert torch.equal(got, ops.cross_attention(q, k, v, h))
    assert ops.cross_bwd_schedule(n, n, d // h) == n
    assert ops.cross_bwd_tiled(n, n, d // h)
    before = _k4_counts()
    got = ops.cross_attention_bwd(q, k, v, g, h)
    torch.cuda.synchronize()
    assert _k4_counts() == (before[0] + 1, before[1], before[2],
                            before[3] + 1)
    want = ops.cross_attention_bwd_plain(q, k, v, g, h)
    for got_t, want_t in zip(got, want):
        _assert_within(got_t, want_t, K4_TOL[torch.float32],
                       want_t.abs().max().item())


def test_the_resnet_trunk_runs_at_ieee_f32(card):
    """cuDNN's global TF32 switch on (the library's default), the
    ConditionNet's trunk still convolves at IEEE f32 inside its own scope:
    forward and gradients on the card against the CPU (f32): the output
    within 1e-5 of its largest |value|, each gradient within 1e-4 of its
    (chip_smoke.py's TRAIN_STEP_TOL; TF32's 10-bit mantissa misses both by
    far), and each convolution sees TF32 off."""
    from ldt_torch.models.score import ResNet18Trunk
    from ldt_torch.nn import layers

    seen = []
    real = layers.F.conv2d

    def spy(*a, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*a, **kw)

    cpu = ResNet18Trunk()
    layers.init_weights_(cpu, torch.Generator().manual_seed(0))
    dev = ResNet18Trunk(device="cuda")
    dev.load_state_dict(cpu.state_dict())
    x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    r = torch.randn(4, 8, 8, 128, generator=torch.Generator().manual_seed(2))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with mock.patch.object(layers.F, "conv2d", spy):
            out = dev(x.cuda(), train=True)
            (out * r.cuda()).mean().backward()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert seen and not any(seen)
    want = cpu(x, train=True)
    (want * r).mean().backward()
    scale = want.abs().max().item()
    assert (out.cpu() - want).abs().max().item() <= 1e-5 * scale
    for (name, p), q in zip(dev.named_parameters(), cpu.parameters()):
        err = (p.grad.cpu() - q.grad).abs().max().item()
        assert err <= 1e-4 * q.grad.abs().max().item() + 1e-9, (name, err)
