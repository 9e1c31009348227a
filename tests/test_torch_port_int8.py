"""ldt_torch int8 serving (W8A8, kernel K8) vs ldt_tpu/serving/int8.py.

The same numpy inputs go through both packages on the CPU. The JAX side
runs its Pallas attention in interpret mode with the module flags that
tests/test_pallas_attention.py sets (`_PHASED`, `_ELEMS=4`, `_INT8_ATTN`);
the torch side runs the plain twins, which the wrappers use for CPU tensors.
Bit for bit where the arithmetic is the same (weight codes and scales,
`int8_matmul` in every mode, K8's twin); elsewhere within a stated
tolerance that a wrong variant exceeds.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.ops.pallas_attention as pa
import ldt_tpu.serving.int8 as jint8
from ldt_tpu.models import Score as JaxScore
from ldt_torch.ops import attention as ops
from ldt_torch.serving import int8 as tint8
from ldt_torch.weights import score_state_dict
from test_torch_port_common import DTYPES, SMALL_SCORE, cfgs, params_np, to_np

# tests/test_int8_serving.py::TestDenoiseInt8 widths: dh = 16
INT8_SCORE = dict(SMALL_SCORE, z_dim=16, hidden_size=64, t_dim=32)
B = 8
# denoise_with_mods_int8, (max, mean) of |torch - jax| relative to the
# largest |jax|: bit for bit through K1; through K8 a w8 code that exp or
# the row sum rounds to its neighbour moves one head's output slice, and
# the bf16 ulps it leaves spread through the later blocks. Over steps 0-3
# and inputs from seeds 0-2 the right mean read 0-1.1e-4 (max <= 4.4e-3);
# with K8's scales per batch element instead of per group of 4 it read
# 6.9e-4-9.0e-4 (max 3.9e-3-7.8e-3): the mean tells them apart.
DENOISE_TOL = (6e-3, 2.5e-4)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture
def pallas_int8(monkeypatch):
    """The JAX package's K8 dispatch as its own tests set it."""
    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", True)


# --- weights and the int8 GEMM ---------------------------------------------

@pytest.mark.parametrize("seed,k,n", [(0, 64, 96), (1, 256, 32), (2, 40, 24)])
def test_quantize_weight_bit_for_bit(seed, k, n):
    w = _rand((k, n), seed, 0.2)
    w[:, 3] = 0.0  # an all-zero channel: the 1e-12 floor of the scale
    jw, js = jint8.quantize_weight(jnp.asarray(w))
    tw, ts = tint8.quantize_weight(torch.from_numpy(w.T.copy()))
    assert tw.dtype == torch.int8 and tw.shape == (n, k) and tw.is_contiguous()
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["dynamic", "static", "passthrough"])
def test_int8_matmul_bit_for_bit(mode, x_dtype, out_dtype):
    (jx_d, tx_d), (jo_d, to_d) = DTYPES[x_dtype], DTYPES[out_dtype]
    x = _rand((4, 8, 64), 3, 3.0)
    w = _rand((64, 48), 4, 0.1)
    jx, tx = jnp.asarray(x, jx_d), torch.from_numpy(x).to(tx_d)
    if mode == "passthrough":
        jw, js = jnp.asarray(w, jnp.bfloat16), None
        tw, ts = torch.from_numpy(w.T.copy()).bfloat16(), None
    else:
        jw, js = jint8.quantize_weight(jnp.asarray(w))
        tw, ts = tint8.quantize_weight(torch.from_numpy(w.T.copy()))
    xs = np.float32(0.05)  # static: clips the largest activations
    jkw = dict(x_scale=jnp.asarray(xs)) if mode == "static" else {}
    tkw = dict(x_scale=torch.tensor(xs)) if mode == "static" else {}
    jrec, trec = [], []
    want = jint8.int8_matmul(jx, jw, js, out_dtype=jo_d, record=jrec, **jkw)
    got = tint8.int8_matmul(tx, tw, ts, out_dtype=to_d, record=trec, **tkw)
    assert got.dtype == to_d and got.shape == (4, 8, 48)
    np.testing.assert_array_equal(to_np(got), to_np(want))
    assert len(trec) == len(jrec) == 1 and trec[0].dim() == 0
    np.testing.assert_array_equal(to_np(trec[0]), to_np(jrec[0]))


def test_int8_matmul_static_scale_must_be_a_tensor():
    w, s = tint8.quantize_weight(torch.ones(8, 16))
    with pytest.raises(TypeError, match="tensor"):
        tint8.int8_matmul(torch.ones(2, 16), w, s, x_scale=0.1)


@functools.lru_cache(maxsize=None)
def _score():
    """JAX Score params and bf16 modulations of a 4-step schedule, built
    once per module."""
    jcfg, _ = cfgs(INT8_SCORE)
    v = jax.jit(JaxScore(jcfg).init)(
        jax.random.key(1), jnp.zeros((2, jcfg.z_scale, jcfg.z_dim)),
        jnp.ones((2,)))
    mods = JaxScore(jcfg, dtype=jnp.bfloat16).apply(
        v, jnp.linspace(1.0, 1e-6, 4), method=JaxScore.precompute_mods)
    return params_np(v), jax.tree_util.tree_map(np.asarray, mods)


@functools.lru_cache(maxsize=None)
def _both_quantized(tail=0):
    """Both packages' quantized weights, once per module and tail (the
    tests only read them)."""
    p, _ = _score()
    n = INT8_SCORE["num_blocks"]
    return (jint8.quantize_score_params(p, n, bf16_tail=tail),
            tint8.quantize_score_params(score_state_dict(p), n, tail))


@pytest.mark.parametrize("tail", [0, 2, 3])
def test_quantize_score_params_bit_for_bit(tail):
    jq, tq = _both_quantized(tail)
    n = INT8_SCORE["num_blocks"]
    for i, (jb, tb) in enumerate(zip(jq["blocks"], tq["blocks"])):
        assert set(jb) == set(tb)
        for short in ("qkv", "o", "up", "dn"):
            keep = i >= n - tail
            assert (tb[f"{short}_s"] is None) == keep
            assert tb[f"{short}_w"].dtype == (torch.bfloat16 if keep
                                              else torch.int8)
            np.testing.assert_array_equal(to_np(tb[f"{short}_w"]),
                                          to_np(jb[f"{short}_w"]).T)
            if not keep:
                np.testing.assert_array_equal(to_np(tb[f"{short}_s"]),
                                              to_np(jb[f"{short}_s"]))
            np.testing.assert_array_equal(to_np(tb[f"{short}_b"]),
                                          to_np(jb[f"{short}_b"]))
    for key in ("ln_in_w", "ln_out_w"):
        np.testing.assert_array_equal(to_np(tq[key]), to_np(jq[key]).T)
    for key in ("ln_in_b", "ln_out_b"):
        np.testing.assert_array_equal(to_np(tq[key]), to_np(jq[key]))


def test_quantize_score_params_takes_an_f32_score_and_refuses_bf16():
    from ldt_torch.models import Score
    from ldt_torch.weights import load_score

    p, _ = _score()
    _, tcfg = cfgs(INT8_SCORE)
    n = tcfg.num_blocks
    from_sd = tint8.quantize_score_params(score_state_dict(p), n)
    from_module = tint8.quantize_score_params(
        load_score(Score(tcfg, device="cpu"), p), n)
    assert torch.equal(from_module["blocks"][1]["up_w"],
                       from_sd["blocks"][1]["up_w"])
    bf16 = load_score(Score(tcfg, dtype=torch.bfloat16, device="cpu"), p)
    with pytest.raises(ValueError, match="f32"):
        tint8.quantize_score_params(bf16, n)


# --- K8 ---------------------------------------------------------------------

def _flipped_rows(got, want, b, n, h):
    """(b, row, head) output slices that differ: a w8 code flipped there."""
    diff = np.abs(to_np(got) - to_np(want)).reshape(b, n, h, -1)
    return int((diff.max(axis=-1) > 0).sum()), float(diff.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_k8_twin_matches_pallas_int8(seed, dtype, pallas_int8):
    """Bit for bit but for rare w8 codes one step apart (exp and the row
    sum round differently), each moving one (element, row, head) slice by
    at most one v code step, max|v| / 127, plus an output ulp; seed 1 in
    bf16 shows two. Per-element scales (E=1) move almost every slice."""
    jd, td = DTYPES[dtype]
    b, n, h, dh = 8, 32, 16, 64
    qkv = _rand((b, n, 3 * h * dh), seed)
    want = pa._fwd_call_packed(jnp.asarray(qkv, jd), h, True)
    t = torch.from_numpy(qkv).to(td)
    got = ops.packed_self_attention_int8(t, h)
    assert got.dtype == td and got.shape == (b, n, h * dh)
    flips, err = _flipped_rows(got, want, b, n, h)
    step = np.abs(to_np(t)[..., 2 * h * dh:]).max() / 127
    ulp = np.abs(to_np(want)).max() * (2.0 ** -7 if dtype == "bfloat16"
                                       else 2.0 ** -23)
    assert flips <= 4 and err <= step + ulp, (flips, err, step)
    wrong, _ = _flipped_rows(ops.packed_self_attention_int8_plain(t, h, 1),
                             want, b, n, h)
    assert wrong > 0.5 * b * n * h, wrong


def test_int8_dispatch_takes_k1_when_batch_is_not_a_multiple(pallas_int8):
    """B=3: the JAX package runs its one-element phased K1 kernel, the port
    K1, with int8 attention on (`_fwd_call_packed`'s dispatch)."""
    b, n, h, dh = 3, 8, 4, 16
    qkv = _rand((b, n, 3 * h * dh), 5)
    want = pa._fwd_call_packed(jnp.asarray(qkv, jnp.bfloat16), h, True)
    with mock.patch.object(ops, "packed_self_attention_int8",
                           side_effect=AssertionError("K8 at B=3")):
        got = tint8.self_attention(torch.from_numpy(qkv).bfloat16(), h,
                                   attn_int8=True)
    assert torch.equal(got, ops.packed_self_attention_plain(
        torch.from_numpy(qkv).bfloat16(), h))
    err = np.abs(to_np(got) - to_np(want)).max()
    assert err <= 1e-2 * np.abs(to_np(want)).max(), err


def test_k8_cpu_tensors_take_the_twin_and_count_no_launch():
    qkv = torch.from_numpy(_rand((4, 8, 48), 6))
    before = ops.packed_self_attention_int8.launches
    assert torch.equal(ops.packed_self_attention_int8(qkv, 2),
                       ops.packed_self_attention_int8_plain(qkv, 2))
    assert ops.packed_self_attention_int8.launches == before


def _bad_k8_inputs():
    ok = torch.zeros(4, 8, 48)
    return {
        "float16": (TypeError, ok.half(), 2, 4),
        "batch_not_a_multiple": (ValueError, torch.zeros(3, 8, 48), 2, 4),
        "elems_zero": (ValueError, ok, 2, 0),
        "heads_do_not_divide": (ValueError, ok, 5, 4),
        "not_3xD": (ValueError, torch.zeros(4, 8, 47), 1, 4),
        "non_contiguous": (ValueError, torch.zeros(4, 48, 8).transpose(1, 2),
                           2, 4),
        "beyond_shared_memory": (ValueError, torch.zeros(4, 512, 3 * 64), 1,
                                 4),
    }


@pytest.mark.parametrize("case", list(_bad_k8_inputs()))
def test_k8_rejects(case):
    exc, x, h, elems = _bad_k8_inputs()[case]
    with pytest.raises(exc):
        ops.packed_self_attention_int8(x, h, elems)


# --- one denoise step, calibration, the slice ------------------------------

def _step_inputs(step, seed=0):
    _, mods = _score()
    jm = {k: jnp.asarray(v[step], jnp.bfloat16) for k, v in mods.items()}
    tm = {k: torch.from_numpy(np.asarray(v[step], np.float32)).bfloat16()
          for k, v in mods.items()}
    return jm, tm, _rand((B, INT8_SCORE["z_scale"], INT8_SCORE["z_dim"]), seed)


def _rel_errs(got, want):
    want = to_np(want)
    d = np.abs(to_np(got) - want)
    scale = np.abs(want).max()
    return d.max() / scale, d.mean() / scale


def _within(r, tol):
    return r[0] <= tol[0] and r[1] <= tol[1]


def _k8_per_element():
    return mock.patch.object(
        ops, "packed_self_attention_int8",
        lambda qkv, h, elems=4: ops.packed_self_attention_int8_plain(qkv, h,
                                                                     1))


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("attn_int8", [False, True])
def test_denoise_with_mods_int8_matches_jax(attn_int8, step, monkeypatch):
    """Both sides take JAX's bf16 modulations (PR 1's precompute is held by
    tests/test_torch_port_score.py)."""
    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", attn_int8)
    jq, tq = _both_quantized()
    jm, tm, x = _step_inputs(step)
    h = INT8_SCORE["num_heads"]
    want = jint8.denoise_with_mods_int8(jnp.asarray(x), jm, jq, h,
                                        interpret=True)
    got = tint8.denoise_with_mods_int8(torch.from_numpy(x), tm, tq, h,
                                       attn_int8=attn_int8)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    r = _rel_errs(got, want)
    assert _within(r, DENOISE_TOL), r
    if not attn_int8:
        np.testing.assert_array_equal(to_np(got), to_np(want))
    else:
        with _k8_per_element():
            wrong = tint8.denoise_with_mods_int8(
                torch.from_numpy(x), tm, tq, h, attn_int8=True)
        r = _rel_errs(wrong, want)
        assert not _within(r, DENOISE_TOL), r


def test_denoise_static_scales_bf16_tail_and_record_match_jax(pallas_int8):
    """bf16_tail=1 with static scales recorded by the JAX side from the same
    input: the recorded amaxes agree (passthrough sites record 0) and the
    static step agrees with JAX's."""
    jq, tq = _both_quantized(tail=1)
    jm, tm, x = _step_inputs(2, seed=1)
    h, nb = INT8_SCORE["num_heads"], INT8_SCORE["num_blocks"]
    jrec, trec = [], []
    jint8.denoise_with_mods_int8(jnp.asarray(x), jm, jq, h, interpret=True,
                                 record=jrec)
    tint8.denoise_with_mods_int8(torch.from_numpy(x), tm, tq, h,
                                 attn_int8=True, record=trec)
    assert len(trec) == len(jrec) == nb * 4
    jrec, trec = to_np(jnp.stack(jrec)), to_np(torch.stack(trec))
    assert (trec[-4:] == 0).all() and (jrec[-4:] == 0).all()
    np.testing.assert_allclose(trec, jrec, rtol=1e-2)
    scales = np.maximum(jrec.reshape(nb, 4), 1e-12) / 127.0
    want = jint8.denoise_with_mods_int8(jnp.asarray(x), jm, jq, h,
                                        interpret=True,
                                        act_scales=jnp.asarray(scales))
    got = tint8.denoise_with_mods_int8(torch.from_numpy(x), tm, tq, h,
                                       attn_int8=True,
                                       act_scales=torch.from_numpy(scales))
    r = _rel_errs(got, want)
    assert _within(r, DENOISE_TOL), r


N_CAL, B_CAL = 6, 4
# calibrate_act_scales over N_CAL=6 steps (beta_end 3.0 keeps
# beta_end / N < 1), JAX's draws pinned: the scales are bf16 activation
# amaxes / 127, one or two bf16 ulps apart (read up to 1.1% over seeds
# 0-2); the trajectory, |x| ~ 80 at the end, read (max, mean) up to
# (6.7e-3, 1.5e-3) of its largest |value|. With the step noise in reverse
# order it read above 0.65 / 0.12.
CAL_SCALES_RTOL = 2e-2
CAL_TOL = (2e-2, 5e-3)


def _cal_sdes():
    from ldt_tpu.diffusion import DiffusionVPSDE as JaxVPSDE
    from ldt_torch.diffusion import make_diffusion
    from test_torch_port_common import SDE

    jc, tc = cfgs(dict(SDE, beta_end=3.0, train_N=N_CAL, sample_N=N_CAL))
    return JaxVPSDE(jc), make_diffusion(tc, device="cpu")


def test_calibrate_act_scales_matches_jax(monkeypatch):
    from test_torch_port_diffusion import _jax_draws

    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", False)
    jsde, tsde = _cal_sdes()
    jcfg, _ = cfgs(INT8_SCORE)
    p, _ = _score()
    mods = JaxScore(jcfg, dtype=jnp.bfloat16).apply(
        {"params": p}, jnp.linspace(1.0, 1e-6, N_CAL),
        method=JaxScore.precompute_mods)
    tmods = {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
             for k, v in mods.items()}
    jq, tq = _both_quantized()
    shape, h = (jcfg.z_scale, jcfg.z_dim), jcfg.num_heads
    rng = jax.random.key(0)
    want_s, want_x = jint8.calibrate_act_scales(
        jsde, mods, jq, h, rng, B_CAL, shape, N_CAL, interpret=True)
    x0, noise = _jax_draws(rng, N_CAL, (B_CAL,) + shape)

    def run(noise):
        return tint8.calibrate_act_scales(
            tsde, tmods, tq, h, B_CAL, shape, N_CAL, device="cpu",
            x0=torch.tensor(x0), noise=torch.tensor(noise))

    got_s, got_x = run(noise)
    assert got_s.shape == (N_CAL, jcfg.num_blocks, 4)
    assert got_s.dtype == torch.float32 and bool((got_s > 0).all())
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=CAL_SCALES_RTOL)
    r = _rel_errs(got_x, want_x)
    assert _within(r, CAL_TOL), r
    _, wrong_x = run(noise[::-1].copy())
    r = _rel_errs(wrong_x, want_x)
    assert not _within(r, CAL_TOL), r


# --- act-scale tables and gate stamps: one format for both packages --------

def _ckpt(tmp_path, name="checkpt_4.msgpack", data=b"checkpoint-bytes"):
    path = tmp_path / name
    path.write_bytes(data * 100)
    return str(path)


def _scales(n=8, nb=3, seed=0):
    return np.abs(_rand((n, nb, 4), seed)) + 0.01


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_act_scales_cross_between_packages(writer, tmp_path, monkeypatch):
    monkeypatch.delenv("LDT_INT8_STATIC_FILE", raising=False)
    monkeypatch.setenv("LDT_INT8_BF16_TAIL", "2")
    ckpt, s = _ckpt(tmp_path), _scales()
    if writer == "jax":
        path = jint8.save_act_scales(ckpt, s, predictor="ancestral")
    else:
        path = tint8.save_act_scales(ckpt, torch.from_numpy(s), bf16_tail=2,
                                     predictor="ancestral")
    assert path == tint8.act_scales_path(ckpt) == jint8.act_scales_path(ckpt)
    got = tint8.load_act_scales(ckpt, 8, 3, bf16_tail=2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), s)
    np.testing.assert_array_equal(np.asarray(jint8.load_act_scales(ckpt, 8,
                                                                   3)), s)


def _sde_cfg(predictor="ancestral", corrector=None, sample_N=1000):
    from ldt_torch.configs import dict2namespace

    return dict2namespace(dict(sde=dict(
        sample_N=sample_N, predictor=predictor, corrector=corrector,
        sample_mode="discrete", sde_type="vpsde")))


def test_load_act_scales_refusals(tmp_path):
    """Each refusal of the JAX package's loader, with its message."""
    ckpt = _ckpt(tmp_path)
    with pytest.raises(RuntimeError, match="int8-static"):
        tint8.load_act_scales(None, 8, 3)
    with pytest.raises(RuntimeError, match="no calibration file"):
        tint8.load_act_scales(ckpt, 8, 3)
    tint8.save_act_scales(ckpt, _scales(n=4))
    with pytest.raises(RuntimeError, match="shape"):
        tint8.load_act_scales(ckpt, 8, 3)
    tint8.save_act_scales(ckpt, _scales())
    assert tint8.load_act_scales(ckpt, 8, 3).shape == (8, 3, 4)
    with open(ckpt, "ab") as f:
        f.write(b"drift")
    with pytest.raises(RuntimeError, match="not bound to this"):
        tint8.load_act_scales(ckpt, 8, 3)
    np.savez(tint8.act_scales_path(ckpt), scales=_scales())  # no meta
    with pytest.raises(RuntimeError, match="not bound to this"):
        tint8.load_act_scales(ckpt, 8, 3)
    tint8.save_act_scales(ckpt, _scales())
    with pytest.raises(RuntimeError, match="bf16_tail"):
        tint8.load_act_scales(ckpt, 8, 3, bf16_tail=2)
    with pytest.raises(RuntimeError, match="ancestral-only"):
        tint8.load_act_scales(ckpt, 8, 3, _sde_cfg("ddim"))
    assert tint8.load_act_scales(ckpt, 8, 3, _sde_cfg()) is not None
    with pytest.raises(RuntimeError, match="corrector"):
        tint8.load_act_scales(ckpt, 8, 3, _sde_cfg(corrector="langevin"))
    with open(tint8.act_scales_path(ckpt), "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(RuntimeError, match="unreadable"):
        tint8.load_act_scales(ckpt, 8, 3)
    other = str(tmp_path / "other.npz")
    np.savez(other, scales=np.full((8, 3, 4), 2.0, np.float32))
    got = tint8.load_act_scales(ckpt, 8, 3, static_file=other)
    assert float(got[0, 0, 0]) == 2.0


KNOBS = [dict(), dict(attn_int8=True), dict(bf16_tail=4),
         dict(static_act=True), dict(attn_int8=True, bf16_tail=2,
                                     static_act=True)]


def _knob_env(monkeypatch, knobs):
    for var in ("LDT_ATTN_INT8", "LDT_INT8_BF16_TAIL", "LDT_INT8_STATIC"):
        monkeypatch.delenv(var, raising=False)
    if knobs.get("attn_int8"):
        monkeypatch.setenv("LDT_ATTN_INT8", "1")
    if knobs.get("bf16_tail"):
        monkeypatch.setenv("LDT_INT8_BF16_TAIL", str(knobs["bf16_tail"]))
    if knobs.get("static_act"):
        monkeypatch.setenv("LDT_INT8_STATIC", "1")


@pytest.mark.parametrize("completion", [False, True])
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(k) or "none")
def test_sampler_signature_matches_the_env_knobs(knobs, completion,
                                                 monkeypatch):
    _knob_env(monkeypatch, knobs)
    cfg = _sde_cfg("ddim", sample_N=50)
    assert tint8._sampler_signature(cfg, completion, **knobs) == \
        jint8._sampler_signature(cfg, completion)


@pytest.mark.parametrize("knobs", KNOBS[:3], ids=lambda k: "-".join(k)
                         or "none")
def test_gate_stamps_cross_between_packages(knobs, tmp_path, monkeypatch,
                                            capsys):
    _knob_env(monkeypatch, knobs)
    cfg = _sde_cfg()
    ckpt = _ckpt(tmp_path)
    jint8.write_gate_stamp(ckpt, cfg, False, passed=True, results={},
                           threshold=0.01)
    assert tint8.verify_gate_stamp(ckpt, cfg, False, **knobs) is None
    assert "different sampler" in tint8.verify_gate_stamp(
        ckpt, cfg, False, bf16_tail=7)
    ckpt2 = _ckpt(tmp_path, "checkpt_5.msgpack", b"other")
    tint8.write_gate_stamp(ckpt2, cfg, False, passed=True, results={"a": 1},
                           threshold=0.01, **knobs)
    assert jint8.verify_gate_stamp(ckpt2, cfg, False) is None
    assert tint8._load_stamp_entries(tint8.gate_stamp_path(ckpt2)) == \
        jint8._load_stamp_entries(jint8.gate_stamp_path(ckpt2))
    assert "WARNING" in capsys.readouterr().out


def test_verify_gate_stamp_problems(tmp_path, capsys):
    cfg = _sde_cfg()
    ckpt = _ckpt(tmp_path)
    assert "unknown origin" in tint8.verify_gate_stamp(None, cfg, False)
    assert "no int8 golden-gate stamp" in tint8.verify_gate_stamp(
        ckpt, cfg, False)
    assert "WARNING" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="int8-gate"):
        tint8.verify_gate_stamp(ckpt, cfg, False, strict=True)
    tint8.write_gate_stamp(ckpt, cfg, False, passed=False, results={},
                           threshold=0.01)
    assert "FAILED" in tint8.verify_gate_stamp(ckpt, cfg, False)
    ddim = _sde_cfg("ddim", sample_N=50)
    tint8.write_gate_stamp(ckpt, ddim, False, passed=True, results={},
                           threshold=0.01)
    assert tint8.verify_gate_stamp(ckpt, ddim, False) is None
    assert "FAILED" in tint8.verify_gate_stamp(ckpt, cfg, False)
    with open(ckpt, "ab") as f:
        f.write(b"x")
    assert "changed since" in tint8.verify_gate_stamp(ckpt, ddim, False)
    with open(tint8.gate_stamp_path(ckpt), "w") as f:
        f.write('{"entries": [{"passed": tru')
    assert "unreadable" in tint8.verify_gate_stamp(ckpt, ddim, False)


@pytest.mark.parametrize("size", [100, 6 * 1024 * 1024, 9 * 1024 * 1024])
def test_ckpt_fingerprint_matches_jax(size, tmp_path):
    path = tmp_path / "c.msgpack"
    path.write_bytes(np.random.default_rng(size).bytes(size))
    assert tint8._ckpt_fingerprint(str(path)) == \
        jint8._ckpt_fingerprint(str(path))


@pytest.mark.parametrize("case", [
    dict(), dict(serve=False), dict(label=1), dict(condition={}),
    dict(unet=True), dict(AdaLN=False), dict(norm="group_norm"),
    dict(sample_mode="continuous"), dict(predictor="pndm"),
    dict(predictor="ddim")], ids=lambda c: "-".join(map(str, c)) or "on")
def test_int8_serving_active_matches_jax(case, monkeypatch):
    from ldt_torch.configs import dict2namespace

    serve = case.get("serve", True)
    monkeypatch.setenv("LDT_SERVE_INT8", "1" if serve else "0")
    cfg = dict2namespace(dict(
        score=dict(norm=case.get("norm", "layer_norm"),
                   unet=case.get("unet", False),
                   AdaLN=case.get("AdaLN", True)),
        sde=dict(predictor=case.get("predictor", "ancestral"))))
    args = (cfg, case.get("sample_mode", "discrete"), case.get("label"),
            case.get("condition"))
    assert tint8.int8_serving_active(*args, serve_int8=serve) == \
        jint8.int8_serving_active(*args)


# --- the slice: int8 generation against bench.py's int8 pipeline ----------

@functools.lru_cache(maxsize=None)
def _jax_int8_generate(seed, attn_int8):
    """bench.py::generate with LDT_BENCH_INT8=1 at a small size: bf16
    modulations, weights quantized from the f32 params, W8A8 steps (K8 in
    interpret mode with `attn_int8`), then the bf16 decoder."""
    from ldt_tpu.diffusion import DiffusionVPSDE as JaxVPSDE
    from ldt_tpu.diffusion.sampling import sample_discrete as jax_sample
    from ldt_tpu.models import Compressor as JaxCompressor
    from test_torch_port_common import SDE, SMALL_COMPRESSOR
    from test_torch_port_generate import B as GB, POINTS, STEPS, _params

    jscfg, _ = cfgs(SMALL_SCORE)
    sp, cp = _params()
    score = JaxScore(jscfg, dtype=jnp.bfloat16, fused_attention=True)
    comp = JaxCompressor(cfgs(SMALL_COMPRESSOR)[0], dtype=jnp.bfloat16,
                         fused_attention=True)
    sde = JaxVPSDE(cfgs(dict(SDE, sample_N=STEPS))[0])

    @jax.jit
    def run(rng):
        mods = score.apply({"params": sp}, jnp.linspace(1.0, 1e-6, STEPS),
                           method=JaxScore.precompute_mods)
        q = jint8.quantize_score_params(sp, jscfg.num_blocks)

        def score_fn(t, x, step):
            m = jax.tree_util.tree_map(lambda a: a[step], mods)
            p = jint8.denoise_with_mods_int8(x, m, q, jscfg.num_heads,
                                             interpret=True)
            return -p.astype(jnp.float32) / sde.std(t)[:, None, None], p

        eps = jax_sample(sde, score_fn, rng, GB,
                         (jscfg.z_scale, jscfg.z_dim), N=STEPS,
                         predictor="ancestral", time_eps=1e-6, denoise=True)
        return comp.apply({"params": cp}, (GB, POINTS), eps,
                          method=JaxCompressor.sample)

    with mock.patch.object(pa, "_PHASED", True), \
            mock.patch.object(pa, "_ELEMS", 4), \
            mock.patch.object(pa, "_INT8_ATTN", attn_int8):
        return to_np(run(jax.random.key(seed)))


# The int8 run is as chaotic as PR 1's bf16 one (a rounding difference
# in one step moves the rest of the trajectory), so it is held to an
# envelope around JAX's f32 run: rms(torch_int8 - jax_f32) <=
# INT8_RMS_FACTOR * rms(jax_int8 - jax_f32), the JAX int8 run taking the
# same draws. Over seeds 1-3 and 11 the ratio read 0.64-1.99 (K1 and K8).
INT8_RMS_FACTOR = 3.0


@pytest.mark.parametrize("attn_int8", [False, True])
def test_int8_generate_matches_jax_with_its_draws(attn_int8):
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import generate
    from ldt_torch.models import Compressor, Score
    from ldt_torch.weights import load_compressor_decoder, load_score
    from test_torch_port_common import SDE, SMALL_COMPRESSOR
    from test_torch_port_diffusion import _jax_draws
    from test_torch_port_generate import (
        B as GB,
        SEED,
        STEPS,
        _jax_generate,
        _params,
    )

    _, tscfg = cfgs(SMALL_SCORE)
    sp, cp = _params()
    score = load_score(Score(tscfg, dtype=torch.bfloat16, device="cpu"), sp)
    comp = Compressor(cfgs(SMALL_COMPRESSOR)[1], dtype=torch.bfloat16,
                      device="cpu")
    load_compressor_decoder(comp, cp)
    sde = make_diffusion(cfgs(dict(SDE, sample_N=STEPS))[1], device="cpu")
    x0, noise = _jax_draws(jax.random.key(SEED), STEPS,
                           (GB, tscfg.z_scale, tscfg.z_dim))
    got = generate(score, comp, sde, GB, STEPS, device="cpu", int8=True,
                   int8_weights=score_state_dict(sp), attn_int8=attn_int8,
                   x0=torch.tensor(x0), noise=torch.tensor(noise))
    got = to_np(got)
    assert got.shape == (GB, SMALL_COMPRESSOR["outsize"], 3)
    assert np.isfinite(got).all()
    ref = _jax_generate("float32")

    def rms(a):
        return float(np.sqrt(np.mean((a - ref) ** 2)))

    jax_int8 = _jax_int8_generate(SEED, attn_int8)
    assert rms(got) <= INT8_RMS_FACTOR * rms(jax_int8), (rms(got),
                                                         rms(jax_int8))
