"""The conditional int8 serving twin, ldt_torch against ldt_tpu on the CPU:
`quantize_cond_score_params` (bit for bit from bridged weights),
`precompute_cond_kv`, `denoise_cond_int8` at several steps with the int8
attention core off and on, `int8_cond_serving_active` over a grid of
cases, and `sample_latents(int8=True, condition=...)`: what it computes and
what it refuses.

The JAX side runs its Pallas attention in interpret mode with the module
flags that tests/test_pallas_attention.py sets (`_PHASED`, `_ELEMS=4`,
`_INT8_ATTN`), the torch side the plain twins (the wrappers' CPU path).
Both take the same inputs: JAX's conditional Score (init moved off by
`perturbed`, through `ldt_torch.weights`), its encoded condition and its
time embeddings. Tolerances are stated at each test.
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
from test_torch_port_common import cfgs, perturbed, to_np
from test_torch_port_int8 import (
    B,
    INT8_SCORE,
    _k8_per_element,
    _rand,
    _rel_errs,
    _within,
)

# 3 blocks: cross, self, cross (dh 16, as the unconditional twin's tests)
COND_SCORE = dict(INT8_SCORE, condition=True)
IMG, POINTS, STEPS = 16, 64, 4
# denoise_cond_int8, (max, mean) of |torch - jax| over the largest |jax|.
# Mostly bit for bit, through K1 and K8 alike, but the f32 LayerNorm's mean
# sums in another order on the two sides: now and then one element rounds
# to the neighbouring bf16 value, an int8 activation code downstream flips,
# and its step spreads through the later blocks. Over steps 0-3 and inputs
# from seeds 10-14 the right twin read (0, 0) in 35 of 40 cases and at most
# (1.5e-2, 4.4e-4) (DENOISE_TOL, the unconditional twin's, read on one input
# that met no such tie, is exceeded there); with K8's scales per batch
# element it read (1.4e-2-2.4e-2, 3.1e-3-3.8e-3), with k and v swapped in K2
# above (0.84, 0.30): the mean tells them apart.
COND_DENOISE_TOL = (3e-2, 1e-3)


@pytest.fixture(autouse=True)
def one_thread():
    """The small models on one intra-op thread (the other test workers are
    busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _condition(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return {"img": rng.uniform(0, 1, (b, IMG, IMG, 3)).astype(np.float32),
            "pts": _rand((b, POINTS, 3), seed + 1, 0.5)}


@functools.lru_cache(maxsize=None)
def _score():
    """JAX conditional Score variables (numpy, moved off the init), its
    encoded condition (tokens, image embedding) and the time embeddings of
    a STEPS-step schedule, all f32."""
    jcfg, _ = cfgs(COND_SCORE)
    model = JaxScore(jcfg)
    cond = {k: jnp.asarray(v) for k, v in _condition().items()}
    v = jax.jit(model.init)(
        jax.random.key(2), jnp.zeros((B, jcfg.z_scale, jcfg.z_dim)),
        jnp.ones((B,)), None, cond)
    v = perturbed(jax.tree_util.tree_map(np.asarray, v))
    tokens, img = model.apply(v, cond, method=JaxScore.encode_condition)
    t_embs = model.apply(v, jnp.linspace(1.0, 1e-6, STEPS),
                         method=JaxScore.embed_times)
    return v, np.asarray(tokens), np.asarray(img), np.asarray(t_embs)


@functools.lru_cache(maxsize=None)
def _both_quantized():
    v, tokens, _, _ = _score()
    n = COND_SCORE["num_blocks"]
    jq = jint8.quantize_cond_score_params(v["params"], n)
    tq = tint8.quantize_cond_score_params(
        score_state_dict(v["params"], v.get("batch_stats")), n)
    return (jq, tq, jint8.precompute_cond_kv(jq, jnp.asarray(tokens)),
            tint8.precompute_cond_kv(tq, torch.from_numpy(tokens)))


def test_quantize_cond_score_params_bit_for_bit():
    """Every int8 code and scale and every bf16 weight of the JAX package's
    quantization, in the port's [out, in] layout."""
    jq, tq, _, _ = _both_quantized()
    for i, (jb, tb) in enumerate(zip(jq["blocks"], tq["blocks"])):
        assert set(jb) == set(tb)
        cross = i % 2 == 0
        assert ("kv_w" in tb) == cross and ("qkv_w" in tb) == (not cross)
        for key in tb:
            got = tb[key]
            want = jb[key]
            if key.endswith("_w"):
                assert got.dtype == (torch.bfloat16 if key == "kv_w"
                                     else torch.int8), key
                want = np.asarray(jnp.asarray(want, jnp.float32)).T
            np.testing.assert_array_equal(to_np(got), to_np(want), key)
    for key in ("ada_w", "fin_w", "ln_in_w", "ln_out_w"):
        assert tq[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(to_np(tq[key]), to_np(jq[key]).T)
    for key in ("ada_b", "fin_b", "ln_in_b", "ln_out_b"):
        np.testing.assert_array_equal(to_np(tq[key]), to_np(jq[key]))


def test_quantize_cond_score_params_takes_an_f32_score_and_refuses_bf16():
    from ldt_torch.models import Score

    v, _, _, _ = _score()
    _, tcfg = cfgs(COND_SCORE)
    sd = score_state_dict(v["params"], v.get("batch_stats"))
    score = Score(tcfg, device="cpu")
    score.load_state_dict(sd)
    from_module = tint8.quantize_cond_score_params(score, tcfg.num_blocks)
    _, tq, _, _ = _both_quantized()
    assert torch.equal(from_module["blocks"][0]["q_w"],
                       tq["blocks"][0]["q_w"])
    bf16 = Score(tcfg, dtype=torch.bfloat16, device="cpu")
    bf16.load_state_dict(sd)
    with pytest.raises(ValueError, match="f32"):
        tint8.quantize_cond_score_params(bf16, tcfg.num_blocks)


def test_precompute_cond_kv_matches_jax():
    """k and v of the cross blocks: contiguous bf16 copies of JAX's
    [B, M, 2D] projection's halves, within one bf16 rounding of its
    largest |value| (the same bf16 GEMM; it read bit for bit)."""
    jq, tq, jkv, tkv = _both_quantized()
    d = COND_SCORE["hidden_size"]
    for i, (want, got) in enumerate(zip(jkv, tkv)):
        if i % 2:
            assert want is None and got is None
            continue
        for part, ref in zip(got, (want[..., :d], want[..., d:])):
            assert part.dtype == torch.bfloat16 and part.is_contiguous()
            assert part.shape == (B, COND_SCORE["z_scale"], d)
            err = np.abs(to_np(part) - to_np(ref)).max()
            assert err <= 2.0 ** -8 * np.abs(to_np(ref)).max(), (i, err)


def _k2_kv_swapped():
    """A wrong variant: K2 with k and v swapped."""
    real = ops.cross_attention
    return mock.patch.object(ops, "cross_attention",
                             lambda q, k, v, h: real(q, v, k, h))


@pytest.mark.parametrize("step", [0, 2, 3])
@pytest.mark.parametrize("attn_int8", [False, True])
def test_denoise_cond_int8_matches_jax(attn_int8, step, monkeypatch):
    """One step of each twin on the same x, time embedding, image
    embedding and cached k, v: within COND_DENOISE_TOL; the wrong variants
    (k and v swapped in K2; with `attn_int8`, K8's scales per batch
    element) fall outside it."""
    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", attn_int8)
    _, _, img, t_embs = _score()
    jq, tq, jkv, tkv = _both_quantized()
    x = _rand((B, COND_SCORE["z_scale"], COND_SCORE["z_dim"]), 10 + step)
    h = COND_SCORE["num_heads"]
    want = jint8.denoise_cond_int8(jnp.asarray(x), jnp.asarray(t_embs[step]),
                                   jnp.asarray(img), jkv, jq, h,
                                   interpret=True)

    def run():
        return tint8.denoise_cond_int8(
            torch.from_numpy(x), torch.from_numpy(t_embs[step]),
            torch.from_numpy(img), tkv, tq, h, attn_int8=attn_int8)

    got = run()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    r = _rel_errs(got, want)
    assert _within(r, COND_DENOISE_TOL), r
    with _k2_kv_swapped():
        r = _rel_errs(run(), want)
    assert not _within(r, COND_DENOISE_TOL), r
    if attn_int8:
        with _k8_per_element():
            r = _rel_errs(run(), want)
        assert not _within(r, COND_DENOISE_TOL), r


def test_denoise_cond_int8_launch_pattern():
    """Each step: one K2 per even block, one K1 per odd block (or K8 with
    `attn_int8` and a batch a multiple of 4, else K1); nothing else."""
    _, _, img, t_embs = _score()
    _, tq, _, tkv = _both_quantized()
    x = torch.from_numpy(_rand((B, 8, 16), 3))
    nb = COND_SCORE["num_blocks"]
    for attn_int8, b in ((False, B), (True, B), (True, 3)):
        calls = {"K1": 0, "K2": 0, "K8": 0}

        def count(name, fn):
            def run(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return run

        kv = [None if c is None else (c[0][:b], c[1][:b]) for c in tkv]
        with mock.patch.object(ops, "cross_attention",
                               count("K2", ops.cross_attention)), \
                mock.patch.object(ops, "packed_self_attention", count(
                    "K1", ops.packed_self_attention)), \
                mock.patch.object(ops, "packed_self_attention_int8", count(
                    "K8", ops.packed_self_attention_int8)):
            tint8.denoise_cond_int8(x[:b], torch.from_numpy(t_embs[0]),
                                    torch.from_numpy(img[:b]), kv, tq,
                                    COND_SCORE["num_heads"],
                                    attn_int8=attn_int8)
        k8 = attn_int8 and b % tint8.ATTN_ELEMS == 0
        assert calls == {"K2": (nb + 1) // 2, "K1": 0 if k8 else nb // 2,
                         "K8": nb // 2 if k8 else 0}, (attn_int8, b, calls)


CASES = [dict(), dict(serve=False), dict(cond=False), dict(unet=True),
         dict(AdaLN=False), dict(norm="group_norm"),
         dict(sample_mode="continuous"), dict(predictor="pndm"),
         dict(predictor="ddim"), dict(cond=False, serve=False)]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "-".join(map(str, c)) or "on")
def test_int8_cond_serving_active_matches_jax(case, monkeypatch):
    from ldt_torch.configs import dict2namespace

    serve = case.get("serve", True)
    monkeypatch.setenv("LDT_SERVE_INT8", "1" if serve else "0")
    cfg = dict2namespace(dict(
        score=dict(norm=case.get("norm", "layer_norm"),
                   unet=case.get("unet", False),
                   AdaLN=case.get("AdaLN", True)),
        sde=dict(predictor=case.get("predictor", "ancestral"))))
    args = (cfg, case.get("sample_mode", "discrete"), case.get("cond", True))
    assert tint8.int8_cond_serving_active(*args, serve_int8=serve) == \
        jint8.int8_cond_serving_active(*args)


# --- sample_latents through the conditional twin ----------------------------

def _torch_score():
    from ldt_torch.models import Score

    v, _, _, _ = _score()
    _, tcfg = cfgs(COND_SCORE)
    score = Score(tcfg, device="cpu").eval()
    score.load_state_dict(score_state_dict(v["params"], v.get("batch_stats")))
    return score


def _sde():
    from ldt_torch.diffusion import make_diffusion
    from test_torch_port_common import SDE

    return make_diffusion(cfgs(dict(SDE, beta_end=3.0, sample_N=STEPS))[1],
                          device="cpu")


# sample_latents(int8=True, condition=) against the same STEPS-step
# ancestral loop written out here around JAX's `denoise_cond_int8`
# (the same pinned draws, JAX's encoded condition and time embeddings):
# (max, mean) of |torch - jax| over the largest |jax|. Over draws from
# three seeds the latents read at most (4.5e-3, 1.6e-4) through K1 (f32
# ulps where no LayerNorm tie is met, see COND_DENOISE_TOL) and (9.7e-3,
# 3.5e-4) through K8; with k and v swapped in K2 above (0.54, 0.15).
SAMPLE_TOL = (2e-2, 2e-3)


@pytest.mark.parametrize("attn_int8", [False, True])
def test_sample_latents_int8_condition_matches_jax(attn_int8, monkeypatch):
    from ldt_tpu.diffusion import DiffusionVPSDE as JaxVPSDE
    from test_torch_port_common import SDE

    monkeypatch.setattr(pa, "_PHASED", True)
    monkeypatch.setattr(pa, "_ELEMS", 4)
    monkeypatch.setattr(pa, "_INT8_ATTN", attn_int8)
    v, tokens, img, t_embs = _score()
    jq, _, jkv, _ = _both_quantized()
    jsde = JaxVPSDE(cfgs(dict(SDE, beta_end=3.0, sample_N=STEPS))[0])
    shape = (B, COND_SCORE["z_scale"], COND_SCORE["z_dim"])
    x0 = _rand(shape, 20)
    noise = np.stack([_rand(shape, 21 + i) for i in range(STEPS)])
    # the JAX ancestral loop (sampling.py's predictor), its score the twin
    ts = jnp.linspace(1.0, 1e-6, STEPS)
    idx = (ts * (STEPS - 1)).astype(jnp.int32)
    x = jnp.asarray(x0)
    for i in range(STEPS):
        t = jnp.full((B,), ts[i])
        p = jint8.denoise_cond_int8(x, jnp.asarray(t_embs[i]),
                                    jnp.asarray(img), jkv, jq,
                                    COND_SCORE["num_heads"], interpret=True)
        score = -p.astype(jnp.float32) / jsde.std(t)[:, None, None]
        beta = jsde.betas[idx[i]]
        x_mean = (x + beta * score) / jnp.sqrt(1.0 - beta)
        x = x_mean + jnp.sqrt(beta) * jnp.asarray(noise[i])
    want = x_mean

    from ldt_torch.generate import sample_latents

    score = _torch_score()
    monkeypatch.setattr(score, "embed_times",
                        lambda t: torch.from_numpy(t_embs))

    def run():
        return sample_latents(
            score, _sde(), B, STEPS, device="cpu", int8=True,
            attn_int8=attn_int8,
            condition=(torch.from_numpy(tokens), torch.from_numpy(img)),
            x0=torch.from_numpy(x0), noise=torch.from_numpy(noise))

    got = run()
    assert got.dtype == torch.float32 and got.shape == shape
    r = _rel_errs(got, want)
    assert _within(r, SAMPLE_TOL), r
    with _k2_kv_swapped():
        r = _rel_errs(run(), want)
    assert not _within(r, SAMPLE_TOL), r


def test_sample_latents_int8_condition_encodes_once_and_refuses():
    """A dict condition is encoded once a run (the trunk runs once); the
    weights are quantized and the cross k, v made once, not each step; a
    label, static scales, bf16_tail or a condition without point
    tokens raise."""
    from ldt_torch.generate import sample_latents

    score = _torch_score()
    cond = {k: torch.from_numpy(v) for k, v in _condition(5).items()}
    runs = score.c_net.resnet.runs
    calls = {"quantize": 0, "kv": 0}
    real_q, real_kv = (tint8.quantize_cond_score_params,
                       tint8.precompute_cond_kv)

    def quantize(*a, **kw):
        calls["quantize"] += 1
        return real_q(*a, **kw)

    def kv(*a, **kw):
        calls["kv"] += 1
        return real_kv(*a, **kw)

    with mock.patch.object(tint8, "quantize_cond_score_params", quantize), \
            mock.patch.object(tint8, "precompute_cond_kv", kv):
        got = sample_latents(score, _sde(), B, STEPS, device="cpu",
                             int8=True, condition=cond,
                             generator=torch.Generator().manual_seed(0))
    assert score.c_net.resnet.runs == runs + 1
    assert calls == {"quantize": 1, "kv": 1}
    assert torch.isfinite(got).all()
    kw = dict(device="cpu", int8=True, condition=cond)
    with pytest.raises(ValueError, match="bf16_tail"):
        sample_latents(score, _sde(), B, STEPS, bf16_tail=1, **kw)
    with pytest.raises(ValueError, match="act_scales"):
        sample_latents(score, _sde(), B, STEPS,
                       act_scales=torch.ones(STEPS, 3, 4), **kw)
    with pytest.raises(ValueError, match="tokens"):
        sample_latents(score, _sde(), B, STEPS, device="cpu", int8=True,
                       condition={"img": cond["img"]})
    with pytest.raises(ValueError, match="int8"):
        sample_latents(score, _sde(), B, STEPS, device="cpu", int8=True,
                       condition=cond, label=torch.zeros(B, dtype=torch.long))
