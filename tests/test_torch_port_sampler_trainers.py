"""`Trainer.sample` with `sde.predictor: pndm` and with `sde.sample_mode:
continuous` (the probability-flow ODE), ldt_torch's trainers against
ldt_tpu's on the CPU: the stage-2 trainer unconditional and
label-conditioned (a 55-category config cut in width), the Hybrid trainer
(its sampler is the stage-2 one's, inherited in both packages: it is held
to the JAX stage-2 trainer's latents on the same weights and draws, which
spares a compile of the same program) and the completion trainer with a
condition. Each pair samples from the same EMA weights (made by the port's
init, moved off it, carried to JAX through `ldt_torch.weights`) and from
JAX's initial draw, pinned on the torch side;
the JAX latents are read out of its jitted sample by a debug callback.
Both samplers run the whole Score at each evaluation (no hoisted
modulations), and `serve_int8=True` (the completion trainer's `int8=True`)
takes that exact path without a gate-stamp check, as JAX's
`int8_serving_active` is false there.

Limits, of the latents' largest |value|: PNDM 1e-4 (test_torch_port_
generate's f32 limit); the ODE 2e-3: JAX's jitted solver contracts a * b +
c into FMAs, and its f32 error estimate at tolerance 1e-5 then takes other
steps (test_torch_port_samplers holds the port step for step against JAX's
solver op by op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.training.completion_latent_sde_trainer as jclt
import ldt_tpu.training.hybrid_trainer as jht
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_tpu.training.state as jstate
import ldt_torch.training.completion_latent_sde_trainer as tclt
import ldt_torch.training.latent_sde_trainer as tlt
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch import weights
from ldt_torch.configs import dict2namespace
from ldt_torch.models import Compressor, Score
from ldt_torch.serving import int8 as tint8
from ldt_torch.training.hybrid_trainer import Trainer as Hybrid
from test_torch_port_checkpoint import run_cfg
from test_torch_port_common import SMALL_COMPRESSOR, SMALL_SCORE, perturbed
from test_torch_port_completion import _batch as _vipc_batch
from test_torch_port_completion import cfg_dict as completion_cfg
from test_torch_port_hybrid import _cfg_dict as hybrid_cfg

B, N = 4, SMALL_COMPRESSOR["outsize"]
CATS = 55
LABELS = np.array([0, 14, 54, 14])
PNDM_N = 20  # PNDM's steps (its tables come from train_N)
REL = {"pndm": 1e-4, "ode": 2e-3}
MODES = ["pndm", "ode"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _set_mode(cfg, mode):
    cfg.sde.sample_N = PNDM_N
    cfg.sde.predictor = "pndm" if mode == "pndm" else "ancestral"
    cfg.sde.sample_mode = "continuous" if mode == "ode" else "discrete"


def _pair(d, seed):
    """(JAX stage-2 trainer, port stage-2 trainer, port weights) of the
    config dict `d` on the same weights: the port's init (the Compressor's
    ActNorm on two clouds) moved off it, carried over to the JAX trainer,
    whose own init compile is spared."""
    pts = _rand((2, N, 3), seed)
    batch = {"tr_points": pts, "cate_idx": LABELS[:2]}
    gen = torch.Generator().manual_seed(seed)
    comp = Compressor(dict2namespace(d["compressor"]), device="cpu",
                      generator=gen)
    comp.init_actnorm(torch.from_numpy(pts))
    score = Score(dict2namespace(d["score"]), device="cpu", generator=gen)
    params = perturbed({"params": weights.score_params(
        dict(score.state_dict()))})["params"]
    comp_vars = weights.compressor_variables(dict(comp.state_dict()))
    jcfg = jax_ns(d)
    jtr = jlt.Trainer(jcfg, JaxScore(jcfg.score),
                      JaxCompressor(jcfg.compressor))
    jtr.comp_vars = jax.tree_util.tree_map(jnp.asarray, comp_vars)
    jtr.state = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), jtr.tx, ema=True)
    jtr.maybe_init(batch)
    port = dict(batch=batch, score_weights=weights.score_state_dict(params),
                compressor_weights=weights.compressor_state_dict(comp_vars))
    return jtr, _port(tlt.Trainer, d, port), port


def _port(cls, d, port):
    tr = cls(dict2namespace(d), device="cpu")
    tr.maybe_init(port["batch"], score_weights=port["score_weights"],
                  compressor_weights=port["compressor_weights"])
    return tr


def _stage2_cfg(save_path):
    d = run_cfg(save_path, score=dict(SMALL_SCORE, num_blocks=2,
                                      num_categorys=CATS))
    d["compressor"].update(class_condition=True, num_categorys=CATS)
    d["data"]["num_categorys"] = CATS
    return d


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """The 55-category stage-2 pair (labels through the Score and a
    class-conditional Compressor) and the JAX latents of each sampler run,
    kept for the Hybrid test."""
    jtr, ttr, port = _pair(_stage2_cfg(tmp_path_factory.mktemp("s2")), 1)
    return jtr, ttr, port, {}


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory, stage2):
    """The port's Hybrid trainer on the stage-2 pair's config (with the
    hybrid options) and weights."""
    d = _stage2_cfg(tmp_path_factory.mktemp("hyb"))
    d["opt"].update(hybrid_cfg("")["opt"])
    return _port(Hybrid, d, stage2[2])


@pytest.fixture(scope="module")
def completion(tmp_path_factory):
    """The completion pair on the port's init (the conditional Score's
    BatchNorm statistics included), its parameters moved off it."""
    d = completion_cfg(tmp_path_factory.mktemp("comp"))
    init = tclt.Trainer(dict2namespace(d), device="cpu")
    init.maybe_init(_vipc_batch(0))
    v = weights.score_variables(dict(init.score.state_dict()))
    params = perturbed({"params": v["params"]})["params"]
    comp_vars = weights.compressor_variables(
        dict(init.compressor.state_dict()))
    jcfg = jax_ns(d)
    jtr = jclt.Trainer(jcfg, JaxScore(jcfg.score),
                       JaxCompressor(jcfg.compressor))
    jtr.comp_vars = jax.tree_util.tree_map(jnp.asarray, comp_vars)
    jtr.state = jstate.TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), jtr.tx,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        ema=True)
    ttr = tclt.Trainer(dict2namespace(d), device="cpu")
    ttr.maybe_init(_vipc_batch(0), score_weights=weights.score_state_dict(
        params, v["batch_stats"]),
        compressor_weights=weights.compressor_state_dict(comp_vars))
    return jtr, ttr


def _condition(seed=7):
    rng = np.random.default_rng(seed)
    return {"img": rng.uniform(0, 1, (B, 16, 16, 3)).astype(np.float32),
            "pts": rng.standard_normal((B, N, 3)).astype(np.float32)}


def _jax_latents(monkeypatch, jtr, module, mode, **kw):
    """(the latents of the JAX trainer's next `sample` in `mode`, its
    initial draw): the sampler's output read by a debug callback, the
    draw made from the key the sample splits off (pndm's x0 and the ODE's
    noise both from k_sde itself)."""
    _set_mode(jtr.cfg, mode)
    jtr.sample_mode = jtr.cfg.sde.sample_mode
    seen = []
    for name in ("sample_discrete", "sample_model_ode"):
        real = getattr(module, name)

        def wrapper(*a, _real=real, **k):
            out = _real(*a, **k)
            eps = out[0] if isinstance(out, tuple) else out
            jax.debug.callback(lambda e: seen.append(np.asarray(e)), eps)
            return out

        monkeypatch.setattr(module, name, wrapper)
    jtr._build_steps()  # traced anew with the wrappers and the mode
    _, k = jax.random.split(jtr.rng)
    shape = (B, jtr.cfg.score.z_scale, jtr.cfg.score.z_dim)
    x0 = np.asarray(jax.random.normal(jax.random.split(k)[0], shape))
    jtr.sample(B, N, **kw)
    assert len(seen) == 1
    return seen[0], x0


def _port_latents(monkeypatch, ttr, module, mode, x0, **kw):
    """The port trainer's `sample` in `mode` from the pinned `x0`, with
    the Score's calls counted and the hoisted modulations refused."""
    _set_mode(ttr.cfg, mode)
    real, calls = module.sample_latents, []
    monkeypatch.setattr(module, "sample_latents", lambda *a, **k: real(
        *a, **dict(k, x0=torch.from_numpy(x0))))
    forward = Score.forward

    def counted(self, *a, **k):
        calls.append(a[1])
        return forward(self, *a, **k)

    def no_mods(*a, **k):
        raise AssertionError("PNDM and the ODE hoist no modulations")

    monkeypatch.setattr(Score, "forward", counted)
    monkeypatch.setattr(Score, "precompute_mods", no_mods)
    clouds, eps = ttr.sample(B, **kw)
    monkeypatch.undo()
    assert clouds.shape == (B, N, 3) and torch.isfinite(clouds).all()
    if mode == "pndm":
        assert len(calls) == PNDM_N + 9
    else:
        stats = ttr.ode_stats
        assert len(calls) == 7 * stats["steps"] and stats["nfe"] == \
            6 * stats["steps"] and not stats["capped"]
        assert stats["t"] == pytest.approx(ttr.cfg.sde.sample_time_eps,
                                           rel=1e-5)
    return eps.numpy()


def _assert_close(got, want, mode):
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert np.isfinite(got).all() and err <= REL[mode] * scale, (err, scale)


def _stage2_jax(monkeypatch, stage2, mode, label):
    """The JAX stage-2 trainer's (latents, x0) in `mode`, with the labels
    or none, made once."""
    jtr, _, _, runs = stage2
    if (mode, label) not in runs:
        kw = {} if label is None else {"label": jnp.asarray(LABELS)}
        runs[mode, label] = _jax_latents(monkeypatch, jtr, jlt, mode, **kw)
    return runs[mode, label]


@pytest.mark.parametrize("label", [None, "label"])
@pytest.mark.parametrize("mode", MODES)
def test_stage2_sampler_matches_jax(mode, label, stage2, monkeypatch):
    want, x0 = _stage2_jax(monkeypatch, stage2, mode, label)
    kw = {} if label is None else {"label": LABELS}
    got = _port_latents(monkeypatch, stage2[1], tlt, mode, x0, **kw)
    _assert_close(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
def test_hybrid_sampler_matches_jax(mode, hybrid, stage2, monkeypatch):
    """The JAX Hybrid trainer samples with the stage-2 trainer's program
    (it overrides neither `sample` nor `_build_steps`), so the stage-2
    trainer's latents on the same weights are its latents."""
    assert not {"sample", "_build_steps", "valsample"} & set(
        vars(jht.Trainer))
    want, x0 = _stage2_jax(monkeypatch, stage2, mode, None)
    got = _port_latents(monkeypatch, hybrid, tlt, mode, x0)
    _assert_close(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
def test_completion_sampler_matches_jax(mode, completion, monkeypatch):
    """The condition encoded once, fed into the Score at each
    evaluation."""
    jtr, ttr = completion
    cond = _condition()
    want, x0 = _jax_latents(monkeypatch, jtr, jclt, mode, condition={
        k: jnp.asarray(v) for k, v in cond.items()})
    runs = ttr.score.c_net.resnet.runs
    got = _port_latents(monkeypatch, ttr, tclt, mode, x0, condition=cond)
    assert ttr.score.c_net.resnet.runs == runs + 1
    _assert_close(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
def test_int8_serving_takes_the_exact_path(mode, stage2, completion,
                                           monkeypatch):
    """`serve_int8=True` (stage 2) and `int8=True` (completion) with PNDM
    or the ODE: no int8 option reaches the sampler, no gate stamp is
    checked, even with `strict`, and the latents equal the exact
    sampler's from the same generator state."""
    stamps = []
    monkeypatch.setattr(tint8, "verify_gate_stamp",
                        lambda *a, **k: stamps.append(a))
    for ttr, module, kw in (
            (stage2[1], tlt, dict(serve_int8=True, attn_int8=True,
                               strict=True)),
            (completion[1], tclt, dict(condition=_condition(), int8=True,
                                    attn_int8=True, strict=True))):
        _set_mode(ttr.cfg, mode)
        seen, real = [], module.sample_latents
        monkeypatch.setattr(module, "sample_latents",
                            lambda *a, _r=real, **k: seen.append(k) or _r(
                                *a, **k))
        state = ttr.generator.get_state()
        served = ttr.sample(B, **kw)[1]
        ttr.generator.set_state(state)
        exact = ttr.sample(B, **{k: v for k, v in kw.items()
                                 if k == "condition"})[1]
        assert torch.equal(served, exact)
        assert all("int8" not in k and "attn_int8" not in k for k in seen)
    assert stamps == []
