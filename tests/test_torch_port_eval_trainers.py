"""The trainers' evaluation, ldt_torch against ldt_tpu on the CPU: the
stage-1 `reconstruction` (one category and several) and `valsample`, and
the stage-2 `valsample`, each on the same weights with every draw pinned
(the reparameterization noise, the prior's latents, the sampler's draws),
against the JAX trainers' own methods; and what still raises."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.compressor_trainer as jct
import ldt_tpu.training.latent_sde_trainer as jlt
import ldt_torch.training.base as tbase
import ldt_torch.training.latent_sde_trainer as tlt
from ldt_tpu.models import Score as JaxScore
from chip_smoke import knn_margin, margin, synthetic_shapes
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_torch.configs import compressor_trainer_cfg, latent_trainer_cfg
from ldt_torch.eval.metrics import pairwise_EMD_CD
from ldt_torch.training.compressor_trainer import Trainer as Stage1
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from ldt_torch.weights import compressor_state_dict, score_state_dict
from test_torch_port_common import SDE, SMALL_COMPRESSOR, SMALL_SCORE
from test_torch_port_diffusion import _jax_draws
from test_torch_port_metrics import (
    CD_TOL,
    EMD_TOL,
    MARGIN,
    assert_metrics_match,
)

B, N = 4, SMALL_COMPRESSOR["outsize"]
C = SMALL_COMPRESSOR
# the stage-2 sampler's steps (beta_end / N must stay below 1)
STEPS = 32
# The clouds: the two frameworks' f32 networks in other orders (the
# tolerance of tests/test_torch_port_stage1.py's forward).
CLOUD_TOL = dict(rtol=1e-5, atol=1e-5)
# The stage-2 samples: 32 sampler steps apart, then the decoder
# (tests/test_torch_port_generate.py's f32 limit, relative to the largest
# |value|).
SAMPLE_REL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jax_cfg(tmp_path, num_categorys=1, **model):
    return jax_ns(dict(
        data=dict(cates=["airplane"], num_categorys=num_categorys,
                  tr_max_sample_points=N, te_max_sample_points=N,
                  batch_size=B, test_batch_size=B),
        opt=dict(adj_lr="warm_up", warmup_iters=4, lr=1e-3, beta1=0.9,
                 beta2=0.999, ema_decay=0.99, weight_decay=0.0,
                 grad_norm_clip_value=1.0, kl_weight=1e-6, loss_type="l2",
                 discrete=True),
        log=dict(save_epoch_freq=1, save_path=str(tmp_path / "jax"),
                 traincolumns=["epoch"], trainformat=[None],
                 evalcolumns=["epoch"], evalformat=[None],
                 log_epoch_freq=1, eval_epoch_freq=1),
        common=dict(epochs=4, num_points=N, seed=0),
        model=dict(C, **model), compressor=C, score=SMALL_SCORE,
        sde=dict(SDE, sample_N=STEPS, iw_sample_p_mode="drop_all_iw",
                 iw_sample_q_mode="drop_all_iw", ode_tol=1e-5,
                 predictor="ancestral", corrector=None, snr=0.01,
                 corrector_steps=1, denoise=True, probability_flow=False,
                 alpha=1.0)))


def _loader(seed, batches=2, categories=1):
    """Test batches as the data loader gives them: normalized clouds and
    each cloud's shift and scale."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        out.append({
            "te_points": rng.standard_normal((B, N, 3)).astype(np.float32),
            "shift": rng.uniform(-1, 1, (B, 1, 3)).astype(np.float32),
            "scale": rng.uniform(0.5, 2, (B, 1, 1)).astype(np.float32),
            "cate_idx": rng.integers(0, categories, B).astype(np.int32)})
    return out


def _recorder(monkeypatch, module, calls):
    """Record the (samples, refs) each trainer hands its metrics."""
    real = module.compute_all_metrics

    def record(smp, ref, batch_size, **kw):
        calls.append((np.asarray(smp), np.asarray(ref), batch_size))
        return real(smp, ref, batch_size, **kw)

    monkeypatch.setattr(module, "compute_all_metrics", record)


def _assert_scores_match(got, want, smp, ref):
    """The two trainers' scores: every key, the argmin-derived ones exactly
    where the margins (asserted here) allow it."""
    cd, emd = pairwise_EMD_CD(ref, smp, 8, device="cpu")
    rr = pairwise_EMD_CD(ref, ref, 8, device="cpu")
    ss = pairwise_EMD_CD(smp, smp, 8, device="cpu")
    for i, m in enumerate((cd, emd)):
        assert margin(m.T, 1) > MARGIN
        assert knn_margin(rr[i], m, ss[i]) > MARGIN
    strip = {k.removeprefix("val/gen/"): v for k, v in got.items()}
    assert all(k.startswith("val/gen/") for k in got)
    assert_metrics_match(strip, {k.removeprefix("val/gen/"): v
                                 for k, v in want.items()},
                         {"CD": CD_TOL, "EMD": EMD_TOL})


def _stage1_pair(tmp_path, num_categorys=1):
    """A JAX stage-1 trainer after its init and the port's on its weights."""
    (tmp_path / "jax").mkdir(exist_ok=True)
    jcfg = _jax_cfg(tmp_path, num_categorys)
    jtr = jct.Trainer(jcfg, jcm.Compressor(jcfg.model))
    first = {"tr_points": _rand((B, N, 3), 1),
             "cate_idx": np.zeros(B, np.int32)}
    jtr.maybe_init(first)
    tcfg = compressor_trainer_cfg(
        model=C, data=dict(num_categorys=num_categorys, batch_size=B),
        log=dict(save_path=str(tmp_path)))
    ttr = Stage1(tcfg, device="cpu")
    ttr.maybe_init(first, weights=compressor_state_dict(
        {"params": _np(jtr.state.params),
         "batch_stats": _np(jtr.state.batch_stats)}))
    return jtr, ttr


@pytest.mark.parametrize("categories", [1, 2])
def test_stage1_reconstruction_matches_jax(tmp_path, monkeypatch,
                                           categories):
    """Encode-decode with pinned noise, denormalize, score; with two
    categories only the clouds of `val_cate` (batches without one are
    skipped)."""
    jtr, ttr = _stage1_pair(tmp_path, categories)
    loader = _loader(2, batches=3, categories=categories)
    if categories > 1:
        loader[1]["cate_idx"][:] = 0  # a batch with no cloud of category 1
    keep = [(d["cate_idx"] == 1) if categories > 1 else np.ones(B, bool)
            for d in loader]
    noise = [[_rand((int(k.sum()), C["z_scales"], C["z_dim"]), 10 * b + i)
              for i in range(C["n_layers"])] for b, k in enumerate(keep)
             if k.any()]
    # JAX's encode takes each batch's noise as an argument of its jit (a
    # draw pinned while tracing would stay baked into the compiled encode)
    draws = {}
    monkeypatch.setattr(jcm, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                        * next(draws["it"]))

    @jax.jit
    def encode(variables, pts, eps):
        draws["it"] = iter(eps)
        return jtr.model.apply(variables, pts,
                               rngs={"sample": jax.random.key(0)})

    jbatches = iter(noise)
    monkeypatch.setattr(jtr, "_encode_step", lambda v, pts, rng, label:
                        encode(v, pts, tuple(next(jbatches))))
    tdraws = iter(noise)
    monkeypatch.setattr(ttr, "encode", lambda pts: Stage1.encode(
        ttr, pts, noise=[torch.from_numpy(e) for e in next(tdraws)]))
    jcalls, tcalls = [], []
    _recorder(monkeypatch, jct, jcalls)
    _recorder(monkeypatch, tbase, tcalls)
    val_cate = 1 if categories > 1 else 0
    want = jtr.reconstruction(loader, val_cate=val_cate)
    got = ttr.reconstrustion(loader, val_cate=val_cate)  # the alias
    (jrec, jref, jbs), (rec, ref, bs) = jcalls[0], tcalls[0]
    assert bs == jbs == 128
    assert rec.shape == (sum(int(k.sum()) for k in keep), N, 3)
    np.testing.assert_allclose(ref, jref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rec, jrec, **CLOUD_TOL)
    _assert_scores_match(got, want, rec, ref)
    np.testing.assert_array_equal(np.load(tmp_path / "rec_ep1.npy"), rec)


def test_stage1_valsample_matches_jax(tmp_path, monkeypatch):
    """The prior's latents pinned (`given_eps`), one batch of samples per
    test batch."""
    jtr, ttr = _stage1_pair(tmp_path)
    loader = _loader(3)
    eps = [_rand((B, C["z_scales"], C["n_layers"] * C["z_dim"]), 20 + b)
           for b in range(len(loader))]
    jeps, teps = iter(eps), iter(eps)
    monkeypatch.setattr(jtr, "sample", lambda n, p: jct.Trainer.sample(
        jtr, n, p, given_eps=jnp.asarray(next(jeps))))
    monkeypatch.setattr(ttr, "sample", lambda n, p: Stage1.sample(
        ttr, n, p, given_eps=torch.from_numpy(next(teps))))
    jcalls, tcalls = [], []
    _recorder(monkeypatch, jct, jcalls)
    _recorder(monkeypatch, tbase, tcalls)
    want = jtr.valsample(loader, N)
    got = ttr.valsample(loader, N)
    (jsmp, jref, _), (smp, ref, _) = jcalls[0], tcalls[0]
    np.testing.assert_array_equal(ref, jref)
    np.testing.assert_allclose(smp, jsmp, **CLOUD_TOL)
    _assert_scores_match(got, want, smp, ref)
    np.testing.assert_array_equal(np.load(tmp_path / "smp_ep1.npy"), smp)


def test_stage2_valsample_matches_jax(tmp_path, monkeypatch):
    """The EMA Score's samples with the sampler's draws pinned to those the
    JAX trainer makes from its key, decoded, scored."""
    (tmp_path / "jax").mkdir()
    jcfg = _jax_cfg(tmp_path)
    jtr = jlt.Trainer(jcfg, JaxScore(jcfg.score),
                      jcm.Compressor(jcfg.compressor))
    first = {"tr_points": _rand((B, N, 3), 4)}
    jtr.maybe_init(first)
    # the random-weight sampler's latents reach |x| ~ 1e2, which the random
    # decoder turns into clouds ~1e2 across, where exp(L d) underflows at
    # every level and the EMD is 0: the decoder's output layer is scaled
    # down, on both sides, to clouds ~1 across
    out = jtr.comp_vars["params"]["output_dense"]
    jtr.comp_vars["params"]["output_dense"] = jax.tree_util.tree_map(
        lambda a: a * 0.01, out)
    tcfg = latent_trainer_cfg(score=SMALL_SCORE, compressor=C,
                              sde=dict(SDE, sample_N=STEPS),
                              data=dict(tr_max_sample_points=N))
    ttr = Stage2(tcfg, device="cpu")
    ttr.maybe_init(first, score_weights=score_state_dict(
        _np(jtr.state.ema_params)), compressor_weights=compressor_state_dict(
        _np(jtr.comp_vars)))
    loader = _loader(5)
    rng = np.random.default_rng(5)
    for data in loader:
        data["te_points"] = synthetic_shapes(B, N, rng)
    # the draws jax's sample() makes: rng -> (rng, k); k -> (k_sde, k_dec)
    rng, draws = jtr.rng, []
    shape = (B, SMALL_SCORE["z_scale"], SMALL_SCORE["z_dim"])
    for _ in loader:
        rng, k = jax.random.split(rng)
        draws.append(_jax_draws(jax.random.split(k)[0], STEPS, shape))
    pinned = iter(draws)
    real = tlt.sample_latents

    def sample_latents(*args, **kw):
        x0, noise = next(pinned)
        return real(*args, **dict(kw, x0=torch.tensor(x0),
                                  noise=torch.tensor(noise)))

    monkeypatch.setattr(tlt, "sample_latents", sample_latents)
    jcalls, tcalls = [], []
    _recorder(monkeypatch, jlt, jcalls)
    _recorder(monkeypatch, tbase, tcalls)
    want = jtr.valsample(loader)
    got = ttr.valsample(loader)
    (jsmp, jref, jbs), (smp, ref, bs) = jcalls[0], tcalls[0]
    assert bs == jbs == 64 and smp.shape == (2 * B, N, 3)
    np.testing.assert_array_equal(ref, jref)
    err = np.abs(smp - jsmp).max()
    assert err <= SAMPLE_REL * np.abs(jsmp).max(), err
    _assert_scores_match(got, want, smp, ref)


def test_what_the_evaluation_does_not_port_yet_raises(tmp_path):
    """Once refused, `valsample(vis=True)` now renders: without a save path
    both trainers say that it needs one, before sampling; with one, the
    scenes of the saved samples go to `<save_path>/vis` (2 x B clouds, an
    XML each, beside a PNG where matplotlib imports)."""
    s1 = Stage1(compressor_trainer_cfg(model=C), device="cpu")
    with pytest.raises(ValueError, match="save_path"):
        s1.valsample(_loader(6), N, vis=True)
    cfg = latent_trainer_cfg(score=SMALL_SCORE, compressor=C, sde=SDE)
    s2 = Stage2(cfg, device="cpu")
    with pytest.raises(ValueError, match="save_path"):
        s2.valsample(_loader(6), vis=True)
    for name, trainer, run in (
            ("s1", s1, lambda: s1.valsample(_loader(6), N, vis=True)),
            ("s2", s2, lambda: s2.valsample(_loader(6), vis=True))):
        trainer.cfg.log = SimpleNamespace(save_path=str(tmp_path / name))
        os.makedirs(trainer.cfg.log.save_path)
        trainer.maybe_init({"tr_points": _loader(7)[0]["te_points"]})
        run()
        xml = sorted(f for f in os.listdir(tmp_path / name / "vis")
                     if f.endswith(".xml"))
        assert xml == sorted(f"smp_{i}.xml" for i in range(2 * B))
