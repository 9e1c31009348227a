"""The completion trainers, ldt_torch against ldt_tpu on the CPU: `fps_to`,
one `update` of each (stage 1 on FPS-subsampled GT clouds; stage 2, the
conditional Score's train step with its BatchNorm statistics), the
conditional sampler (8 steps with JAX's per-step noise) and the trunk run
once per `sample`, `valsample` / `reconstruction` (CD x 1000, F1, the .npy
files), the conditional stage 2's checkpoint (save + resume, and the JAX
`.msgpack` both ways, strict and not).

Every draw comes from JAX: the reparameterization noise pinned on both
sides, stage 2's t and eta those of the JAX step's key. Limits, f32: a
loss and its gradients 1e-4 of each tensor's largest |value|
(test_torch_port_labels); parameters and EMA after the first Adam step
within 2 lr (the step moves each by lr sign(g): a gradient within its
rounding of 0, such as a bias right before a train-mode BatchNorm's, may
take either sign), Adam's mu 1e-4 relative, BatchNorm statistics 1e-5 or
1e-4 relative; the sampler's latents and clouds 1e-4 of their largest
|value| (test_torch_port_generate's f32 limit); CD and F1 rtol 1e-4."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.completion_compressor_trainer as jcct
import ldt_tpu.training.completion_latent_sde_trainer as jclt
import ldt_tpu.training.compressor_trainer as jct
import ldt_torch.training.completion_latent_sde_trainer as tclt
import ldt_torch.training.compressor_trainer as tct
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_tpu.training import checkpoint as jckpt
from ldt_torch import weights
from ldt_torch.configs import dict2namespace
from ldt_torch.training.completion_compressor_trainer import Trainer as Stage1
from ldt_torch.training.completion_compressor_trainer import fps_to
from ldt_torch.training.completion_latent_sde_trainer import Trainer as Stage2
from ldt_torch.training.jax_checkpoint import save_jax_checkpoint
from test_torch_port_common import (
    SMALL_COMPRESSOR,
    SMALL_SCORE,
    pin_reparameterize,
    to_np,
    trees_equal,
)
from test_torch_port_diffusion import _jax_draws

B = 2
N = SMALL_COMPRESSOR["outsize"]  # 64: the trainers' point count
IMG = 16
LR = 1e-3
STEPS = 8
SCORE = dict(SMALL_SCORE, condition=True, num_blocks=2)
# beta_end / sample_N below 1 at 8 steps (the discrete tables)
SDE = dict(beta_start=0.1, beta_end=4.0, sde_type="vpsde", sigma2_0=0.0,
           iw_sample_p_mode="drop_all_iw", iw_sample_q_mode="drop_all_iw",
           time_eps=0.01, ode_tol=1e-5, sample_time_eps=1e-6,
           sample_mode="discrete", predictor="ancestral", corrector=None,
           train_N=1000, sample_N=STEPS, snr=0.01, corrector_steps=1,
           denoise=True, probability_flow=False, alpha=1.0)
REL = 1e-4


def cfg_dict(save_path, **over):
    d = dict(
        data=dict(type="ldt_tpu.data.vipc", train_cate="plane",
                  test_cate="plane", train_preload=False, test_preload=False,
                  data_dir="", tr_max_sample_points=N,
                  te_max_sample_points=N, batch_size=B, test_batch_size=B,
                  num_categorys=1, num_workers=0),
        opt=dict(adj_lr="warm_up", warmup_iters=0, lr=LR, beta1=0.9,
                 beta2=0.999, ema_decay=0.99, weight_decay=0.0,
                 grad_norm_clip_value=1.0, kl_weight=1e-3, loss_type="l2",
                 discrete=True),
        log=dict(save_epoch_freq=1, save_path=str(save_path),
                 traincolumns=["epoch"], trainformat=[None],
                 evalcolumns=["epoch", "cd", "f1score"],
                 evalformat=[None, "{:.8f}", "{:.8f}"], log_epoch_freq=1,
                 eval_epoch_freq=1),
        common=dict(epochs=4, num_points=N, seed=0),
        model=SMALL_COMPRESSOR, compressor=SMALL_COMPRESSOR, score=SCORE,
        sde=SDE)
    for k, v in over.items():
        d[k] = dict(d[k], **v)
    return d



@pytest.fixture(autouse=True)
def one_thread():
    """The small models on one intra-op thread (the other test workers are
    busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _batch(seed, gt=80, part=100, b=B):
    rng = np.random.default_rng(seed)
    return {"views": rng.uniform(0, 1, (b, IMG, IMG, 3)).astype(np.float32),
            "pc": _rand((b, gt, 3), seed + 1),
            "pc_part": _rand((b, part, 3), seed + 2, 0.5)}


def _noise(seed, b=B):
    return [_rand((b, SMALL_COMPRESSOR["z_scales"],
                   SMALL_COMPRESSOR["z_dim"]), seed + i)
            for i in range(SMALL_COMPRESSOR["n_layers"])]


def _close(got, want, rel=REL, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= max(1e-5, rel * float(np.abs(want).max())), (what, err)


def _tree_close(got: dict, want: dict, **kw):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], what=k, **kw)


def _within_lr(got: dict, want: dict):
    """Parameters after the first step: each within 2 lr of JAX's."""
    assert set(got) == set(want)
    for k in want:
        err = float(np.abs(to_np(got[k]) - to_np(want[k])).max())
        assert err <= 2 * LR + 1e-6, (k, err)


def _captured_grads(monkeypatch, module):
    seen = {}
    real = module.apply_update

    def apply_update(state, grads, *a, **kw):
        seen.update({k: g.clone() for k, g in grads.items()})
        return real(state, grads, *a, **kw)

    monkeypatch.setattr(module, "apply_update", apply_update)
    return seen


def test_fps_to_matches_jax():
    pc = _rand((3, 300, 3), 0)
    got = fps_to(pc, 64)
    want = np.asarray(jcct.fps_to(pc, 64))
    np.testing.assert_array_equal(to_np(got), want)


# ---------------------------------------------------------------- stage 1


def _stub_rec(s, p, xp):
    """The reconstruction term both frameworks compute alike (the real
    chamfer + EMD are held by test_torch_port_stage1)."""
    return xp.mean(xp.square(s - p))


def _stage1_pair(tmp_path, monkeypatch, noise):
    d = cfg_dict(tmp_path)
    (tmp_path / "jax").mkdir(exist_ok=True)
    jd = cfg_dict(tmp_path / "jax")
    jcfg = jax_ns(jd)
    for module, xp in ((jct, jnp), (tct, torch)):
        monkeypatch.setattr(module, "CD_loss",
                            lambda s, q, xp=xp: _stub_rec(s, q, xp))
        monkeypatch.setattr(module, "EMD_loss", lambda s, q: 0.0)
    pin_reparameterize(monkeypatch, noise * 4)  # each trace takes a set
    jtr = jcct.Trainer(jcfg, JaxCompressor(jcfg.model))
    first = np.asarray(jcct.fps_to(_rand((B, 90, 3), 1), N))
    jtr.maybe_init({"tr_points": first, "cate_idx": np.zeros(B, np.int32)})
    ttr = Stage1(dict2namespace(d), device="cpu")
    ttr.maybe_init({"tr_points": first}, weights=weights.compressor_state_dict(
        {"params": _np(jtr.state.params),
         "batch_stats": _np(jtr.state.batch_stats)}))
    return jtr, ttr


def _stage1_tree(jtr, what):
    tree = getattr(jtr.state, what)
    return weights.compressor_state_dict(
        {"params": _np(tree), "batch_stats": _np(jtr.state.batch_stats)})


def test_stage1_update_matches_jax(tmp_path, monkeypatch):
    """One `update` on a raw array (the entry's FPS output): loss,
    gradients, parameters, Adam's mu and the BatchNorm statistics after
    the step, against the JAX trainer's; a ViPC dict's `pc` is taken as
    it is."""
    noise = _noise(30)
    jtr, ttr = _stage1_pair(tmp_path, monkeypatch, noise)
    tgrads = _captured_grads(monkeypatch, tct)
    data = fps_to(_rand((B, 90, 3), 2), N)
    want = jtr.update(np.asarray(data))
    got = ttr.update(data, noise=[_t(e) for e in noise])
    for g, w in zip(got, want):
        _close(g, w)
    sd = _stage1_tree(jtr, "params")
    _within_lr(ttr.state.params, {k: v for k, v in sd.items()
                                  if "running_" not in k})
    _tree_close(ttr.state.batch_stats, {k: v for k, v in sd.items()
                                        if "running_" in k})
    assert ttr.state.step == int(jtr.state.step) == 1
    assert tgrads  # the optimizer took the port's gradients
    mu = weights.compressor_state_dict(
        {"params": _np(jtr.state.opt_state[-1].mu),
         "batch_stats": _np(jtr.state.batch_stats)})
    _tree_close(ttr.state.opt_state.mu, {k: v for k, v in mu.items()
                                         if "running_" not in k}, rel=1e-3)
    vipc_batch = {"pc": _rand((B, N, 3), 3), "views": None, "pc_part": None}
    assert Stage1._batch(vipc_batch)["tr_points"] is vipc_batch["pc"]


def test_stage1_reconstruction_and_load_pretrain(tmp_path, monkeypatch):
    """`reconstruction` of a test loader (GT clouds FPS'd to the point
    count, the same pinned noise each batch on both sides): the clouds, CD
    x 1000 and F1 against JAX's, `rec_ep1.npy` written; `load_pretrain`
    takes the whole state of a stage-1 checkpoint and raises without
    one."""
    noise = _noise(40)
    jtr, ttr = _stage1_pair(tmp_path, monkeypatch, noise)
    loader = [{"pc": _rand((B, 90, 3), 50 + i)} for i in range(2)]
    monkeypatch.setattr(ttr, "reconstruct", lambda pts: Stage1.encode(
        ttr, pts, noise=[_t(e) for e in noise])["set"])
    want = jtr.reconstruction(loader)
    jrec = np.load(tmp_path / "jax" / "rec_ep1.npy")
    got = ttr.reconstruction(loader)
    rec = np.load(tmp_path / "rec_ep1.npy")
    assert rec.shape == (2 * B, N, 3)
    _close(rec, jrec)
    assert set(got) == set(want) == {"cd", "f1score"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    with pytest.raises(ValueError, match="pretrain_path"):
        ttr.load_pretrain()
    ttr.save()
    fresh = Stage1(dict2namespace(cfg_dict(
        tmp_path / "b", model=dict(pretrain_path=str(
            tmp_path / "checkpt_1.pt")))), device="cpu")
    fresh.maybe_init({"tr_points": _rand((B, N, 3), 9)})
    fresh.load_pretrain()
    assert trees_equal(fresh.state.to_tree(), ttr.state.to_tree())
    assert fresh.epoch == 1


# ---------------------------------------------------------------- stage 2


def _jax_stage2(save_path):
    """A JAX completion stage-2 trainer initialized on a ViPC batch."""
    jcfg = jax_ns(cfg_dict(save_path))
    jtr = jclt.Trainer(jcfg, JaxScore(jcfg.score),
                       JaxCompressor(jcfg.compressor))
    jtr.maybe_init(_batch(0))
    return jtr


@pytest.fixture(scope="module")
def jtr2(tmp_path_factory):
    """One JAX stage-2 trainer for the tests that only read its state (its
    files under its own directory)."""
    return _jax_stage2(tmp_path_factory.mktemp("jax_stage2"))


def _stage2_pair(tmp_path, jtr, **over):
    """The port's stage-2 trainer (saving under `tmp_path`) on `jtr`'s
    weights and BatchNorm statistics."""
    ttr = Stage2(dict2namespace(cfg_dict(tmp_path, **over)), device="cpu")
    ttr.maybe_init(_batch(0), score_weights=weights.score_state_dict(
        _np(jtr.state.params), _np(jtr.state.batch_stats)),
        compressor_weights=weights.compressor_state_dict(
            _np(jtr.comp_vars)))
    return ttr


def _jax_step_draws(jtr, shape):
    """The t indices and eta of the JAX conditional step at its step
    counter (fold_in of its base key)."""
    rng = jax.random.fold_in(jtr._base_key, jtr.state.step)
    _, k_t, k_eta = jax.random.split(rng, 3)
    idx = jax.random.randint(k_t, (shape[0],), 0, SDE["train_N"])
    return (torch.from_numpy(np.asarray(idx).astype(np.int64)),
            _t(jax.random.normal(k_eta, shape)))


def _score_tree(jtr, tree):
    """(params-structured `tree`, running statistics) in the port's names."""
    sd = weights.score_state_dict(_np(tree), _np(jtr.state.batch_stats))
    return ({k: v for k, v in sd.items() if "running_" not in k},
            {k: v for k, v in sd.items() if "running_" in k})


def test_stage2_update_matches_jax(tmp_path, monkeypatch):
    """Two `update`s on ViPC batches (views, GT and partial clouds FPS'd
    to the point count): the conditional Score in train mode, its
    ConditionNet's BatchNorm statistics into the step; loss, gradients,
    parameters, EMA, Adam's mu and the statistics against the JAX
    trainer's, every draw JAX's."""
    (tmp_path / "jax").mkdir()
    jtr = _jax_stage2(tmp_path / "jax")
    ttr = _stage2_pair(tmp_path, jtr)
    noise = _noise(60)
    pin_reparameterize(monkeypatch, noise * 2)
    tgrads = _captured_grads(monkeypatch, tclt)
    shape = (B, SCORE["z_scale"], SCORE["z_dim"])
    stats0 = {k: v.clone() for k, v in ttr.state.batch_stats.items()}
    for step in range(2):
        data = _batch(10 + step)
        t_idx, eta = _jax_step_draws(jtr, shape)
        want = jtr.update(data)
        got = ttr.update(data, t_idx=t_idx, eta=eta,
                         enc_noise=[_t(e) for e in noise])
        np.testing.assert_allclose(got.item(), float(want), rtol=REL)
        params, stats = _score_tree(jtr, jtr.state.params)
        ema, _ = _score_tree(jtr, jtr.state.ema_params)
        if step == 0:
            _within_lr(ttr.state.params, params)
            _within_lr(ttr.state.ema_params, ema)
        _tree_close(ttr.state.batch_stats, stats)
    assert ttr.state.step == int(jtr.state.step) == 2
    assert set(stats0) == set(ttr.state.batch_stats) and any(
        not torch.equal(stats0[k], ttr.state.batch_stats[k])
        for k in stats0)
    assert tgrads["c_net.resnet.conv1.weight"].abs().max() > 0
    mu, _ = _score_tree(jtr, jtr.state.opt_state[-1].mu)
    _tree_close(ttr.state.opt_state.mu, mu, rel=1e-3)


def test_stage2_update_on_arrays_with_a_condition(tmp_path, jtr2):
    """The entry's calling convention: GT clouds already FPS'd and the
    condition {'img', 'pts'} (views as numpy, points as a tensor)."""
    ttr = _stage2_pair(tmp_path, jtr2)
    data = _batch(20)
    loss = ttr.update(fps_to(data["pc"], N), {
        "img": data["views"], "pts": fps_to(data["pc_part"], N)})
    assert torch.isfinite(loss) and ttr.itr == 1 and ttr.state.step == 1


def _pinned_sampler(monkeypatch, jtr, calls):
    """The port's `sample_latents` takes the draws JAX's `sample` makes
    from its key at each call: rng -> (rng, k), k -> (k_sde, k_dec)."""
    shape = (B, SCORE["z_scale"], SCORE["z_dim"])
    rng, draws = jtr.rng, []
    for _ in range(calls):
        rng, k = jax.random.split(rng)
        draws.append(_jax_draws(jax.random.split(k)[0], STEPS, shape))
    pinned = iter(draws)
    real = tclt.sample_latents

    def sample_latents(*args, **kw):
        x0, noise = next(pinned)
        return real(*args, **dict(kw, x0=_t(x0), noise=_t(noise)))

    monkeypatch.setattr(tclt, "sample_latents", sample_latents)


def test_conditional_sampler_matches_jax(tmp_path, monkeypatch, jtr2):
    """`sample(B, condition=)`: 8 ancestral steps with JAX's per-step
    noise, the whole EMA Score each step with the condition encoded once
    (the trunk runs once), then the decode; latents-to-clouds against the
    JAX trainer's `sample`."""
    jtr, ttr = jtr2, _stage2_pair(tmp_path, jtr2)
    _pinned_sampler(monkeypatch, jtr, 1)
    data = _batch(30)
    cond = {"img": data["views"], "pts": np.asarray(jcct.fps_to(
        data["pc_part"], N))}
    want = np.asarray(jtr.sample(B, condition={k: jnp.asarray(v) for k, v
                                               in cond.items()}))
    runs = ttr.score.c_net.resnet.runs
    got, eps = ttr.sample(B, condition=cond)
    assert ttr.score.c_net.resnet.runs == runs + 1
    assert got.shape == (B, N, 3) and eps.shape == (B, 8, 8)
    _close(got, want)


@pytest.mark.parametrize("steps", [STEPS, 2 * STEPS])
def test_the_trunk_runs_once_per_sample(tmp_path, steps, jtr2):
    """However many steps the sampler takes, the condition (and so the
    ResNet trunk) is encoded once a run."""
    ttr = _stage2_pair(tmp_path, jtr2, sde=dict(sample_N=steps))
    from ldt_torch.diffusion import make_diffusion

    ttr.sde = make_diffusion(ttr.cfg.sde, device="cpu")
    data = _batch(31)
    before = ttr.score.c_net.resnet.runs
    clouds, _ = ttr.sample(B, condition={"img": data["views"],
                                         "pts": data["pc_part"]})
    assert ttr.score.c_net.resnet.runs == before + 1
    assert torch.isfinite(clouds).all()


def test_stage2_valsample_and_reconstruction_match_jax(tmp_path,
                                                       monkeypatch, jtr2):
    """`valsample`: one completion per test item (clouds FPS'd to 2048),
    CD x 1000 and F1 against the JAX trainer's with the same draws, the
    part / smp / ref files; `reconstruction` with pinned encode noise."""
    jtr, ttr = jtr2, _stage2_pair(tmp_path, jtr2)
    jdir = jtr.cfg.log.save_path
    loader = [_batch(40 + i, gt=2048, part=2048) for i in range(2)]
    _pinned_sampler(monkeypatch, jtr, len(loader))
    want = jtr.valsample(loader)
    got = ttr.valsample(loader)
    for name in ("part", "smp", "ref"):
        a = np.load(tmp_path / f"{name}_ep1.npy")
        b = np.load(os.path.join(jdir, f"{name}_ep1.npy"))
        assert a.shape == b.shape == ((2 * B, N, 3) if name == "smp"
                                      else (2 * B, 2048, 3))
        if name == "smp":
            _close(a, b, what=name)
        else:  # FPS of 2048 of 2048 points: the same points, the tail's
            # order decided by distances within rounding of each other
            np.testing.assert_array_equal(_sorted(a), _sorted(b))
    for k in ("cd", "f1score"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7)
    noise = _noise(70)
    pin_reparameterize(monkeypatch, noise * 4)
    monkeypatch.setattr(ttr, "reconstruct", lambda pts: ttr.compressor(
        pts, noise=[_t(e) for e in noise])["set"])
    want = jtr.reconstruction(loader)
    got = ttr.reconstruction(loader)
    _close(np.load(tmp_path / "rec_ep1.npy"),
           np.load(os.path.join(jdir, "rec_ep1.npy")))
    for k in ("cd", "f1score"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7)


def test_what_the_completion_sampler_does_not_port_raises(tmp_path, jtr2):
    """Once refused, now ported: `valsample(vis=True)` renders the
    completions under `<save_path>/vis`; the ODE sampler (`sample_mode:
    continuous`) completes the condition, and `int8=True` there serves the
    exact sampler (test_torch_port_sampler_trainers holds both against
    JAX)."""
    ttr = _stage2_pair(tmp_path, jtr2)
    data = _batch(50)
    cond = {"img": data["views"], "pts": data["pc_part"]}
    ttr.valsample([data], vis=True)
    xml = sorted(f for f in os.listdir(tmp_path / "vis")
                 if f.endswith(".xml"))
    assert xml == [f"smp_{i}.xml" for i in range(B)]
    ttr.cfg.sde.sample_mode = "continuous"
    state = ttr.generator.get_state()
    smp, eps = ttr.sample(B, condition=cond)
    assert smp.shape == (B, N, 3) and torch.isfinite(smp).all()
    assert ttr.ode_stats["nfe"] == 6 * ttr.ode_stats["steps"] > 0
    ttr.generator.set_state(state)
    assert torch.equal(ttr.sample(B, condition=cond, int8=True)[1], eps)


# ------------------------------------------------------------ checkpoints


def test_stage2_save_resume_keeps_the_batch_stats(tmp_path, jtr2):
    """A conditional stage-2 checkpoint holds the Score's running
    statistics: save, resume into a fresh trainer, every tensor back (the
    moments at their bf16 rounding), the counters continued."""
    ttr = _stage2_pair(tmp_path, jtr2)
    ttr.update(_batch(60))
    ttr.epoch_end()
    ttr.epoch = 1
    ttr.save()
    fresh = _stage2_pair(tmp_path, jtr2)
    fresh.resume(strict=True)
    live, back = ttr.state.to_tree(), fresh.state.to_tree()
    assert back["batch_stats"] and trees_equal(back["batch_stats"],
                                               live["batch_stats"])
    assert trees_equal(back["params"], live["params"])
    assert trees_equal(back["ema_params"], live["ema_params"])
    for k, v in live["opt_state"]["mu"].items():
        assert torch.equal(back["opt_state"]["mu"][k],
                           v.to(torch.bfloat16).float()), k
    assert (fresh.epoch, fresh.itr, fresh.state.step) == (2, 1, 1)


def test_stage2_jax_checkpoints_cross_both_ways(tmp_path, jtr2):
    """The port's conditional state (after a step) as a JAX `.msgpack`
    restores into the JAX trainer's tree, its batch_stats included; the
    JAX trainer's `.msgpack` resumes the port's; strict and not."""
    jtr, ttr = jtr2, _stage2_pair(tmp_path, jtr2)
    ttr.update(_batch(61))
    path = str(tmp_path / "port.msgpack")
    save_jax_checkpoint(path, ttr.state_tree(), ttr.tx, ttr.cfg, epoch=3,
                        itr=1)
    jtr.epoch = 5
    jtr.save()
    for strict in (True, False):
        ckpt = jckpt.load_checkpoint(path)
        js = jckpt.restore_into({"score": jtr.state,
                                 "compressor": jtr.comp_vars},
                                ckpt["state"], strict=strict)["score"]
        params, stats = _score_tree_of(js)
        assert trees_equal(params, ttr.state.params)
        assert trees_equal(stats, ttr.state.batch_stats)
        assert int(js.step) == 1
        fresh = _stage2_pair(tmp_path / f"other{strict}", jtr)
        fresh.cfg.log.save_path = jtr.cfg.log.save_path
        fresh.resume(epoch=5, strict=strict)
        params, stats = _score_tree_of(jtr.state)
        assert trees_equal(fresh.state.params, params)
        assert trees_equal(fresh.state.batch_stats, stats)
        assert fresh.epoch == 6


def _score_tree_of(state):
    """(params, running statistics) of a JAX TrainState, in the port's
    names."""
    sd = weights.score_state_dict(_np(state.params), _np(state.batch_stats))
    return ({k: v for k, v in sd.items() if "running_" not in k},
            {k: v for k, v in sd.items() if "running_" in k})


def _sorted(clouds):
    """Each cloud's points in lexicographic order."""
    return np.stack([c[np.lexsort(c.T[::-1])] for c in clouds])
