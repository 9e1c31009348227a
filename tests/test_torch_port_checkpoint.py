"""Checkpoints of the port (`ldt_torch.training.checkpoint`) and the bridge
to the JAX package's files (`ldt_torch.training.jax_checkpoint`), on the CPU.

  * the cases of tests/test_checkpoint.py on the port's format: strict and
    non-strict restore, the dtype recast, ActNorm's broadcast, bf16
    moments, async writes, `resolve_checkpoint_epoch`;
  * save + resume equals continuing in memory, bit for bit, for both
    trainers (stage 2 after rounding the Adam moments to bf16 at the save,
    as its save stores them);
  * a JAX trainer's checkpoint, single-file and sharded, read into the
    port's trainer gives the JAX trainer's next update (pinned draws);
  * the port's state written in the JAX format restores strictly into the
    JAX trainer's template with equal leaves;
  * the msgpack codec's bytes equal flax's `msgpack_serialize`.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import msgpack_serialize

import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.checkpoint as jckpt
import ldt_tpu.training.state as jstate
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.models import Score as JaxScore
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_tpu.training import compressor_trainer as jct
from ldt_tpu.training import latent_sde_trainer as jlt
from ldt_torch.configs import dict2namespace as torch_ns
from ldt_torch.training import jax_checkpoint as jc
from ldt_torch.training.checkpoint import (
    load_checkpoint,
    resolve_checkpoint_epoch,
    restore_into,
    save_checkpoint,
    wait_pending_saves,
)
from ldt_torch.training.compressor_trainer import Trainer as Stage1
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from ldt_torch.models import Compressor, Score
from ldt_torch.training.state import make_optimizer
from ldt_torch.weights import (
    compressor_state_dict,
    compressor_variables,
    score_params,
    score_state_dict,
)
from test_torch_port_common import F32_TOL, SMALL_COMPRESSOR, SMALL_SCORE
from test_torch_port_stage1 import STEP_TOL, _split_null

B, N = 4, 64
# one block at hidden 512: its attention and MLP kernels are >= 1 MiB, the
# leaves the JAX package's sharded format puts in shard files
MEDIUM_SCORE = dict(SMALL_SCORE, hidden_size=512, num_heads=8, num_blocks=1)
FULL_SDE = dict(
    beta_start=0.1, beta_end=20.0, sde_type="vpsde", sigma2_0=0.0,
    iw_sample_p_mode="drop_all_iw", iw_sample_q_mode="drop_all_iw",
    time_eps=0.01, ode_tol=1e-5, sample_time_eps=1e-6,
    sample_mode="discrete", predictor="ancestral", corrector=None,
    train_N=1000, sample_N=64, snr=0.01, corrector_steps=1, denoise=True,
    probability_flow=False, alpha=1.0)
TRAIN_LOG = dict(traincolumns=["epoch", "itr", "loss", "kl_loss", "rec_loss",
                               "max_feature", "time"],
                 trainformat=[None, None, "{:.4f}", "{:.4f}", "{:.4f}",
                              "{:.4f}", "{:.0f}"],
                 evalcolumns=["epoch", "mmd-CD"], evalformat=[None, "{:.8f}"])
SDE_LOG = dict(traincolumns=["epoch", "itr", "loss", "time"],
               trainformat=[None, None, "{:.4f}", "{:.0f}"],
               evalcolumns=["epoch", "mmd-CD"], evalformat=[None, "{:.8f}"])


def run_cfg(save_path, *, score=SMALL_SCORE, log=SDE_LOG, data_dir="",
            points=N, batch=B):
    """A whole config of both stages as a dict (read by either package's
    trainers and entries): the small models, a `log:` section under
    `save_path`."""
    comp = dict(SMALL_COMPRESSOR, outsize=points, max_outputs=points)
    return dict(
        data=dict(cates=["airplane"], num_categorys=1,
                  tr_max_sample_points=points, te_max_sample_points=points,
                  data_dir=str(data_dir), batch_size=batch,
                  test_batch_size=batch, boundary=True),
        opt=dict(adj_lr="warm_up", warmup_iters=2, lr=1e-3, beta1=0.9,
                 beta2=0.999, ema_decay=0.9, weight_decay=0.0,
                 grad_norm_clip_value=1.0, kl_weight=1e-3, loss_type="l2",
                 discrete=True),
        log=dict(save_epoch_freq=1, save_path=str(save_path),
                 log_epoch_freq=1, eval_epoch_freq=1000, **log),
        common=dict(epochs=8, num_points=points, seed=0),
        model=comp, compressor=dict(comp), score=dict(score),
        sde=dict(FULL_SDE))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _noise(seed):
    c = SMALL_COMPRESSOR
    return [_rand((B, c["z_scales"], c["z_dim"]), seed + i)
            for i in range(c["n_layers"])]


def _pin_jax_noise(monkeypatch, noise):
    draws = iter(noise)
    monkeypatch.setattr(jcm, "reparameterize",
                        lambda rng, mu, logvar: mu + jnp.exp(logvar / 2.0)
                        * jnp.asarray(next(draws)))


def _adam(opt_state):
    import optax

    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]


def _assert_equal(got, want, path=""):
    """Two trees equal: tensors bit for bit, other leaves by ==."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


def _assert_close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   want[k].detach().numpy(), err_msg=k,
                                   **(tol or F32_TOL))


# ------------------------------------------------ the checkpoint functions

def _small_tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.zeros(3)},
            "extra": torch.ones(4), "count": 3}


def test_strict_roundtrip(tmp_path):
    tree = _small_tree()
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, tree, epoch=3, itr=7, time=1.5)
    ckpt = load_checkpoint(path)
    assert (ckpt["epoch"], ckpt["itr"], ckpt["time"]) == (3, 7, 1.5)
    _assert_equal(restore_into(tree, ckpt["state"]), tree)
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("case", ["missing", "unexpected"])
def test_strict_restore_refuses_other_keys(case):
    tree = _small_tree()
    loaded = copy.deepcopy(tree)
    if case == "missing":
        del loaded["params"]["b"]
    else:
        loaded["params"]["stale_head"] = torch.ones(2)
    with pytest.raises(ValueError, match=case):
        restore_into(tree, loaded, strict=True)


def test_non_strict_keeps_missing_and_ignores_unexpected():
    tree = _small_tree()
    loaded = {"params": {"w": tree["params"]["w"] + 1.0,
                         "stale_head": torch.ones(2)},
              "other": {"x": torch.zeros(1)}, "count": 5}
    out = restore_into(tree, loaded, strict=False)
    assert torch.equal(out["params"]["w"], tree["params"]["w"] + 1.0)
    assert out["params"]["b"] is tree["params"]["b"]
    assert out["extra"] is tree["extra"] and out["count"] == 5
    assert set(out) == set(tree) and set(out["params"]) == {"w", "b"}


def test_leaves_are_cast_to_the_template_dtype():
    tree = {"mu": torch.linspace(0, 1, 8)}
    out = restore_into(tree, {"mu": tree["mu"].to(torch.bfloat16)})
    assert out["mu"].dtype == torch.float32
    assert torch.equal(out["mu"], tree["mu"].to(torch.bfloat16).float())


def test_only_actnorm_statistics_broadcast():
    template = {"conv_in.shift": torch.zeros(1, 4, 8),
                "conv_in.log_scale": torch.zeros(1, 4, 8)}
    pooled = torch.arange(8.0).reshape(1, 1, 8)
    out = restore_into(template, {"conv_in.shift": pooled,
                                  "conv_in.log_scale": pooled})
    assert out["conv_in.shift"].shape == (1, 4, 8)
    assert torch.equal(out["conv_in.shift"][0, 2], torch.arange(8.0))
    with pytest.raises(ValueError, match="shape"):
        restore_into(template, {"conv_in.shift": torch.zeros(1, 3, 8),
                                "conv_in.log_scale": pooled})
    with pytest.raises(ValueError, match="'weight'"):
        restore_into({"fc.weight": torch.zeros(4, 8)},
                     {"fc.weight": torch.zeros(1, 8)})


def test_bf16_moments_and_async_write(tmp_path):
    tree = {"params": {"w": torch.randn(1000)},
            "opt_state": {"count": 2, "mu": {"w": torch.randn(1000)},
                          "nu": {"w": torch.rand(1000)}}}
    path = str(tmp_path / "ck.pt")
    saved = tree["params"]["w"].clone()
    save_checkpoint(path, tree, moments_bf16=True, async_write=True)
    tree["params"]["w"].add_(1.0)  # a step after the save: not in the file
    ckpt = load_checkpoint(path)  # joins the write
    state = ckpt["state"]
    assert state["opt_state"]["mu"]["w"].dtype == torch.bfloat16
    assert torch.equal(state["params"]["w"], saved)
    out = restore_into(tree, state)
    assert out["opt_state"]["nu"]["w"].dtype == torch.float32
    assert torch.equal(out["opt_state"]["mu"]["w"],
                       tree["opt_state"]["mu"]["w"].bfloat16().float())


def test_an_async_write_error_is_raised_on_join(tmp_path):
    path = str(tmp_path / "missing_dir" / "ck.pt")
    save_checkpoint(path, _small_tree(), async_write=True)
    with pytest.raises(Exception):
        wait_pending_saves()
    wait_pending_saves()  # reported once


class TestResolveCheckpointEpoch:
    def _touch(self, d, epoch, suffix=".pt"):
        (d / f"checkpt_{epoch}{suffix}").write_bytes(b"x")

    def test_a_write_in_flight_is_waited_for(self, tmp_path, monkeypatch):
        """A stage-2 save writes on a thread: a resume in the same process
        right after it (two entry runs in one program) finds its file."""
        import threading

        import ldt_torch.training.checkpoint as ckpt

        gate = threading.Event()
        real = ckpt.torch.save

        def slow_save(*a, **kw):
            gate.wait(5)
            return real(*a, **kw)

        monkeypatch.setattr(ckpt.torch, "save", slow_save)
        (tmp_path / "training.csv").write_text("epoch,loss\n3,1.0\n")
        save_checkpoint(str(tmp_path / "checkpt_3.pt"), _small_tree(),
                        async_write=True)
        threading.Timer(0.2, gate.set).start()
        assert resolve_checkpoint_epoch(str(tmp_path)) == 3
        assert ckpt.checkpoint_file(str(tmp_path), 3) is not None

    @pytest.mark.parametrize("suffix", [".pt", ".msgpack"])
    def test_explicit_epoch_must_exist(self, tmp_path, suffix):
        self._touch(tmp_path, 10, suffix)
        assert resolve_checkpoint_epoch(str(tmp_path), 10) == 10
        with pytest.raises(FileNotFoundError, match="epoch 20"):
            resolve_checkpoint_epoch(str(tmp_path), 20)

    def test_csv_epoch_used_when_on_disk(self, tmp_path):
        (tmp_path / "training.csv").write_text("epoch,loss\n5,1.0\n7,0.9\n")
        self._touch(tmp_path, 7)
        self._touch(tmp_path, 9, ".msgpack")
        assert resolve_checkpoint_epoch(str(tmp_path)) == 7

    def test_falls_back_to_newest_on_disk(self, tmp_path):
        (tmp_path / "training.csv").write_text("epoch,loss\n9,1.0\n")
        self._touch(tmp_path, 4)
        self._touch(tmp_path, 8, ".msgpack")
        assert resolve_checkpoint_epoch(str(tmp_path)) == 8

    def test_empty_dir_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            resolve_checkpoint_epoch(str(tmp_path))


# ------------------------------------- save + resume == continuing in memory

def _trainer_state(t) -> dict:
    return {"tree": t.state_tree(), "itr": t.itr, "epoch": t.epoch,
            "start": t._itr_epoch_start, "lr": t.current_lr()}


def _snapshot(t) -> dict:
    return copy.deepcopy(_trainer_state(t))


def test_stage1_save_and_resume_equal_continuing(tmp_path):
    cfg = torch_ns(run_cfg(tmp_path, log=TRAIN_LOG))
    pts = [_rand((B, N, 3), 10 + i) for i in range(4)]
    noise = [[_t(e) for e in _noise(20 + 10 * i)] for i in range(4)]
    a = Stage1(cfg, device="cpu")
    for i in range(2):
        a.update({"tr_points": pts[i]}, noise=noise[i])
    a.epoch_end()  # saves epoch 1
    saved = _snapshot(a)
    b = Stage1(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    b.maybe_init({"tr_points": pts[3]})
    b.resume()
    _assert_equal(_trainer_state(b), saved)
    for k, p in b.model.named_parameters():  # the module holds the state
        assert b.state.params[k] is p
    for i in (2, 3):
        a.update({"tr_points": pts[i]}, noise=noise[i])
        b.update({"tr_points": pts[i]}, noise=noise[i])
    _assert_equal(_trainer_state(b), _trainer_state(a))
    assert b.state.step == b.itr == 4 and b.epoch == 2


def test_stage2_save_and_resume_equal_continuing(tmp_path):
    cfg = torch_ns(run_cfg(tmp_path))
    pts = [_rand((B, N, 3), 30 + i) for i in range(4)]
    draws = [dict(t_idx=torch.tensor([1, 200, 500, 990]) + i,
                  eta=_t(_rand((B, 8, 8), 40 + i)),
                  enc_noise=[_t(e) for e in _noise(50 + 10 * i)])
             for i in range(4)]
    a = Stage2(cfg, device="cpu")
    for i in range(2):
        a.update({"tr_points": pts[i]}, **draws[i])
    a.epoch_end()  # saves epoch 1: moments in bf16, on a thread
    saved = _snapshot(a)
    b = Stage2(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    b.maybe_init({"tr_points": pts[3]})
    b.resume()
    # params and EMA exact; the moments their bf16 rounding
    opt = saved["tree"]["score"]["opt_state"]
    for m in ("mu", "nu"):
        opt[m] = {k: v.bfloat16().float() for k, v in opt[m].items()}
    _assert_equal(_trainer_state(b), saved)
    with torch.no_grad():  # the trainer that continued, moments rounded
        for m in (a.state.opt_state.mu, a.state.opt_state.nu):
            for v in m.values():
                v.copy_(v.bfloat16().float())
    for i in (2, 3):
        a.update({"tr_points": pts[i]}, **draws[i])
        b.update({"tr_points": pts[i]}, **draws[i])
    _assert_equal(_trainer_state(b), _trainer_state(a))


@pytest.mark.parametrize("stage", [1, 2])
def test_finetune_and_load_optim(tmp_path, stage):
    cfg = torch_ns(run_cfg(tmp_path, log=TRAIN_LOG if stage == 1
                           else SDE_LOG))
    kind = Stage1 if stage == 1 else Stage2
    pts = _rand((B, N, 3), 60)
    a = kind(cfg, device="cpu")
    a.update({"tr_points": pts})
    a.update({"tr_points": pts})
    a.epoch_end()
    b = kind(cfg, device="cpu")
    b.maybe_init({"tr_points": pts})
    mu = copy.deepcopy(b.state.opt_state.mu)
    b.resume(load_optim=False)
    _assert_equal(b.state.opt_state.mu, mu)
    _assert_equal(b.state.params, a.state.params)
    assert (b.epoch, b.itr) == (2, 2)
    b.epoch, b.itr = 5, 7
    b.resume(finetune=True)
    assert (b.epoch, b.itr) == ((5, 7) if stage == 1 else (1, 0))


# ---------------------------------------- JAX checkpoints -> port trainers

def _grads_like(params, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(scale * rng.standard_normal(a.shape),
                              jnp.float32), params)


def _jax_trainer(stage, save_path):
    """A JAX trainer of either stage at the state after one optimizer step
    (random gradients: nonzero moments, EMA, step and count; stage 1 with
    running statistics off their initial values), and its config dict."""
    d = run_cfg(save_path, score=MEDIUM_SCORE,
                log=TRAIN_LOG if stage == 1 else SDE_LOG)
    jcfg = jax_ns(copy.deepcopy(d))
    pts = {"tr_points": _rand((B, N, 3), 5)}
    if stage == 1:
        jt = jct.Trainer(jcfg, JaxCompressor(jcfg.model))
    else:
        jt = jlt.Trainer(jcfg, JaxScore(jcfg.score),
                         JaxCompressor(jcfg.compressor))
    jt.maybe_init(pts)
    s = jt.state
    stats = s.batch_stats if stage == 1 else None
    if stats is not None:
        rng = np.random.default_rng(3)
        stats = jax.tree_util.tree_map_with_path(
            lambda p, a: a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
            if p[-1].key == "var" else
            a + 0.2 * rng.standard_normal(a.shape).astype(np.float32), stats)
    jt.state = jstate.apply_update(s, _grads_like(s.params, 11), jt.tx, 1e-4,
                                   ema_decay=jt.cfg.opt.ema_decay,
                                   new_batch_stats=stats)
    jt.itr = 1
    return d, jt


def _jax_tree(stage, jt):
    if stage == 1:
        return {"state": jt.state}
    return {"score": jt.state, "compressor": jt.comp_vars}


def _save_jax(path, stage, jt, sharded):
    """What the JAX trainer's `save` writes (stage 2: bf16 moments, on a
    thread), or the same in the sharded format (every leaf of 1 MiB or
    more to a shard file)."""
    kw = dict(cfg=jt.cfg, epoch=jt.epoch, itr=jt.itr, time=0.0,
              moments_bf16=stage == 2, async_write=stage == 2)
    if sharded:
        kw["shard_threshold"] = 1
    jckpt.save_checkpoint(path, _jax_tree(stage, jt), **kw)
    jckpt.wait_pending_saves()
    assert os.path.exists(path + ".shard0") == sharded


def _jax_restored(stage, jt, path):
    """The JAX trainer's `resume` of `path`: its state from the file."""
    return jckpt.restore_into(_jax_tree(stage, jt),
                              jckpt.load_checkpoint(path)["state"])


def _comp_params(tree, stats):
    sd = compressor_state_dict({"params": _np(tree), "batch_stats": stats})
    return {k: v for k, v in sd.items() if "running_" not in k}


def _port_tree(stage, restored) -> dict:
    """The port's state tree of a JAX trainer's restored state, by the
    weight converters."""
    js = restored["state" if stage == 1 else "score"]
    adam = _adam(js.opt_state)
    if stage == 1:
        stats = _np(js.batch_stats)
        to_port = lambda t: _comp_params(t, stats)  # noqa: E731
        sd = compressor_state_dict({"params": _np(js.params),
                                    "batch_stats": stats})
        bs = {k: v for k, v in sd.items() if "running_" in k}
    else:
        to_port = lambda t: score_state_dict(_np(t))  # noqa: E731
        bs = None
    ts = {"step": int(js.step), "params": to_port(js.params),
          "ema_params": None if js.ema_params is None
          else to_port(js.ema_params),
          "opt_state": {"count": int(adam.count), "mu": to_port(adam.mu),
                        "nu": to_port(adam.nu)},
          "batch_stats": bs}
    if stage == 1:
        return {"state": ts}
    return {"score": ts,
            "compressor": compressor_state_dict(_np(restored["compressor"]))}


STEP = dict(pts=_rand((B, N, 3), 6), noise=_noise(7),
            idx=np.array([3, 250, 600, 999]), eta=_rand((B, 8, 8), 4))


def _jax_next_update(stage, jt, js):
    """The JAX trainer's next update from state `js`, with STEP's draws:
    (outputs, new state, lr)."""
    pts = jnp.asarray(STEP["pts"])
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax_noise(mp, STEP["noise"])
        if stage == 1:
            def loss_fn(p):
                return jct.compressor_objective(
                    jt.model, p, js.batch_stats, pts, None,
                    jax.random.key(0), jt.cfg.opt.kl_weight)

            (loss, (kl, rec, max_f, new_bs)), grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(js.params)
            out = (loss, kl, rec, max_f)
        else:
            eps = jt.compressor.apply(
                jt.comp_vars, pts, rngs={"sample": jax.random.key(0)}
            )["all_eps"]
            t = jt.timesteps[jnp.asarray(STEP["idx"])]

            def loss_fn(p):
                return jlt.score_objective(
                    jt.model, p, eps, t, jt.SDE.var(t)[:, None, None],
                    jt.SDE.e2int_f(t)[:, None, None], jnp.ones((B, 1, 1)),
                    jnp.asarray(STEP["eta"]), None, None, True,
                    jax.random.key(9), "l2")

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(js.params)
            out, new_bs = (loss,), None
    lr = jt.current_lr()
    js = jstate.apply_update(js, grads, jt.tx, lr,
                             ema_decay=0.0 if stage == 1
                             else jt.ema_decay, new_batch_stats=new_bs)
    return out, js, lr


@pytest.fixture(scope="module", params=[1, 2], ids=["stage1", "stage2"])
def jax_run(request, tmp_path_factory):
    """A JAX trainer, its checkpoint restored as its `resume` restores it,
    and its next update from there."""
    stage = request.param
    save = tmp_path_factory.mktemp(f"jax{stage}")
    d, jt = _jax_trainer(stage, save)
    path = str(save / "checkpt_1.msgpack")
    _save_jax(path, stage, jt, sharded=False)
    restored = _jax_restored(stage, jt, path)
    js = restored["state" if stage == 1 else "score"]
    out, after, lr = _jax_next_update(stage, jt, js)
    return dict(stage=stage, cfg=d, jt=jt, start=_port_tree(stage, restored),
                out=out, after=_port_tree(stage, {
                    "state": after, "score": after,
                    "compressor": restored.get("compressor")}), lr=lr)


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_jax_checkpoint_gives_the_jax_next_update(tmp_path, jax_run,
                                                  sharded):
    """The port's trainer resumes a JAX trainer's checkpoint (found as
    `checkpt_1.msgpack` in its save_path) with every leaf equal to the JAX
    trainer's restore, and then takes the JAX trainer's next update (stage
    2 within test_torch_port_training's tolerances, stage 1 within
    test_torch_port_stage1's)."""
    stage, jt = jax_run["stage"], jax_run["jt"]
    cfg = torch_ns(dict(copy.deepcopy(jax_run["cfg"]),
                        log=dict(jax_run["cfg"]["log"],
                                 save_path=str(tmp_path))))
    path = str(tmp_path / "checkpt_1.msgpack")
    _save_jax(path, stage, jt, sharded)
    if sharded and stage == 2:  # the hidden-512 kernels went to shards
        assert os.path.getsize(path + ".shard0") >= 1 << 20
    pt = (Stage1 if stage == 1 else Stage2)(cfg, device="cpu")
    pt.maybe_init({"tr_points": _rand((B, N, 3), 8)})
    pt.resume(epoch=1, strict=True)
    _assert_equal(pt.state_tree(), jax_run["start"])
    assert (pt.epoch, pt.itr, pt._itr_epoch_start) == (2, 1, 1)
    assert pt.current_lr() == jax_run["lr"]
    start = {k: p.detach().clone() for k, p in pt.state.params.items()}
    if stage == 1:
        got = pt.update({"tr_points": STEP["pts"]},
                        noise=[_t(e) for e in STEP["noise"]])
        tol = STEP_TOL
    else:
        got = (pt.update({"tr_points": STEP["pts"]},
                         t_idx=torch.from_numpy(STEP["idx"]),
                         eta=_t(STEP["eta"]),
                         enc_noise=[_t(e) for e in STEP["noise"]]),)
        tol = F32_TOL
    for g, w in zip(got, jax_run["out"]):
        np.testing.assert_allclose(g.item(), float(w), **tol)
    want = jax_run["after"]["state" if stage == 1 else "score"]
    st = pt.state
    got_p, want_p = dict(st.params), dict(want["params"])
    if stage == 1:
        # coordinates with no exact gradient (test_torch_port_stage1's
        # NULL_GRAD) move by rounding noise times lr on both: held to that
        init = _split_null(start)
        for null in (_split_null(got_p), _split_null(want_p)):
            for k, p in null.items():
                assert (p - init[k]).abs().max() <= jax_run["lr"] * (
                    1 + 1e-5), k
        _assert_close(st.batch_stats, want["batch_stats"])
    else:
        _assert_close(st.ema_params, want["ema_params"])
    _assert_close(got_p, want_p, **tol)
    _assert_close(st.opt_state.mu, want["opt_state"]["mu"], **tol)
    _assert_close(st.opt_state.nu, want["opt_state"]["nu"],
                  **(dict(rtol=2e-4, atol=1e-12) if stage == 1
                     else dict(rtol=1e-5, atol=1e-9)))
    assert st.step == st.opt_state.count == 2


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_port_state_as_jax_checkpoint_restores_strictly(tmp_path, jax_run,
                                                        sharded):
    """The port's trainer state written in the JAX format: the JAX
    package's `load_checkpoint` + `restore_into(strict=True)` into the JAX
    trainer's template gives the port's leaves."""
    stage, jt = jax_run["stage"], jax_run["jt"]
    cfg = torch_ns(copy.deepcopy(jax_run["cfg"]))
    pt = (Stage1 if stage == 1 else Stage2)(cfg, device="cpu")
    pt.update({"tr_points": _rand((B, N, 3), 8)})
    path = str(tmp_path / "port.msgpack")
    jc.save_jax_checkpoint(path, pt.state_tree(), pt.tx, cfg=cfg,
                           epoch=pt.epoch, itr=pt.itr, time=1.25,
                           shard_threshold=1 if sharded
                           else jc.DEFAULT_SHARD_THRESHOLD)
    assert os.path.exists(path + ".shard0") == sharded
    ckpt = jckpt.load_checkpoint(path)
    assert (ckpt["epoch"], ckpt["itr"], ckpt["time"]) == (1, 1, 1.25)
    restored = jckpt.restore_into(_jax_tree(stage, jt), ckpt["state"],
                                  strict=True)
    _assert_equal(_port_tree(stage, restored), pt.state_tree())


def test_state_round_trips_through_the_jax_layout():
    """Port -> JAX -> port is the identity, for an optax chain with weight
    decay and without the clip (the Adam entry found by its keys)."""
    params = dict(Score(torch_ns(dict(SMALL_SCORE)), device="cpu")
                  .state_dict())
    tx = make_optimizer(weight_decay=0.01, grad_clip=None)
    ts = {"step": 3, "params": params,
          "ema_params": {k: v + 1 for k, v in params.items()},
          "opt_state": {"count": 3, "mu": {k: v * 2 for k, v in
                                           params.items()},
                        "nu": {k: v * v for k, v in params.items()}},
          "batch_stats": None}
    jax_state = jc.state_to_jax({"score": ts}, tx)
    chain = jax_state["score"]["opt_state"]
    assert list(chain) == ["0", "1"] and chain["0"] == {}
    assert set(chain["1"]) == {"count", "mu", "nu"}
    back = jc.state_from_jax(jc.unpackb(jc.packb(jax_state)))
    _assert_equal(back, {"score": ts})
    chain["0"] = {"x": np.ones(2, np.float32)}  # an unknown optimizer state
    with pytest.raises(ValueError, match="Adam"):
        jc.state_from_jax(jax_state)


def test_a_leaf_that_maps_to_nothing_raises_both_ways():
    score = dict(Score(torch_ns(dict(SMALL_SCORE)), device="cpu")
                 .state_dict())
    comp = dict(Compressor(torch_ns(dict(SMALL_COMPRESSOR)), device="cpu")
                .state_dict())
    with pytest.raises(ValueError, match="unmapped"):
        compressor_variables({**comp, "stray.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="unmapped"):
        score_params({**score, "transformer.0.attn.extra": torch.zeros(2)})
    v = compressor_variables(comp)
    v["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unmapped"):
        compressor_state_dict(v)
    p = score_params(score)
    p["transformer_0"]["stray"] = {"bias": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="unmapped"):
        score_state_dict(p)


# ------------------------------------------------------- the msgpack codec

def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {"dense": {"kernel": rng.standard_normal((3, 5)).astype(
            np.float32), "bias": rng.standard_normal(5).astype(np.float32)},
            "z": {}},
        "step": np.asarray(int(rng.integers(0, 1 << 20)), np.int32),
        "count": np.int32(rng.integers(0, 100)),
        "mu": np.asarray(rng.standard_normal(7), jnp.bfloat16),
        "opt_state": {"0": {}, "1": {"count": np.asarray(5, np.int32)}},
        "ema_params": None, "flag": bool(seed % 2), "lr": float(seed) / 7,
        "ints": [0, 127, 128, -32, -33, 255, 256, 65536, -129, -40000,
                 1 << 33, -(1 << 33), int(rng.integers(-1000, 1000))],
        "cfg": {"log": {"trainformat": [None, "{:.4f}"]}, "name": "x" * 40,
                "long": "y" * 300, "many": {str(i): i for i in range(20)}},
        "f64": rng.standard_normal((2, 2)),
        "empty": np.zeros((0, 3), np.float32),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_bytes_equal_flax(seed):
    tree = _random_tree(seed)
    data = msgpack_serialize(tree)
    assert jc.packb(tree) == data
    back = jc.unpackb(data)
    assert back["step"].dtype == torch.int32
    assert int(back["step"]) == int(tree["step"])
    assert back["mu"].dtype == torch.bfloat16
    assert torch.equal(back["mu"].float(), _t(tree["mu"]))
    assert torch.equal(back["params"]["dense"]["kernel"],
                       _t(tree["params"]["dense"]["kernel"]))
    assert back["params"]["z"] == {} and back["ema_params"] is None
    assert back["ints"] == tree["ints"] and back["cfg"] == tree["cfg"]
    # tensors encode as the numpy arrays they equal
    as_tensors = {"w": _t(tree["params"]["dense"]["kernel"]),
                  "m": torch.from_numpy(np.asarray(tree["mu"], np.float32)
                                        ).bfloat16()}
    assert jc.packb(as_tensors) == msgpack_serialize(
        {"w": tree["params"]["dense"]["kernel"], "m": tree["mu"]})


def test_codec_chunks_as_flax(monkeypatch):
    """flax splits arrays over 2**30 bytes into chunks; with the limit
    lowered on both sides the bytes agree and the chunks join back."""
    import flax.serialization as fser

    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(jc, "_MAX_CHUNK_SIZE", 64)
    tree = {"w": _rand((100,), 0), "x": {"y": _rand((5, 9), 1)}}
    data = msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert jc.packb(tree) == data
    back = jc.unpackb(data)
    assert torch.equal(back["x"]["y"], _t(tree["x"]["y"]))
    assert torch.equal(back["w"], _t(tree["w"]))
