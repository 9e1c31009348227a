"""The completion entries (`ldt_torch.entries.train_completion_compressor`,
`train_completion_latent_diffusion`) end to end on the CPU against the JAX
package's (`train_Completion_Compressor.py`,
`train_Completion_Latent_Diffusion.py`), chained as a user runs them: stage
1 from a stage-1 checkpoint (one JAX `.msgpack`, read by both), 2 epochs
with saves and reconstructions, a resume leg; stage 2 from each package's
own stage-1 checkpoint, 2 epochs with saves, a resume leg. A tiny config
on a synthetic ViPC tree (`ldt_torch.tools.synth_vipc`, RGBA views that the
loaders resize), no worker threads.

Both chains see the same data (the same shuffles; each item's own view,
see `pinned`) and the same draws: the reparameterization noise pinned to 0
(the posterior means) on both sides, stage 2's t and eta the JAX step's,
its Score starting from the JAX run's initial weights; the auction EMD of
stage 1's loss is left out on both sides (a discrete assignment, held by
test_torch_port_stage1).

Limits: stage 1's logged losses, its reconstructions and scores within
1e-3 relative over its 8 steps (f32 Adam steps: rounding differences grow
with them); stage 2's first step loss within 1e-4 relative. Past that
step the JAX run departs: its jitted conditional step takes other
ConditionNet gradients than the same computation run eagerly in JAX,
which the port's agree with (and the port's f64 ones, to 3e-7:
tests/test_torch_port_condition.py), so stage 2's later losses are held
finite only. The logs' rows, the counters, the checkpoints on disk and the
conditional checkpoint's contents (params and BatchNorm statistics by
name, the step) exactly."""

import csv
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import ldt_tpu.data.vipc as jvipc
import ldt_tpu.models.compressor as jcm
import ldt_tpu.training.completion_latent_sde_trainer as jclt
import ldt_tpu.training.compressor_trainer as jct
import ldt_torch.models.compressor as tcm
import ldt_torch.training.compressor_trainer as tct
import train_Completion_Compressor as jentry1
import train_Completion_Latent_Diffusion as jentry2
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_tpu.training.completion_compressor_trainer import (
    Trainer as JaxStage1,
)
from ldt_torch import weights
from ldt_torch.cli import get_completion_config, get_parser
from ldt_torch.data import vipc
from ldt_torch.entries import train_completion_compressor as entry1
from ldt_torch.entries import train_completion_latent_diffusion as entry2
from ldt_torch.tools import synth_vipc
from ldt_torch.training.checkpoint import load_checkpoint, wait_pending_saves
from ldt_torch.training.completion_compressor_trainer import fps_to
from ldt_torch.training.completion_latent_sde_trainer import Trainer as Stage2
from test_torch_port_common import SMALL_COMPRESSOR, SMALL_SCORE

N = SMALL_COMPRESSOR["outsize"]
STAGE1, STAGE2 = "Compressor_Trainer", "Latent_Diffusion_Trainer"
REL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny models on one intra-op thread (the other test workers are
    busy)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("vipc")
    synth_vipc.write_tree(str(out), train=4, test=2, views=24,
                          gt_points=96, part_points=40, lists_dir=str(out),
                          view_size=20, view_mode="RGBA")
    return out


def _cfg(save_root, tree, trainer, pretrain, epochs):
    stage1 = trainer == STAGE1
    d = dict(
        data=dict(type="ldt_tpu.data.vipc", train_cate="plane",
                  test_cate="plane", train_preload=False, test_preload=False,
                  data_dir=str(tree), train_list=str(tree / "train_list2.txt"),
                  test_list=str(tree / "test_list2.txt"),
                  tr_max_sample_points=N, te_max_sample_points=N,
                  batch_size=2, test_batch_size=2, num_categorys=1,
                  num_workers=0),
        opt=dict(adj_lr="warm_up", warmup_iters=2, lr=1e-3, beta1=0.9,
                 beta2=0.999, ema_decay=0.99, weight_decay=0.0,
                 grad_norm_clip_value=1.0, kl_weight=1e-3, loss_type="l2",
                 discrete=True),
        log=dict(save_epoch_freq=2, save_path=str(
            save_root / trainer / "completion" / "plane"), log_epoch_freq=1,
            eval_epoch_freq=2 if stage1 else 100,
            traincolumns=(["epoch", "itr", "loss", "kl_loss", "rec_loss",
                           "max_feature", "time"] if stage1
                          else ["epoch", "itr", "loss", "time"]),
            trainformat=([None, None] + ["{:.4f}"] * 4 + ["{:.0f}"]
                         if stage1 else [None, None, "{:.4f}", "{:.0f}"]),
            evalcolumns=["epoch", "cd", "f1score"],
            evalformat=[None, "{:.8f}", "{:.8f}"]),
        common=dict(epochs=epochs, num_points=N, seed=0),
        model=dict(SMALL_COMPRESSOR, pretrain_path=pretrain),
        compressor=dict(SMALL_COMPRESSOR, pretrain_path=pretrain),
        score=dict(SMALL_SCORE, num_blocks=2, condition=True),
        sde=dict(beta_start=0.1, beta_end=20.0, sde_type="vpsde",
                 sigma2_0=0.0, iw_sample_p_mode="drop_all_iw",
                 iw_sample_q_mode="drop_all_iw", time_eps=0.01, ode_tol=1e-4,
                 sample_time_eps=1e-6, sample_mode="discrete",
                 predictor="ancestral", corrector=None, train_N=1000,
                 sample_N=64, snr=0.01, corrector_steps=1, denoise=True,
                 probability_flow=False, alpha=1.0))
    path = save_root / trainer / "completion" / "plane"
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.yaml", "w") as f:
        yaml.safe_dump(d, f)
    return d


def _jax_args(save, kind, resume=False):
    return jax_ns(dict(dataset="plane", trainer_type=kind, save=str(save),
                       resume=resume, resume_epoch=None,
                       load_optimizer=True, evaluate=False, strict=True,
                       finetune=False))


def _seed_checkpoint(tmp_path, tree):
    """A JAX stage-1 checkpoint (`checkpt_0.msgpack`) of the tiny
    Compressor, the pretrain both chains start from."""
    d = _cfg(tmp_path / "seed", tree, STAGE1, None, 2)
    d["log"] = dict(d["log"], save_path=str(tmp_path / "seed"))
    cfg = jax_ns(d)
    tr = JaxStage1(cfg, JaxCompressor(cfg.model), rng=jax.random.key(7))
    # ActNorm from the tree's own GT clouds: on clouds far from its init
    # batch the tiny Compressor's max feature passes the watchdog's 10000
    items = vipc.ViPCDataLoader(str(tree / "train_list2.txt"), str(tree),
                                "train", view_align=True)
    pc = fps_to(np.stack([items[i]["pc"] for i in range(2)]), N).numpy()
    tr.maybe_init({"tr_points": pc, "cate_idx": np.zeros(2, np.int32)})
    tr.epoch = 0
    tr.save()
    return str(tmp_path / "seed" / "checkpt_0.msgpack")


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _run_port(ws, kind, entry, *extra):
    a = get_parser(kind).parse_args(["--save", str(ws), "--dataset",
                                     "plane", "--device", "cpu", *extra])
    return entry.main(a, get_completion_config(a))


@pytest.fixture
def pinned(monkeypatch):
    """Both packages' reparameterization at the posterior means, stage 1's
    EMD left out, each item's own view; the port's stage-2 Score started
    from the JAX run's initial weights, with the JAX step's draws. Returns
    both packages' stage-2 step losses, as they come."""
    monkeypatch.setattr(jcm, "reparameterize", lambda rng, mu, logvar: mu)
    monkeypatch.setattr(tcm, "reparameterize", lambda mu, logvar, noise: mu)
    monkeypatch.setattr(jct, "EMD_loss", lambda s, q: 0.0)
    monkeypatch.setattr(tct, "EMD_loss", lambda s, q: 0.0)
    # each item's own view: the random one is drawn from Python's global
    # `random` on the loaders' threads, and the JAX loader's iterator that
    # `next(iter(loader))` abandons keeps drawing while the next epoch's
    # starts (thread timing decides the order)
    for module in (jvipc, vipc):
        real = module.ViPCDataLoader.__init__

        def aligned(self, *a, _real=real, **kw):
            _real(self, *a, **dict(kw, view_align=True))

        monkeypatch.setattr(module.ViPCDataLoader, "__init__", aligned)
    jax_init, losses = {}, {"jax": [], "port": []}
    real_init = jclt.Trainer.maybe_init
    real_jax_update = jclt.Trainer.update

    def jax_maybe_init(self, batch):
        fresh = self.state is None
        real_init(self, batch)
        if fresh:
            jax_init["base"] = self._base_key
            jax_init["weights"] = weights.score_state_dict(
                *jax.tree_util.tree_map(np.array, (self.state.params,
                                                   self.state.batch_stats)))

    def jax_update(self, data, condition=None):
        out = real_jax_update(self, data, condition)
        losses["jax"].append(float(out))
        return out

    monkeypatch.setattr(jclt.Trainer, "maybe_init", jax_maybe_init)
    monkeypatch.setattr(jclt.Trainer, "update", jax_update)
    real_port_init = Stage2.maybe_init
    real_update = Stage2.update

    def port_init(self, batch, score_weights=None, compressor_weights=None):
        real_port_init(self, batch, jax_init["weights"], compressor_weights)

    def port_update(self, data, condition=None, **kw):
        rng = jax.random.fold_in(jax_init["base"], self.state.step)
        _, k_t, k_eta = jax.random.split(rng, 3)
        shape = (data.shape[0], self.cfg.score.z_scale,
                 self.cfg.score.z_dim)
        idx = jax.random.randint(k_t, (shape[0],), 0, self.N)
        eta = jax.random.normal(k_eta, shape)
        out = real_update(self, data, condition, t_idx=torch.from_numpy(
            np.asarray(idx).astype(np.int64)), eta=torch.from_numpy(
            np.array(eta)))
        losses["port"].append(out.item())
        return out

    monkeypatch.setattr(Stage2, "maybe_init", port_init)
    monkeypatch.setattr(Stage2, "update", port_update)
    return losses


def _close_rows(got, want, skip=("time",)):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in skip:
                continue
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=REL,
                                       atol=1e-6, err_msg=k)


def test_completion_entries_chain_and_resume_as_the_jax_entries(
        tmp_path, tree, pinned):
    """Both packages' entries, stage 1 then stage 2, each with a resume
    leg; see the module docstring for what is held to what."""
    seed = _seed_checkpoint(tmp_path, tree)
    runs = {}
    for pkg in ("jax", "port"):
        ws = tmp_path / pkg
        s1 = ws / STAGE1 / "completion" / "plane"
        ext = "msgpack" if pkg == "jax" else "pt"
        pretrain = {STAGE1: seed, STAGE2: str(s1 / f"checkpt_2.{ext}")}
        # the resume legs: stage 1's loop runs while epoch < epochs (the
        # reference's), so its leg asks for 4 and trains epochs 3 and 4;
        # stage 2's trains epoch 3
        for kind, jentry, entry, epochs in ((STAGE1, jentry1, entry1, 4),
                                            (STAGE2, jentry2, entry2, 3)):
            for resume in (False, True):
                _cfg(ws, tree, kind, pretrain[kind], epochs if resume else 2)
                if pkg == "jax":
                    a = _jax_args(ws, kind, resume)
                    jentry.main(a, jentry.get_completion_config(a))
                else:
                    out = _run_port(ws, kind, entry,
                                    *(["--resume", "True"] * resume))
                    assert out.epoch == (epochs + 1 if resume else 3)
        wait_pending_saves()
        runs[pkg] = ws

    def rows_key(rows):
        return [(r["epoch"], r.get("itr")) for r in rows]

    for kind, files in ((STAGE1, ("training.csv", "eval.csv")),
                        (STAGE2, ("training.csv",))):
        jdir = runs["jax"] / kind / "completion" / "plane"
        tdir = runs["port"] / kind / "completion" / "plane"
        for name in files:
            got, want = _rows(tdir / name), _rows(jdir / name)
            assert rows_key(got) == rows_key(want)
            assert all(np.isfinite(float(v)) for r in got
                       for v in r.values())
            if kind == STAGE1:
                _close_rows(got, want)
        # the saves, every second epoch, in each package's format
        saves = [2, 4] if kind == STAGE1 else [2]
        assert sorted(f for f in os.listdir(tdir) if "checkpt" in f) == [
            f"checkpt_{e}.pt" for e in saves]
        assert sorted(f for f in os.listdir(jdir) if "checkpt" in f
                      and "shard" not in f) == [
            f"checkpt_{e}.msgpack" for e in saves]
    # the reconstructions of both evaluations (named by the epoch counter
    # after the evaluated epoch's end)
    tdir, jdir = (runs[k] / STAGE1 / "completion" / "plane"
                  for k in ("port", "jax"))
    names = sorted(f for f in os.listdir(jdir) if f.startswith("rec_ep"))
    assert names == sorted(f for f in os.listdir(tdir)
                           if f.startswith("rec_ep")) and len(names) == 2
    for name in names:
        rec, jrec = np.load(tdir / name), np.load(jdir / name)
        err = np.abs(rec - jrec).max()
        assert rec.shape == (2, N, 3) and err <= REL * np.abs(jrec).max(), \
            (name, err)
    # stage 2: 2 + 2 steps, then the leg's 2; the first step's loss
    assert len(pinned["jax"]) == len(pinned["port"]) == 6
    np.testing.assert_allclose(pinned["port"][0], pinned["jax"][0],
                               rtol=1e-4)
    # stage 2's checkpoints: the conditional Score's params and BatchNorm
    # statistics under the same names, the same step
    port = load_checkpoint(str(runs["port"] / STAGE2 / "completion" /
                               "plane" / "checkpt_2.pt"))["state"]["score"]
    jaxs = load_checkpoint(str(runs["jax"] / STAGE2 / "completion" /
                               "plane" / "checkpt_2.msgpack"))["state"]["score"]
    assert port["batch_stats"] and set(port["batch_stats"]) == set(
        jaxs["batch_stats"])
    assert set(port["params"]) == set(jaxs["params"])
    assert port["step"] == jaxs["step"] == 4
