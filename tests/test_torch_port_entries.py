"""The port's entries (`ldt_torch.entries`) end to end on the CPU, on a fake
PC15k tree with tiny configs (tests/test_entries.py's pattern): stage 1 from
a config file, stage 2 bootstrapped from its checkpoint (the port's `.pt`,
and a JAX stage-1 `.msgpack`), a resume leg, `--evaluate`, the divergence
watchdog's rollback and its refusal without a checkpoint, mixed
precision through both entries, and `val_sample` against the JAX
package's."""

import copy
import csv
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import val_sample as jax_val_sample
from ldt_tpu.models import Compressor as JaxCompressor
from ldt_tpu.tools.io import dict2namespace as jax_ns
from ldt_tpu.training import compressor_trainer as jct
from ldt_torch.cli import get_config, get_parser
from ldt_torch.entries import train_compressor, train_latent_diffusion
from ldt_torch.entries import val_sample
from ldt_torch.tools.io import dict2namespace
from ldt_torch.training.checkpoint import load_checkpoint, wait_pending_saves
from ldt_torch.weights import compressor_state_dict
from test_torch_port_checkpoint import SDE_LOG, TRAIN_LOG, run_cfg

N_PTS = 64
STAGE1, STAGE2 = "Compressor_Trainer", "Latent_Diffusion_Trainer"


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny models on one intra-op thread: with the other test workers
    busy, torch's thread pool waits far longer than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("PC15k")
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        d = root / "02691156" / split
        d.mkdir(parents=True)
        for i in range(3):
            np.save(d / f"m{i}.npy", rng.randn(15000, 3).astype(np.float32))
    return root


def _cfg(ws, tree, trainer, **log):
    d = run_cfg(ws / trainer / "airplane",
                log=dict(TRAIN_LOG if trainer == STAGE1 else SDE_LOG),
                data_dir=tree, points=N_PTS, batch=2)
    d["common"]["epochs"] = 2
    d["log"].update(log)
    d["sde"]["train_N"] = 8  # sample_N 64 keeps beta_end / N < 1
    # every epoch the same 3 clouds at a small rate: on other random clouds
    # than ActNorm's init batch the tiny Compressor's max feature passes
    # 10000 (the JAX package's too) and the watchdog rolls the run back
    d["data"]["batch_size"] = 3
    d["opt"]["lr"] = 1e-5
    return d


def _write(ws, trainer, d):
    path = ws / trainer / "airplane"
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.yaml", "w") as f:
        yaml.safe_dump(d, f)


def _args(ws, trainer, *extra):
    return get_parser(trainer).parse_args(
        ["--save", str(ws), "--device", "cpu", *extra])


def _rows(save_path, name="training.csv"):
    with open(os.path.join(save_path, name), newline="") as f:
        return list(csv.DictReader(f))


def test_stage1_stage2_resume_and_evaluate(tmp_path, tree, monkeypatch):
    """Stage 1 from its config file (through its `__main__`, as `python -m`
    runs it), stage 2 through `load_pretrain` from stage 1's checkpoint, a
    resume leg that trains one more epoch, and `--evaluate`."""
    ws = tmp_path / "experiments"
    d1 = _cfg(ws, tree, STAGE1, eval_epoch_freq=2)
    _write(ws, STAGE1, d1)
    monkeypatch.setattr(sys, "argv", [
        "train_compressor", "--save", str(ws), "--device", "cpu"])
    runpy.run_path(train_compressor.__file__, run_name="__main__")
    save1 = d1["log"]["save_path"]
    assert [r["epoch"] for r in _rows(save1)] == ["1", "2"]
    assert [r["epoch"] for r in _rows(save1, "eval.csv")] == ["2"]
    stage1 = load_checkpoint(os.path.join(save1, "checkpt_2.pt"))
    assert stage1["epoch"] == 2 and stage1["itr"] == 2
    assert all(float(r["max_feature"]) < 10000 for r in _rows(save1))

    d2 = _cfg(ws, tree, STAGE2, eval_epoch_freq=2)
    d2["compressor"]["pretrain_path"] = os.path.join(save1, "checkpt_2.pt")
    _write(ws, STAGE2, d2)
    args = _args(ws, STAGE2)
    trainer = train_latent_diffusion.main(args, get_config(args))
    comp = trainer.compressor.state_dict()
    for k, v in {**stage1["state"]["state"]["params"],
                 **stage1["state"]["state"]["batch_stats"]}.items():
        assert torch.equal(comp[k], v), k
    wait_pending_saves()
    save2 = d2["log"]["save_path"]
    assert os.path.exists(os.path.join(save2, "smp_ep3.npy"))
    assert [r["epoch"] for r in _rows(save2)] == ["1", "2"]
    assert len(_rows(save2, "eval.csv")) == 1
    assert all(np.isfinite(float(r["loss"])) for r in _rows(save2))

    d2["common"]["epochs"] = 3
    _write(ws, STAGE2, d2)
    args = _args(ws, STAGE2, "--resume", "True")
    resumed = train_latent_diffusion.main(args, get_config(args))
    assert (resumed.epoch, resumed.itr) == (4, 3)
    assert [r["epoch"] for r in _rows(save2)] == ["1", "2", "3"]

    args = _args(ws, STAGE2, "--resume", "True", "--resume_epoch", "2",
                 "--evaluate", "True")
    evaluated = train_latent_diffusion.main(args, get_config(args))
    assert evaluated.epoch == 3
    assert [r["epoch"] for r in _rows(save2, "eval.csv")] == ["2", "2"]


def test_a_jax_stage1_checkpoint_bootstraps_stage2(tmp_path, tree):
    ws = tmp_path / "experiments"
    d1 = _cfg(ws, tree, STAGE1)
    jcfg = jax_ns(copy.deepcopy(d1))
    jt = jct.Trainer(jcfg, JaxCompressor(jcfg.model))
    jt.maybe_init({"tr_points": np.random.default_rng(0).standard_normal(
        (2, N_PTS, 3)).astype(np.float32)})
    jt.save()
    d2 = _cfg(ws, tree, STAGE2, eval_epoch_freq=1000)
    d2["compressor"]["pretrain_path"] = os.path.join(
        d1["log"]["save_path"], "checkpt_1.msgpack")
    trainer = train_latent_diffusion.main(_args(ws, STAGE2),
                                          dict2namespace(d2))
    want = compressor_state_dict(jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    got = trainer.compressor.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("nan_epoch,saved", [(6, True), (1, False)])
def test_the_divergence_watchdog(tmp_path, tree, monkeypatch, nan_epoch,
                                 saved):
    """A NaN loss in epoch 6 of a run saving every 5 epochs rolls back to
    epoch 5's checkpoint with the learning rate halved, and the run goes on;
    one in epoch 1, before any checkpoint, raises."""
    ws = tmp_path / "experiments"
    d = _cfg(ws, tree, STAGE1, save_epoch_freq=5)
    d["common"]["epochs"] = 7
    cfg = dict2namespace(d)
    real_update = train_compressor.Trainer.update
    real_resume = train_compressor.Trainer.resume
    seen = {}

    def update(self, data, **kw):
        out = real_update(self, data, **kw)
        if self.epoch == nan_epoch and "nan" not in seen:
            seen["nan"] = self.epoch
            out = (torch.tensor(float("nan")),) + out[1:]
        return out

    def resume(self, epoch=None, **kw):
        real_resume(self, epoch=epoch, **kw)
        seen["resumed"] = (epoch, copy.deepcopy(self.state_tree()),
                           self.epoch, self.base_lr)

    monkeypatch.setattr(train_compressor.Trainer, "update", update)
    monkeypatch.setattr(train_compressor.Trainer, "resume", resume)
    if not saved:
        with pytest.raises(RuntimeError, match="nothing to roll back to"):
            train_compressor.main(_args(ws, STAGE1), cfg)
        return
    trainer = train_compressor.main(_args(ws, STAGE1), cfg)
    epoch, state, at, lr = seen["resumed"]
    assert epoch == 5 and at == 6 and lr == d["opt"]["lr"]  # then halved
    ckpt = load_checkpoint(os.path.join(d["log"]["save_path"],
                                        "checkpt_5.pt"))
    for k, v in ckpt["state"]["state"]["params"].items():
        assert torch.equal(state["state"]["params"][k], v), k
    assert trainer.epoch == 8 and trainer.base_lr == d["opt"]["lr"] / 2
    # epochs 1-6 logged, 6 again after the rollback, then 7
    assert [r["epoch"] for r in _rows(d["log"]["save_path"])] == [
        "1", "2", "3", "4", "5", "6", "6", "7"]


@pytest.mark.parametrize("entry", [train_compressor, train_latent_diffusion])
def test_mixed_precision_is_refused(tmp_path, tree, entry):
    """`common.train_dtype: bfloat16` trains through the entry (the nets
    compute in bf16 over f32 parameters and moments; stage 2 from a
    random frozen Compressor); a name that is no train dtype is still
    refused."""
    ws = tmp_path / "experiments"
    trainer = STAGE1 if entry is train_compressor else STAGE2
    d = _cfg(ws, tree, trainer)
    d["common"].update(train_dtype="bfloat16", epochs=2)
    if entry is train_latent_diffusion:
        d["log"]["save_epoch_freq"] = 1000

        class Bootstrap(train_latent_diffusion.Trainer):
            def load_pretrain(self):  # a random frozen Compressor
                pass

        real = entry.Trainer
        entry.Trainer = Bootstrap
    try:
        tr = entry.main(_args(ws, trainer), dict2namespace(d))
    finally:
        if entry is train_latent_diffusion:
            entry.Trainer = real
    assert tr.dtype == torch.bfloat16 and tr.itr == 2
    net = tr.model if entry is train_compressor else tr.score
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(m.dtype == torch.float32
               for m in tr.state.opt_state.mu.values())
    assert all(np.isfinite(float(r["loss"]))
               for r in _rows(d["log"]["save_path"]))
    d["common"]["train_dtype"] = "f16"
    with pytest.raises(ValueError, match="train_dtype"):
        entry.main(_args(ws, trainer), dict2namespace(d))


@pytest.mark.parametrize("norm", [False, True])
def test_val_sample_matches_the_jax_entry(tmp_path, tree, monkeypatch, norm):
    """The same samples (the test split jittered) scored by both entries:
    the same val.txt keys, the nearest-neighbour metrics equal, the rest
    within test_torch_port_metrics' chamfer tolerance."""
    from test_torch_port_metrics import CD_TOL

    monkeypatch.chdir(tmp_path)
    data = dict(run_cfg(tmp_path, data_dir=tree, points=N_PTS,
                        batch=2)["data"])
    os.makedirs("test/smp/airplane")
    with open("test/val_config.yaml", "w") as f:
        yaml.safe_dump({"data": data}, f)
    from ldt_torch.data import get_data_loaders

    refs = np.concatenate([b["te_points"] for b in get_data_loaders(
        dict2namespace(data), {})["test_loader"]])
    rng = np.random.default_rng(0)
    np.save("test/smp/airplane/gen.npy",
            refs + 0.01 * rng.standard_normal(refs.shape).astype(np.float32))
    args = val_sample.get_parser().parse_args(
        ["--sample", "gen.npy", "--dataset", "airplane", "--norm", str(norm),
         "--device", "cpu"])
    want = jax_val_sample.main(args, jax_ns({"data": copy.deepcopy(data)}))
    got = val_sample.main(args, val_sample.get_config())
    assert set(got) == set(want)
    for k, v in want.items():
        if "cov" in k or "acc" in k:
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **CD_TOL)
    lines = open("val.txt").read().splitlines()
    assert lines[0] == lines[len(lines) // 2] == "airplane:gen.npy"
    assert len(lines) == 2 * (1 + len(want))
