"""The stage-3 entry (`python -m ldt_torch.entries.train_hybrid`) end to
end on the CPU, on a fake PC15k tree with tiny configs: bootstrapped
through `load_pretrain` from a stage-2 dual checkpoint in the JAX
package's `.msgpack` format, two epochs with saves and a `valsample`, the
CSV schema (epoch, itr, loss_score, kl, rec, time), a `--resume` leg that
trains the third epoch, and `--evaluate`."""

import copy
import os
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml

from ldt_torch.cli import get_config
from ldt_torch.configs import dict2namespace
from ldt_torch.entries import train_hybrid
from ldt_torch.training.checkpoint import load_checkpoint, wait_pending_saves
from ldt_torch.training.hybrid_trainer import Trainer
from ldt_torch.training.jax_checkpoint import save_jax_checkpoint
from ldt_torch.training.latent_sde_trainer import Trainer as Stage2
from test_torch_port_entries import _args, _cfg, _rows, one_thread, tree  # noqa: F401
from test_torch_port_hybrid import HYB_LOG

HYBRID, STAGE2 = "Hybrid_Trainer", "Latent_Diffusion_Trainer"


def _write(ws, d):
    path = ws / HYBRID / "airplane"
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.yaml", "w") as f:
        yaml.safe_dump(d, f)


def _stage2_msgpack(ws, tree) -> tuple:
    """A stage-2 dual checkpoint of the tiny nets after one step, written
    as the JAX package's `.msgpack`, and its trainer."""
    d = _cfg(ws, tree, STAGE2)
    s2 = Stage2(dict2namespace(copy.deepcopy(d)), device="cpu")
    pts = np.random.default_rng(0).standard_normal((3, 64, 3)).astype(
        np.float32)
    s2.update({"tr_points": pts})
    path = str(ws / "stage2" / "checkpt_4.msgpack")
    os.makedirs(os.path.dirname(path))
    save_jax_checkpoint(path, s2.state_tree(), s2.tx, s2.cfg, epoch=4,
                        itr=1)
    return path, s2


def test_hybrid_entry_bootstrap_resume_and_evaluate(tmp_path, tree,
                                                    monkeypatch):
    ws = tmp_path / "experiments"
    pretrain, s2 = _stage2_msgpack(ws, tree)
    d = _cfg(ws, tree, HYBRID, eval_epoch_freq=2)
    d["log"].update(HYB_LOG)
    d["opt"].update(pretrain_path=pretrain, compressor_beta1=0.9,
                    compressor_beta2=0.999, compressor_warmup=0, alpha=0.1,
                    discrete=False)
    _write(ws, d)
    seen = {}
    real = Trainer.load_pretrain

    def load_pretrain(self):
        real(self)
        seen["score"] = {k: p.detach().clone()
                         for k, p in self.state.params.items()}
        seen["comp"] = {k: t.detach().clone()
                        for k, t in self.compressor.state_dict().items()}

    monkeypatch.setattr(Trainer, "load_pretrain", load_pretrain)
    # through its `__main__`, as `python -m` runs it
    monkeypatch.setattr(sys, "argv", [
        "train_hybrid", "--save", str(ws), "--device", "cpu"])
    runpy.run_path(train_hybrid.__file__, run_name="__main__")
    for k, p in s2.state.params.items():
        assert torch.equal(seen["score"][k], p), k
    for k, t in s2.compressor.state_dict().items():
        assert torch.equal(seen["comp"][k], t), k

    save = d["log"]["save_path"]
    rows = _rows(save)
    assert list(rows[0]) == ["epoch", "itr", "loss_score", "kl", "rec",
                             "time"]
    assert [(r["epoch"], r["itr"]) for r in rows] == [("1", "1"), ("2", "2")]
    assert all(np.isfinite(float(r[k])) for r in rows
               for k in ("loss_score", "kl", "rec"))
    assert [r["epoch"] for r in _rows(save, "eval.csv")] == ["2"]
    assert os.path.exists(os.path.join(save, "smp_ep3.npy"))
    wait_pending_saves()
    ckpt = load_checkpoint(os.path.join(save, "checkpt_2.pt"))
    assert set(ckpt["state"]) == {"score", "compressor_state"}
    assert (ckpt["epoch"], ckpt["itr"]) == (2, 2)
    assert ckpt["state"]["compressor_state"]["ema_params"] is None
    for name in ("score", "compressor_state"):
        moments = ckpt["state"][name]["opt_state"]
        assert all(t.dtype == torch.bfloat16 for k in ("mu", "nu")
                   for t in moments[k].values())

    d["common"]["epochs"] = 3
    _write(ws, d)
    args = _args(ws, HYBRID, "--resume", "True")
    resumed = train_hybrid.main(args, get_config(args))
    assert (resumed.epoch, resumed.itr) == (4, 3)
    assert resumed.comp_state.step == 3  # the saved 2, then one more
    assert [r["epoch"] for r in _rows(save)] == ["1", "2", "3"]

    args = _args(ws, HYBRID, "--resume", "True", "--resume_epoch", "2",
                 "--evaluate", "True")
    evaluated = train_hybrid.main(args, get_config(args))
    assert evaluated.epoch == 3 and evaluated.itr == 2
    assert [r["epoch"] for r in _rows(save, "eval.csv")] == ["2", "2"]


def test_the_entry_trains_from_the_seed_without_a_pretrain_path(tmp_path,
                                                                tree):
    """The shipped airplane config leaves `opt.pretrain_path` empty: the
    entry then trains both nets from the seed, as the JAX entry does."""
    ws = tmp_path / "experiments"
    d = _cfg(ws, tree, HYBRID, eval_epoch_freq=1000)
    d["log"].update(HYB_LOG)
    d["common"]["epochs"] = 1
    d["opt"].update(pretrain_path=None, compressor_beta1=0.9,
                    compressor_beta2=0.999, compressor_warmup=1, alpha=0.1,
                    discrete=True)
    _write(ws, d)
    args = _args(ws, HYBRID)
    trainer = train_hybrid.main(args, get_config(args))
    assert (trainer.epoch, trainer.itr, trainer.kl_discrete) == (2, 1, True)
    assert [r["epoch"] for r in _rows(d["log"]["save_path"])] == ["1"]
    with pytest.raises(ValueError, match="pretrain_path"):
        trainer.load_pretrain()
