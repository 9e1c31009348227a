"""The port's golden-eval harness (`ldt_torch.entries.golden_eval`) against
the repository's `golden_eval.py`, on synthetic stand-ins built as
tests/test_golden_eval.py builds them: a tiny PC15k tree, 'released
samples' (the test clouds jittered) and a val.txt in the reference's format
(INFO:root: prefixes, lgan_ names). The two parsers agree on it; `run`
replays it through the port's `val_sample` on the CPU and exits 0, and 1
once a row is perturbed by 0.05 at the 1% tolerance."""

import os

import numpy as np
import pytest
import yaml

import golden_eval
from ldt_torch.data import get_data_loaders
from ldt_torch.entries import golden_eval as tgolden
from ldt_torch.entries import val_sample
from ldt_torch.tools.io import dict2namespace

N_PTS = 64


@pytest.fixture()
def golden_ws(tmp_path, monkeypatch):
    root = tmp_path
    rng = np.random.RandomState(7)
    data_dir = root / "PC15k"
    for split in ("train", "val"):
        d = data_dir / "02691156" / split
        d.mkdir(parents=True)
        for i in range(4):
            np.save(d / f"m{i}.npy", rng.randn(15000, 3).astype(np.float32))
    cfg = dict(
        data=dict(cates=["airplane"], num_categorys=1,
                  tr_max_sample_points=N_PTS, te_max_sample_points=N_PTS,
                  data_dir=str(data_dir), batch_size=2, test_batch_size=2,
                  boundary=True, num_workers=0))
    os.makedirs(root / "test")
    with open(root / "test" / "val_config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    monkeypatch.chdir(root)
    loaders = get_data_loaders(dict2namespace(cfg).data,
                               dict2namespace(dict(eval_split="val")))
    refs = np.concatenate([b["te_points"] for b in loaders["test_loader"]])
    smp = refs + 0.01 * rng.randn(*refs.shape).astype(np.float32)
    os.makedirs("test/smp/airplane")
    np.save("test/smp/airplane/gen.npy", smp)
    return root


def _write_reference_style_val_txt(path, res):
    """Reference format: INFO:root: prefixes + lgan_ key names."""
    remap = {"mmd-CD": "lgan_mmd-CD", "cov-CD": "lgan_cov-CD",
             "mmd_smp-CD": "lgan_mmd_smp-CD"}
    with open(path, "w") as f:
        f.write("INFO:root:airplane:gen.npy\n")
        f.write("INFO:root:[val/gen/unknown-metric] 1.0\n")
        for k, v in res.items():
            name = k.replace("val/gen/", "")
            name = remap.get(name, name)
            f.write(f"INFO:root:[val/gen/{name}] {v:.8f}\n")
        f.write("INFO:root:chair:empty.npy\n")  # a block with no metric


def _args(ws, *extra):
    return tgolden.get_parser().parse_args(
        ["--val_txt", str(ws / "golden_val.txt"),
         "--config", str(ws / "test" / "val_config.yaml"), "--tol", "0.01",
         "--device", "cpu", *extra])


def _val_txt(ws):
    cfg = dict2namespace(yaml.safe_load(
        open(ws / "test" / "val_config.yaml")))
    res = val_sample.main(dict2namespace(dict(
        sample="gen.npy", dataset="airplane", sample_path="smp", norm=False,
        eval_split="val", device="cpu")), cfg)
    _write_reference_style_val_txt(ws / "golden_val.txt", res)
    return res


def test_the_parsers_agree(golden_ws):
    _val_txt(golden_ws)
    path = str(golden_ws / "golden_val.txt")
    got, want = tgolden.parse_val_txt(path), golden_eval.parse_val_txt(path)
    assert got == want
    assert len(got) == 1 and got[0][:2] == ("airplane", "gen.npy")
    assert set(got[0][2]) == {"mmd-CD", "cov-CD", "mmd_smp-CD",
                              "1-NN-CD-acc_t", "1-NN-CD-acc_f",
                              "1-NN-CD-acc"}
    assert tgolden.KEY_MAP == golden_eval.KEY_MAP
    for val, ref in ((1.0, 1.005), (1.0, 1.02), (0.0, 1e-9), (0.02, 0.0)):
        assert tgolden.within(val, ref, 0.01) == golden_eval.within(
            val, ref, 0.01)


def test_run_reproduces_and_detects(golden_ws, capsys):
    _val_txt(golden_ws)
    assert tgolden.run(_args(golden_ws)) == 0
    assert "6/6 metrics within" in capsys.readouterr().out
    assert tgolden.run(_args(golden_ws, "--datasets", "chair")) == 0
    lines = open(golden_ws / "golden_val.txt").read().splitlines()
    out = []
    for ln in lines:
        if "1-NN-CD-acc]" in ln:
            val = float(ln.rsplit(" ", 1)[1])
            # additive: the metric may legitimately be 0.0 here
            ln = ln.rsplit(" ", 1)[0] + f" {val + 0.05:.8f}"
        out.append(ln)
    open(golden_ws / "golden_val.txt", "w").write("\n".join(out) + "\n")
    assert tgolden.run(_args(golden_ws)) == 1
    assert "[FAIL] airplane/gen.npy 1-NN-CD-acc" in capsys.readouterr().out


def test_run_without_blocks_exits_2(golden_ws):
    (golden_ws / "golden_val.txt").write_text("nothing to read here\n")
    assert tgolden.run(_args(golden_ws)) == 2
