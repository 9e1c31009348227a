"""Options the port has not ported are refused, not silently dropped: a
nonzero dropout rate (`Score`, `Compressor`), Adam moments in another dtype
than float32 (both trainers, as the shipped `airplane_synth_mbf16` config
asks), and `compute_MMD_metrics` hands `emd_otf` on to the EMD matrix."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from ldt_torch.configs import (compressor_cfg, compressor_trainer_cfg,
                               dict2namespace, score_cfg)
from ldt_torch.eval import metrics
from ldt_torch.models import Compressor, Score
from ldt_torch.training import compressor_trainer, latent_sde_trainer
from ldt_torch.training.state import make_optimizer

ROOT = Path(__file__).resolve().parents[1]
MBF16 = ROOT / ("experiments/Latent_Diffusion_Trainer/airplane_synth_mbf16/"
                "config.yaml")


def test_score_refuses_dropout():
    with pytest.raises(NotImplementedError, match="dropout"):
        Score(score_cfg(num_blocks=1, hidden_size=32, num_heads=2, t_dim=16,
                        dropout=0.1), device="cpu")
    Score(score_cfg(num_blocks=1, hidden_size=32, num_heads=2, t_dim=16),
          device="cpu")  # rate 0: built


@pytest.mark.parametrize("key", ["encoder_dropout_p", "decoder_dropout_p"])
def test_compressor_refuses_dropout(key):
    small = dict(n_layers=1, hidden_dim=16, p_dim=16, num_heads=2,
                 encoder_layers=1, outsize=64, max_outputs=64)
    with pytest.raises(NotImplementedError, match="dropout"):
        Compressor(compressor_cfg(**small, **{key: 0.1}), device="cpu")
    Compressor(compressor_cfg(**small, **{key: 0.0}), device="cpu")


def test_stage2_trainer_refuses_the_shipped_bf16_moments():
    cfg = dict2namespace(yaml.safe_load(MBF16.read_text()))
    assert cfg.opt.moment_dtype == "bfloat16"
    with pytest.raises(NotImplementedError, match="moment"):
        latent_sde_trainer.Trainer(cfg, device="cpu")
    cfg.opt.moment_dtype = "float32"
    latent_sde_trainer.Trainer(cfg, device="cpu")


def test_stage1_trainer_refuses_bf16_moments():
    cfg = compressor_trainer_cfg(opt=dict(moment_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="moment"):
        compressor_trainer.Trainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        make_optimizer(moment_dtype="bfloat16")
    compressor_trainer.Trainer(compressor_trainer_cfg(), device="cpu")


@pytest.mark.parametrize("emd_otf", [False, True])
def test_compute_mmd_metrics_passes_emd_otf(emd_otf, monkeypatch):
    seen = {}
    real = metrics.pairwise_EMD_CD

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(metrics, "pairwise_EMD_CD", spy)
    rng = np.random.default_rng(0)
    smp, ref = (rng.standard_normal((3, 64, 3)).astype(np.float32)
                for _ in range(2))
    got = metrics.compute_MMD_metrics(smp, ref, 2, verbose=False,
                                      device="cpu", emd_otf=emd_otf)
    assert seen["emd_otf"] is emd_otf
    assert set(got) == {f"{k}-{m}" for k in ("mmd", "cov", "mmd_smp")
                        for m in ("CD", "EMD")}
    assert all(np.isfinite(v) for v in got.values())
