"""Options the port once refused and where it still refuses, and that
`compute_MMD_metrics` hands `emd_otf` on to the EMD matrix. The tests keep
their names from the refusals they replaced: a nonzero dropout rate now
builds (`Score`, `Compressor`) and raises only where the JAX package's
raises (a train-mode forward without masks, any Compressor training), and
bf16 Adam moments (the shipped `airplane_synth_mbf16` config) train, an
unknown moment dtype raising."""

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
    """A Score with dropout 0.1 builds and evaluates as the rate-0 Score on
    the same weights; only a train-mode forward without masks is refused
    (flax raises there for want of a 'dropout' rng)."""
    small = dict(num_blocks=1, hidden_size=32, num_heads=2, t_dim=16)
    score = Score(score_cfg(**small, dropout=0.1), device="cpu")
    zero = Score(score_cfg(**small), device="cpu")  # rate 0: built
    zero.load_state_dict(score.state_dict())
    x, t = torch.randn(2, 32, 120), torch.tensor([0.1, 0.9])
    with torch.no_grad():
        assert torch.equal(score(x, t), zero(x, t))
    with pytest.raises(ValueError, match="dropout"):
        score(x, t, train=True)
    zero(x, t, train=True)


@pytest.mark.parametrize("key", ["encoder_dropout_p", "decoder_dropout_p"])
def test_compressor_refuses_dropout(key):
    """A nonzero rate builds and encodes; its training is refused, as the
    JAX package's Compressor cannot train with dropout; rate 0 trains."""
    small = dict(n_layers=1, hidden_dim=16, p_dim=16, num_heads=2,
                 encoder_layers=1, outsize=64, max_outputs=64)
    comp = Compressor(compressor_cfg(**small, **{key: 0.1}), device="cpu")
    pts = torch.randn(2, 64, 3)
    with torch.no_grad():
        assert torch.isfinite(comp(pts)["set"]).all()
    with pytest.raises(ValueError, match="dropout"):
        comp(pts, train=True)
    Compressor(compressor_cfg(**small, **{key: 0.0}), device="cpu")(
        pts, train=True)


def test_stage2_trainer_refuses_the_shipped_bf16_moments():
    """The shipped mbf16 config's trainer keeps its Adam moments in bf16;
    a moment dtype that is no dtype's name is refused."""
    cfg = dict2namespace(yaml.safe_load(MBF16.read_text()))
    assert cfg.opt.moment_dtype == "bfloat16"
    trainer = latent_sde_trainer.Trainer(cfg, device="cpu")
    assert trainer.tx.moment_dtype == torch.bfloat16
    cfg.opt.moment_dtype = "bf16"  # jnp.dtype refuses it too
    with pytest.raises(ValueError, match="moment_dtype"):
        latent_sde_trainer.Trainer(cfg, device="cpu")


def test_stage1_trainer_refuses_bf16_moments():
    """A stage-1 trainer with bf16 moments takes a step and stores them in
    bf16; an unknown name is refused."""
    small = dict(n_layers=1, hidden_dim=16, p_dim=16, num_heads=2,
                 encoder_layers=1, outsize=64, max_outputs=64, z_scales=8,
                 z_dim=4)
    cfg = compressor_trainer_cfg(model=small,
                                 opt=dict(moment_dtype="bfloat16"))
    trainer = compressor_trainer.Trainer(cfg, device="cpu")
    trainer.update({"tr_points": np.random.default_rng(0).standard_normal(
        (2, 64, 3)).astype(np.float32)})
    assert all(m.dtype == torch.bfloat16
               for m in trainer.state.opt_state.mu.values())
    with pytest.raises(ValueError, match="float8"):
        make_optimizer(moment_dtype="float8")
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
