"""Canonical model/SDE configs, the same defaults as `ldt_tpu/configs.py`.

`score_cfg()` is the 457M-param flagship DiT (24 blocks, hidden 1024, 16
heads, 32 latent tokens x 120 dims); `compressor_cfg()` the 8.06M-param
set-VAE whose decoder turns those latents into 2048-point clouds; `opt_cfg()`
the stage-2 optimizer and `latent_trainer_cfg()` the whole stage-2 config,
the values of `experiments/Latent_Diffusion_Trainer/airplane/config.yaml`;
`compressor_trainer_cfg()` the stage-1 config, the values of
`experiments/Compressor_Trainer/airplane/config.yaml`; `hybrid_trainer_cfg()`
the stage-3 (Hybrid) config, the values of
`experiments/Hybrid_Trainer/airplane/config.yaml` (the entries read those
files with `ldt_torch.tools.io.load_yaml`).
"""

from __future__ import annotations

from ldt_torch.tools.io import dict2namespace  # noqa: F401 (re-export)


def compressor_cfg(**over):
    cfg = dict(
        outsize=2048, max_outputs=2048, input_dim=3, z_dim=20, z_scales=32,
        p_dim=256, n_layers=6, hidden_dim=128, num_heads=4, activation="swish",
        encoder_dropout_p=0.0, decoder_dropout_p=0.0, norm="layer_norm",
        neighbors=128, encoder_layers=2, mlp_ratio=4.0, min_sigma=-30,
        cluster_norm="anchor", norm_input=False, pre_group=False,
        decoder_act=None, ActNorm=True, AdaLN=True, pos_embedding="center",
        class_condition=False, num_categorys=1, pretrain_path=None,
    )
    cfg.update(over)
    return dict2namespace(cfg)


def score_cfg(**over):
    cfg = dict(
        num_steps=1000, z_dim=120, z_scale=32, hidden_size=1024, num_heads=16,
        num_blocks=24, num_categorys=1, c_dim=0.0, t_dim=1024, dropout=0.0,
        norm="layer_norm", learn_sigma=False, act="swish", unet=False,
        AdaLN=True, condition=False,
    )
    cfg.update(over)
    return dict2namespace(cfg)


def sde_cfg(**over):
    cfg = dict(
        beta_start=0.1, beta_end=20.0, sde_type="vpsde", sigma2_0=0.0,
        iw_sample_p_mode="drop_all_iw", iw_sample_q_mode="drop_all_iw",
        time_eps=0.01, ode_tol=1e-5, sample_time_eps=1e-6,
        sample_mode="discrete", predictor="ancestral", corrector=None,
        train_N=1000, sample_N=1000, snr=0.01, corrector_steps=1,
        denoise=True, probability_flow=False, alpha=1.0,
    )
    cfg.update(over)
    return dict2namespace(cfg)


def opt_cfg(**over):
    """The `opt:` section of the stage-2 config (batch 64 is `data:`)."""
    cfg = dict(
        adj_lr="warm_up", warmup_iters=2000, lr=0.0001,
        grad_norm_clip_value=1.0, ema_decay=0.9999, beta1=0.9, beta2=0.999,
        vae_beta1=0.9, vae_beta2=0.999, loss_type="l2", weight_decay=0.0,
        discrete=True,
    )
    cfg.update(over)
    return dict2namespace(cfg)


def latent_trainer_cfg(**sections):
    """The stage-2 config: {score, compressor, sde, opt, common, data}; each
    keyword replaces or updates a section (a dict updates its defaults)."""
    cfg = dict(
        score=vars(score_cfg()), compressor=vars(compressor_cfg()),
        sde=vars(sde_cfg()), opt=vars(opt_cfg()),
        common=dict(epochs=6000, num_points=2048, seed=0),
        data=dict(batch_size=64, tr_max_sample_points=2048,
                  te_max_sample_points=2048, num_categorys=1),
    )
    for name, over in sections.items():
        cfg[name] = {**cfg.get(name, {}), **over}
    return dict2namespace(cfg)


def compressor_trainer_cfg(**sections):
    """The stage-1 config: {model, opt, common, data} (batch 16, lr 1e-3 with
    2000 warm-up iterations, clip 1.0, no weight decay, kl_weight 1e-6, no
    EMA); each keyword replaces or updates a section."""
    cfg = dict(
        model=vars(compressor_cfg()),
        opt=dict(adj_lr="warm_up", warmup_iters=2000, lr=0.001, beta1=0.9,
                 beta2=0.999, ema_decay=0.0, weight_decay=0.0,
                 grad_norm_clip_value=1.0, kl_weight=1e-6),
        common=dict(epochs=8000, num_points=2048, seed=2023),
        data=dict(batch_size=16, test_batch_size=16,
                  tr_max_sample_points=2048, te_max_sample_points=2048,
                  num_categorys=1),
    )
    for name, over in sections.items():
        cfg[name] = {**cfg.get(name, {}), **over}
    return dict2namespace(cfg)


def hybrid_trainer_cfg(**sections):
    """The stage-3 (Hybrid) config: the stage-2 sections, with B=32, 2000
    epochs and the joint finetune's `opt:` (continuous t for the KL term,
    alpha 0.1, 1000 warm-up iterations, the Compressor's own Adam betas and
    KL warm-up epochs); each keyword replaces or updates a section."""
    cfg = dict(
        score=vars(score_cfg()), compressor=vars(compressor_cfg()),
        sde=vars(sde_cfg()),
        opt=dict(pretrain_path=None, adj_lr="warm_up", warmup_iters=1000,
                 lr=0.0001, grad_norm_clip_value=1.0, ema_decay=0.9999,
                 beta1=0.9, beta2=0.999, compressor_beta1=0.9,
                 compressor_beta2=0.999, loss_type="l2", weight_decay=0.0,
                 compressor_warmup=0, discrete=False, alpha=0.1),
        common=dict(epochs=2000, num_points=2048, seed=0),
        data=dict(batch_size=32, test_batch_size=32,
                  tr_max_sample_points=2048, te_max_sample_points=2048,
                  num_categorys=1),
    )
    for name, over in sections.items():
        cfg[name] = {**cfg.get(name, {}), **over}
    return dict2namespace(cfg)
