"""Stage 2: train the latent DiT on the frozen Compressor's latents,
counterpart of `train_Latent_Diffusion.py`.

    python -m ldt_torch.entries.train_latent_diffusion --dataset airplane \
        --save experiments [--resume True] [--evaluate True] [--device cpu]

reads `<save>/Latent_Diffusion_Trainer/<dataset>/config.yaml`. The
Compressor comes from the stage-1 checkpoint `compressor.pretrain_path`
(`Trainer.load_pretrain`), or with `--resume` both nets from the run's own
checkpoint. Each epoch's losses stay on the device and reach the host once,
at its end; training.csv gets a row every `log_epoch_freq` epochs, a
checkpoint is saved every `save_epoch_freq` (`Trainer.epoch_end`), and
every `eval_epoch_freq` epochs `valsample` scores samples of the category
`--val_cate` (else `common.val_cate`, else 0) against the test split, to
eval.csv and a test.csv row. `--evaluate True` only scores.
"""

from __future__ import annotations

from ldt_torch import resolve_device
from ldt_torch.cli import get_config, get_parser, progress
from ldt_torch.data import get_data_loaders
from ldt_torch.tools.utils import (
    AverageMeter,
    common_init,
    sync_epoch_values,
    train_dtype,
)
from ldt_torch.training.latent_sde_trainer import Trainer


def main(args, cfg) -> Trainer:
    """Run stage 2 as `args` and `cfg` say; returns the trainer."""
    device = resolve_device(args.device)
    dtype = train_dtype(cfg)  # the nets' compute dtype
    generator = common_init(cfg.common.seed, device)
    loaders = get_data_loaders(cfg.data, args)
    train_loader = loaders["train_loader"]
    test_loader = loaders["test_loader"]
    trainer = Trainer(cfg, device=device, generator=generator, dtype=dtype)
    trainer.info(vars(args))
    val_cate = args.val_cate if getattr(args, "val_cate", None) is not None \
        else getattr(cfg.common, "val_cate", 0)

    trainer.maybe_init(next(iter(train_loader)))
    if args.resume:
        trainer.resume(epoch=args.resume_epoch, strict=args.strict,
                       load_optim=args.load_optimizer, finetune=args.finetune)
    else:
        trainer.load_pretrain()

    if args.evaluate:
        all_res = trainer.valsample(test_loader=test_loader,
                                    val_cate=val_cate)
        trainer.write_eval(trainer.epoch - 1, all_res)
        return trainer

    loss_meter = AverageMeter()
    for epoch in range(trainer.epoch, cfg.common.epochs + 1):
        losses = [trainer.update(data)
                  for data in progress(train_loader, desc=f"Epoch {epoch}")]
        for loss in sync_epoch_values(losses):
            loss_meter.update(loss)
        trainer.epoch_end()
        if (trainer.epoch - 1) % cfg.log.log_epoch_freq == 0:
            trainer.updata_time()
            trainer.write_log([epoch, trainer.itr, loss_meter.avg,
                               trainer.time], mode="train")
            loss_meter.reset()
        if (trainer.epoch - 1) % cfg.log.eval_epoch_freq == 0:
            all_res = trainer.valsample(test_loader=test_loader,
                                        val_cate=val_cate)
            trainer.info(f"epoch{trainer.epoch - 1}:" + str(all_res))
            try:
                trainer.write_eval(trainer.epoch - 1, all_res)
            except ValueError as e:
                print(f"write log failed: {e}")
            trainer.updata_time()
            trainer.write_log([trainer.epoch, trainer.itr, loss_meter.avg,
                               trainer.time], mode="test")
            loss_meter.reset()
    return trainer


if __name__ == "__main__":
    cli_args = get_parser("Latent_Diffusion_Trainer",
                          "LDT latent diffusion (PyTorch)").parse_args()
    main(cli_args, get_config(cli_args))
