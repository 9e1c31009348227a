"""Stage 1: train the set-VAE Compressor on PC15k ShapeNet clouds,
counterpart of `train_Compressor.py`.

    python -m ldt_torch.entries.train_compressor --dataset airplane \
        --save experiments [--resume True] [--device cpu]

reads `<save>/Compressor_Trainer/<dataset>/config.yaml`. Each epoch trains
on every batch with running meters (loss, kl, rec, max feature), writes a
training.csv row every `log_epoch_freq` epochs, saves every
`save_epoch_freq` (`Trainer.epoch_end`) and scores the test split's
reconstructions every `eval_epoch_freq` (a multi-category run: those of
the category `--val_cate`, else `common.val_cate`, else 0). A divergence (a
non-finite mean loss, or a mean max feature over 10000) rolls the run back
to the checkpoint of epoch max((epoch - 10) // 10 * 10, save_epoch_freq)
with the learning rate halved, and raises when that checkpoint does not
exist.
"""

from __future__ import annotations

import numpy as np
import torch

from ldt_torch import resolve_device
from ldt_torch.cli import get_config, get_parser, progress
from ldt_torch.data import get_data_loaders
from ldt_torch.tools.utils import AverageMeter, common_init, train_dtype
from ldt_torch.training.checkpoint import checkpoint_file
from ldt_torch.training.compressor_trainer import Trainer


def main(args, cfg) -> Trainer:
    """Run stage 1 as `args` and `cfg` say; returns the trainer."""
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

    if args.resume:
        trainer.maybe_init(next(iter(train_loader)))
        trainer.resume(epoch=args.resume_epoch, finetune=args.finetune,
                       strict=args.strict, load_optim=args.load_optimizer)

    meters = {k: AverageMeter() for k in ("loss", "kl", "rec", "max")}

    def reset_meters():
        for m in meters.values():
            m.reset()

    def diverged():
        return (not np.isfinite(meters["loss"].avg)
                or meters["max"].avg > 10000)

    if args.evaluate:
        trainer.maybe_init(next(iter(train_loader)))
        all_res = trainer.reconstruction(test_loader=test_loader,
                                         val_cate=val_cate)
        trainer.write_eval(trainer.epoch - 1, all_res)
        return trainer

    while trainer.epoch < cfg.common.epochs:
        for epoch in range(trainer.epoch, cfg.common.epochs + 1):
            for data in progress(train_loader, desc=f"Epoch {epoch}"):
                # the watchdog reads the meters every step: one transfer
                values = torch.stack(trainer.update(data)).tolist()
                for meter, v in zip(meters.values(), values):
                    meter.update(v)
                if diverged():
                    break
            if trainer.epoch % cfg.log.log_epoch_freq == 0:
                trainer.updata_time()
                trainer.write_log(
                    [epoch, trainer.itr, meters["loss"].avg,
                     meters["kl"].avg, meters["rec"].avg, meters["max"].avg,
                     trainer.time], mode="train")
            trainer.epoch_end()

            if (trainer.epoch - 1) % cfg.log.eval_epoch_freq == 0:
                all_res = trainer.reconstruction(test_loader=test_loader,
                                                 val_cate=val_cate)
                trainer.info(f"epoch{trainer.epoch - 1}:" + str(all_res))
                try:
                    trainer.write_eval(trainer.epoch - 1, all_res)
                except ValueError as e:
                    print(f"write log failed: {e}")
            if diverged():
                rollback = max((trainer.epoch - 10) // 10 * 10,
                               cfg.log.save_epoch_freq)
                if checkpoint_file(cfg.log.save_path, rollback) is None:
                    raise RuntimeError(
                        f"training diverged at epoch {trainer.epoch - 1} "
                        f"(loss={meters['loss'].avg:.4g}, "
                        f"max={meters['max'].avg:.4g}) before the first "
                        f"checkpoint at epoch {rollback}: nothing to roll "
                        "back to; this early a divergence is a bug or a bad "
                        "config, not training noise")
                trainer.resume(epoch=rollback, finetune=False, strict=True,
                               load_optim=True)
                trainer.base_lr = trainer.base_lr / 2
                reset_meters()
                break
            reset_meters()
    return trainer


if __name__ == "__main__":
    cli_args = get_parser("Compressor_Trainer",
                          "LDT point cloud VAE (PyTorch)").parse_args()
    main(cli_args, get_config(cli_args))
