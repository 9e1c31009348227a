"""ViPC completion, stage 1: finetune the set-VAE Compressor on the GT
clouds of ShapeNet-ViPC, counterpart of `train_Completion_Compressor.py`.

    python -m ldt_torch.entries.train_completion_compressor --dataset plane \
        --save experiments [--resume True] [--evaluate True] [--device cpu]

reads `<save>/Compressor_Trainer/completion/<dataset>/config.yaml` and the
ViPC tree of its `data:` section (`data.vipc`). The run starts from the
stage-1 checkpoint `model.pretrain_path` (`Trainer.load_pretrain`), or with
`--resume` from its own. Each batch's GT clouds are `fps_to`
`common.num_points` on the device before the step; the epoch's meters,
training.csv, the save cadence and the divergence watchdog are
`train_compressor`'s (a non-finite mean loss, or a mean max feature over
10000, rolls back to the checkpoint of epoch max((epoch - 10) // 10 * 10,
save_epoch_freq) with the learning rate halved); every `eval_epoch_freq`
epochs `reconstruction` scores CD x 1000 and F1 to eval.csv.
`--evaluate True` only scores.
"""

from __future__ import annotations

import numpy as np
import torch

from ldt_torch import resolve_device
from ldt_torch.cli import get_completion_config, get_parser, progress
from ldt_torch.data.vipc import get_data_loaders
from ldt_torch.tools.utils import AverageMeter, common_init, train_dtype
from ldt_torch.training.checkpoint import checkpoint_file
from ldt_torch.training.completion_compressor_trainer import Trainer, fps_to


def main(args, cfg) -> Trainer:
    """Run completion stage 1 as `args` and `cfg` say; returns the
    trainer."""
    device = resolve_device(args.device)
    train_dtype(cfg)  # the port trains in float32 and refuses the rest
    generator = common_init(cfg.common.seed, device)
    loaders = get_data_loaders(cfg.data)
    train_loader = loaders["train_loader"]
    test_loader = loaders["test_loader"]
    trainer = Trainer(cfg, device=device, generator=generator)
    trainer.info(vars(args))
    num_points = cfg.common.num_points
    first = next(iter(train_loader))
    trainer.maybe_init({"tr_points": fps_to(first["pc"], num_points,
                                            device)})
    if args.resume:
        trainer.resume(epoch=args.resume_epoch, finetune=args.finetune,
                       strict=args.strict, load_optim=args.load_optimizer)
    else:
        trainer.load_pretrain()

    if args.evaluate:
        all_res = trainer.reconstruction(test_loader=test_loader)
        trainer.info(str(all_res))
        return trainer

    meters = {k: AverageMeter() for k in ("loss", "kl", "rec", "max")}

    def reset_meters():
        for m in meters.values():
            m.reset()

    def diverged():
        return (not np.isfinite(meters["loss"].avg)
                or meters["max"].avg > 10000)

    while trainer.epoch < cfg.common.epochs:
        for epoch in range(trainer.epoch, cfg.common.epochs + 1):
            for data in progress(train_loader, desc=f"Epoch {epoch}"):
                pc = fps_to(data["pc"], num_points, device)
                # the watchdog reads the meters every step: one transfer
                values = torch.stack(trainer.update(pc)).tolist()
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
                all_res = trainer.reconstruction(test_loader=test_loader)
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
                        "back to")
                trainer.resume(epoch=rollback, finetune=False, strict=True,
                               load_optim=True)
                trainer.base_lr = trainer.base_lr / 2
                reset_meters()
                break
            reset_meters()
    return trainer


if __name__ == "__main__":
    cli_args = get_parser("Compressor_Trainer",
                          "LDT completion VAE (PyTorch)").parse_args()
    main(cli_args, get_completion_config(cli_args))
