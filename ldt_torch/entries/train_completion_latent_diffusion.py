"""ViPC completion, stage 2: train the conditional latent DiT, counterpart
of `train_Completion_Latent_Diffusion.py`.

    python -m ldt_torch.entries.train_completion_latent_diffusion \
        --dataset plane --save experiments [--resume True] \
        [--evaluate True] [--device cpu]

reads `<save>/Latent_Diffusion_Trainer/completion/<dataset>/config.yaml`
and the ViPC tree of its `data:` section (`data.vipc`). The frozen
Compressor comes from the completion stage 1's checkpoint
`compressor.pretrain_path` (`Trainer.load_pretrain`), or with `--resume`
both nets from the run's own. Each batch's GT and partial clouds are
`fps_to` `common.num_points` on the device; the condition is {'img': the
views, 'pts': the partial clouds}. The epoch's losses reach the host once,
at its end; training.csv gets a row every `log_epoch_freq` epochs, a
checkpoint is saved every `save_epoch_freq`, and every `eval_epoch_freq`
epochs `valsample` scores CD x 1000 and F1 of the completions to eval.csv.
`--evaluate True` only scores, on the whole test split.
"""

from __future__ import annotations

from ldt_torch import resolve_device
from ldt_torch.cli import get_completion_config, get_parser, progress
from ldt_torch.data.vipc import get_data_loaders
from ldt_torch.tools.utils import (
    AverageMeter,
    common_init,
    sync_epoch_values,
    train_dtype,
)
from ldt_torch.training.completion_compressor_trainer import fps_to
from ldt_torch.training.completion_latent_sde_trainer import Trainer


def main(args, cfg) -> Trainer:
    """Run completion stage 2 as `args` and `cfg` say; returns the
    trainer."""
    device = resolve_device(args.device)
    train_dtype(cfg)  # the port trains in float32 and refuses the rest
    generator = common_init(cfg.common.seed, device)
    loaders = get_data_loaders(cfg.data)
    train_loader = loaders["train_loader"]
    test_loader = loaders["test_loader"]
    trainer = Trainer(cfg, device=device, generator=generator)
    trainer.info(vars(args))

    trainer.maybe_init(next(iter(train_loader)))
    if args.resume:
        trainer.resume(epoch=args.resume_epoch, strict=args.strict,
                       load_optim=args.load_optimizer, finetune=args.finetune)
    else:
        trainer.load_pretrain()

    if args.evaluate:
        all_res = trainer.valsample(test_loader=test_loader, full=True)
        trainer.info(str(all_res))
        trainer.write_eval(trainer.epoch - 1, all_res)
        return trainer

    num_points = cfg.common.num_points
    loss_meter = AverageMeter()
    for epoch in range(trainer.epoch, cfg.common.epochs + 1):
        losses = []
        for data in progress(train_loader, desc=f"Epoch {epoch}"):
            pc = fps_to(data["pc"], num_points, device)
            pc_part = fps_to(data["pc_part"], num_points, device)
            losses.append(trainer.update(pc, {"img": data["views"],
                                              "pts": pc_part}))
        for loss in sync_epoch_values(losses):
            loss_meter.update(loss)
        trainer.epoch_end()
        if (trainer.epoch - 1) % cfg.log.log_epoch_freq == 0:
            trainer.updata_time()
            trainer.write_log([epoch, trainer.itr, loss_meter.avg,
                               trainer.time], mode="train")
            loss_meter.reset()
        if (trainer.epoch - 1) % cfg.log.eval_epoch_freq == 0:
            all_res = trainer.valsample(test_loader=test_loader)
            trainer.info(f"epoch{trainer.epoch - 1}:" + str(all_res))
            try:
                trainer.write_eval(trainer.epoch - 1, all_res)
            except ValueError as e:
                print(f"write log failed: {e}")
    return trainer


if __name__ == "__main__":
    cli_args = get_parser("Latent_Diffusion_Trainer",
                          "LDT completion diffusion (PyTorch)").parse_args()
    main(cli_args, get_completion_config(cli_args))
