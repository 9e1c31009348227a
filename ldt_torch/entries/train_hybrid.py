"""Stage 3: the joint (Hybrid) finetune of the Compressor and the Score,
counterpart of `train_Hybrid.py`.

    python -m ldt_torch.entries.train_hybrid --dataset airplane \
        --save experiments [--resume True] [--evaluate True] [--device cpu]

reads `<save>/Hybrid_Trainer/<dataset>/config.yaml`. Both nets come from the
stage-2 dual checkpoint `opt.pretrain_path` when it is set
(`Trainer.load_pretrain`, a `.pt` or a JAX `.msgpack`), else from the seed;
with `--resume` both train states come from the run's own checkpoint. Each
step returns (loss_score, kl, rec); the epoch's values stay on the device
and reach the host once, at its end. training.csv gets a row of (epoch,
itr, loss_score, kl, rec, time) every `log_epoch_freq` epochs, a checkpoint
is saved every `save_epoch_freq` (`Trainer.epoch_end`), and every
`eval_epoch_freq` epochs `valsample` scores samples of the category
`--val_cate` (else `common.val_cate`, else 0) to eval.csv. `--evaluate True`
only scores.
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
from ldt_torch.training.hybrid_trainer import Trainer

METERS = ("loss_score", "kl", "rec")


def main(args, cfg) -> Trainer:
    """Run stage 3 as `args` and `cfg` say; returns the trainer."""
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
    elif getattr(cfg.opt, "pretrain_path", None):
        trainer.load_pretrain()

    if args.evaluate:
        all_res = trainer.valsample(test_loader=test_loader,
                                    val_cate=val_cate)
        trainer.write_eval(trainer.epoch - 1, all_res)
        return trainer

    meters = {k: AverageMeter() for k in METERS}
    for epoch in range(trainer.epoch, cfg.common.epochs + 1):
        steps = [trainer.update(data)
                 for data in progress(train_loader, desc=f"Epoch {epoch}")]
        for values in sync_epoch_values(steps):
            for k, v in zip(METERS, values):
                meters[k].update(v)
        trainer.epoch_end()
        if (trainer.epoch - 1) % cfg.log.log_epoch_freq == 0:
            trainer.updata_time()
            trainer.write_log([epoch, trainer.itr]
                              + [meters[k].avg for k in METERS]
                              + [trainer.time], mode="train")
            for m in meters.values():
                m.reset()
        if (trainer.epoch - 1) % cfg.log.eval_epoch_freq == 0:
            all_res = trainer.valsample(test_loader=test_loader,
                                        val_cate=val_cate)
            trainer.info(f"epoch{trainer.epoch - 1}:" + str(all_res))
            try:
                trainer.write_eval(trainer.epoch - 1, all_res)
            except ValueError as e:
                print(f"write log failed: {e}")
    return trainer


if __name__ == "__main__":
    cli_args = get_parser("Hybrid_Trainer",
                          "LDT hybrid finetune (PyTorch)").parse_args()
    main(cli_args, get_config(cli_args))
