"""Config-driven CSV and text logging, counterpart of
`ldt_tpu/tools/log.py`: `training.csv`, `test.csv` and `eval.csv` with the
columns and format strings of the config's `log:` section, and a
timestamped `log_<stamp>.txt`, under `log.save_path` (the files the JAX
package writes, so a run can move between the two)."""

from __future__ import annotations

import csv
import logging
import os
from datetime import datetime

from ldt_torch.tools import io


def get_logger(logpath):
    """The `ldt_torch` logger at INFO, writing to `logpath` (appending) and
    the console; its earlier handlers are closed and replaced."""
    log = logging.getLogger("ldt_torch")
    log.setLevel(logging.INFO)
    for handler in log.handlers:
        handler.close()
    log.handlers = [logging.FileHandler(logpath, mode="a"),
                    logging.StreamHandler()]
    return log


class logger:
    """`info(msg)` to the text log; `write(row, mode)` appends one row to
    training.csv ("train"), test.csv ("test") or eval.csv ("eval"),
    formatted by `cfg.log.trainformat` / `evalformat` (None: as is)."""

    def __init__(self, cfg):
        io.makedirs(cfg.log.save_path)
        stamp = datetime.now().strftime("%Y_%m_%d_%H_%M")
        self.log = get_logger(
            logpath=os.path.join(cfg.log.save_path, f"log_{stamp}.txt"))
        self.info(cfg)
        self.trainlogpath = os.path.join(cfg.log.save_path, "training.csv")
        self.testlogpath = os.path.join(cfg.log.save_path, "test.csv")
        self.evallogpath = os.path.join(cfg.log.save_path, "eval.csv")
        if (len(cfg.log.trainformat) != len(cfg.log.traincolumns)
                or len(cfg.log.evalformat) != len(cfg.log.evalcolumns)):
            raise ValueError("log.trainformat / evalformat must have one "
                             "entry per column of traincolumns / "
                             "evalcolumns")
        self.traincolumns = cfg.log.traincolumns
        self.trainformat = cfg.log.trainformat
        self.evalcolumns = cfg.log.evalcolumns
        self.evalformat = cfg.log.evalformat
        for path, columns in ((self.trainlogpath, self.traincolumns),
                              (self.evallogpath, self.evalcolumns),
                              (self.testlogpath, self.traincolumns)):
            if not os.path.exists(path):
                with open(path, "w", newline="") as f:
                    csv.DictWriter(f, columns).writeheader()

    def info(self, message):
        self.log.info(message)

    def write(self, message, mode="train"):
        if mode == "eval":
            logpath, columns, form = (self.evallogpath, self.evalcolumns,
                                      self.evalformat)
        elif mode in ("train", "test"):
            logpath = (self.trainlogpath if mode == "train"
                       else self.testlogpath)
            columns, form = self.traincolumns, self.trainformat
        else:
            raise ValueError(f"mode {mode!r}: expected train, test or eval")
        if len(message) != len(columns):
            raise ValueError(f"{len(message)} values for the {len(columns)} "
                             f"columns {columns}")
        row = {columns[i]: (message[i] if form[i] is None
                            else form[i].format(float(message[i])))
               for i in range(len(message))}
        with open(logpath, "a", newline="") as f:
            csv.DictWriter(f, columns).writerow(row)
