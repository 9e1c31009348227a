"""Checkpoints of the trainers, counterpart of
`ldt_tpu/training/checkpoint.py`.

The port's format is one `torch.save` file per saved epoch,
`<save_path>/checkpt_{epoch}.pt`, holding {cfg, state, epoch, itr, time}:
`state` is a tree of plain dicts of CPU tensors under the port's names (a
trainer's `TrainState.to_tree()`, and for stage 2 the Compressor's
state_dict), with the counters as ints. The JAX package's
`checkpt_{epoch}.msgpack` files (single-file or sharded) load too, through
`jax_checkpoint`, into the same names: a run trained on a TPU continues on
the card from the same directory.

`save_checkpoint` copies the tree to the host before it returns (the
trainers update their tensors in place); `moments_bf16` rounds the Adam
moments to bf16 on the device first (half their bytes; a restore casts them
back to the template's f32), `async_write` writes the file on a thread that
is joined before the next save or load, by `wait_pending_saves`, and at
exit, raising its error there. Files are written to `<path>.tmp` and
renamed, so a reader never sees half a file.

"Latest epoch" is the last row of `training.csv`, else the newest file on
disk (`resolve_checkpoint_epoch`).
"""

from __future__ import annotations

import atexit
import csv
import glob
import os
import re
import threading
from typing import Any, Dict, Optional

import torch

from ldt_torch.tools.io import namespace2dict

_pending_saves: list = []
_pending_lock = threading.Lock()
# only ActNorm's statistics may broadcast across a shape drift: checkpoints
# of the JAX package before its per-token ActNorm stored pooled [1, 1, F]
# shift / log_scale where the model has [1, z_scales, F] (the same math);
# any other leaf of another shape is a checkpoint of another config
_BROADCAST_OK = ("shift", "log_scale")
_SUFFIXES = (".pt", ".msgpack")


def wait_pending_saves() -> None:
    """Join every checkpoint write in flight; raises the first one's
    error."""
    with _pending_lock:
        pending, _pending_saves[:] = _pending_saves[:], []
    for t in pending:
        t.join()
    for t in pending:
        if t.error is not None:
            raise t.error


atexit.register(wait_pending_saves)


def _is_moment_path(path) -> bool:
    return any(k in ("mu", "nu") for k in path)


def _host_tree(tree, moments_bf16: bool, path=()):
    """A copy of `tree` with every tensor on the CPU (the moments first
    rounded to bf16 on their device when `moments_bf16`)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v, moments_bf16, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if (moments_bf16 and t.dtype == torch.float32
                and _is_moment_path(path)):
            t = t.to(torch.bfloat16)
        return t.to("cpu", copy=True)
    return tree


def tree_nbytes(tree) -> int:
    """The bytes of the tensors in `tree`."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def write_atomic(path: str, write) -> None:
    """`write(tmp_path)`, then rename `tmp_path` to `path`."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state_tree: Dict[str, Any], cfg=None,
                    epoch: int = 0, itr: int = 0, time: float = 0.0,
                    moments_bf16: bool = False,
                    async_write: bool = False) -> None:
    """Save {cfg, state, epoch, itr, time} to `path` (see the module
    docstring for `moments_bf16` and `async_write`)."""
    wait_pending_saves()  # never two writes of one tree at once
    payload = {
        "cfg": namespace2dict(cfg) if cfg is not None else {},
        "state": _host_tree(state_tree, moments_bf16),
        "epoch": int(epoch), "itr": int(itr), "time": float(time),
    }

    def write():
        write_atomic(path, lambda tmp: torch.save(payload, tmp))

    if not async_write:
        write()
        return

    def run():
        try:
            write()
        except BaseException as e:  # raised again by wait_pending_saves
            t.error = e

    t = threading.Thread(target=run, name=f"ckpt-write:{path}", daemon=False)
    t.error = None
    with _pending_lock:
        _pending_saves.append(t)
    t.start()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{cfg, state, epoch, itr, time} of a port `.pt` file or of a JAX
    `.msgpack` checkpoint (its state under the port's names); tensors on
    the CPU."""
    wait_pending_saves()
    if path.endswith(".msgpack"):
        from ldt_torch.training.jax_checkpoint import load_jax_checkpoint

        return load_jax_checkpoint(path)
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True)


def restore_into(template, loaded, strict: bool = True, _path: str = ""):
    """`loaded` (a checkpoint's state) shaped to the structure of
    `template` (a live state tree); returns a new tree.

    strict=True: a key missing from `loaded`, or one the template lacks,
    raises. strict=False: a missing key keeps the template's value and an
    unexpected key is ignored. Tensors are cast to the template's dtype;
    a shape that differs raises, except that ActNorm's `shift` and
    `log_scale` broadcast to the template's shape."""
    where = _path or "/"
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            raise ValueError(f"checkpoint has {type(loaded).__name__} at "
                             f"'{where}', the state a dict")
        if strict:
            missing = [k for k in template if k not in loaded]
            extra = [k for k in loaded if k not in template]
            if missing or extra:
                raise ValueError(
                    f"checkpoint keys at '{where}': missing {missing}, "
                    f"unexpected {extra} (strict=False keeps the missing "
                    "and ignores the unexpected)")
        return {k: restore_into(v, loaded[k], strict, f"{_path}/{k}")
                if k in loaded else v for k, v in template.items()}
    if template is None or loaded is None:
        if template is not None or loaded is not None:
            raise ValueError(f"checkpoint has {type(loaded).__name__} at "
                             f"'{where}', the state "
                             f"{type(template).__name__}")
        return None
    if not isinstance(template, torch.Tensor):
        return type(template)(loaded)  # a counter
    if not isinstance(loaded, torch.Tensor):
        raise ValueError(f"checkpoint has {type(loaded).__name__} at "
                         f"'{where}', the state a tensor")
    out = loaded.to(template.dtype)
    if out.shape != template.shape:
        leaf = _path.rsplit("/", 1)[-1].rsplit(".", 1)[-1]
        if leaf in _BROADCAST_OK:
            try:
                return out.expand(template.shape).clone()
            except RuntimeError:
                pass
        raise ValueError(f"checkpoint leaf {leaf!r} at '{where}' has shape "
                         f"{tuple(out.shape)}, the model "
                         f"{tuple(template.shape)}")
    return out


def latest_epoch_from_csv(save_path: str) -> Optional[int]:
    """The last `epoch` value in `<save_path>/training.csv`, if any."""
    csv_path = os.path.join(save_path, "training.csv")
    if not os.path.exists(csv_path):
        return None
    last = None
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            last = row
    if last is None or "epoch" not in last:
        return None
    return int(float(last["epoch"]))


def checkpoint_path(save_path: str, epoch: int) -> str:
    """Where the port saves epoch `epoch`."""
    return os.path.join(save_path, f"checkpt_{epoch}.pt")


def checkpoint_file(save_path: str, epoch: int) -> Optional[str]:
    """The checkpoint of `epoch` on disk (after the writes in flight): the
    port's `.pt`, else the JAX package's `.msgpack`; None when there is
    neither."""
    wait_pending_saves()
    for suffix in _SUFFIXES:
        path = os.path.join(save_path, f"checkpt_{epoch}{suffix}")
        if os.path.exists(path):
            return path
    return None


def resolve_checkpoint_epoch(save_path: str,
                             epoch: Optional[int] = None) -> int:
    """The checkpoint epoch to load under `save_path` (either format).

    An explicitly requested `epoch` must exist. Otherwise training.csv's
    last epoch, or, when the CSV ran past the last save or is absent, the
    newest checkpoint on disk, once the writes in flight have landed (a
    stage-2 save writes on a thread). Raises FileNotFoundError when nothing
    is loadable."""
    wait_pending_saves()
    if epoch is not None:
        if checkpoint_file(save_path, epoch) is None:
            raise FileNotFoundError(
                f"no checkpoint for epoch {epoch} under {save_path}")
        return epoch
    epoch = latest_epoch_from_csv(save_path)
    if epoch is not None and checkpoint_file(save_path, epoch) is not None:
        return epoch
    found = sorted(
        int(m.group(1)) for f in glob.glob(os.path.join(save_path,
                                                        "checkpt_*"))
        if (m := re.search(r"checkpt_(\d+)\.(?:pt|msgpack)$", f)))
    if not found:
        raise FileNotFoundError(f"no checkpoints under {save_path}")
    return found[-1]
