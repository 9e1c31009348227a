"""Faults planted in the program's timed path, each a way a later change
could go wrong unseen: a step that leaves the state unchanged, half of the
batch left out, an answer altered where it is produced. The comparison
that decides `correct` has to fail each (the CPU tests plant them at a
tiny size; `control.py --fault` reads them on the card).

Each runner module names its own faults: `faults()` returns
{fault: (object, attribute, make the replacement)}, built from the
wrappers here, and imports the program only when called. A cell on a new
runner brings its faults in its own file."""

from __future__ import annotations


def scaled(fn, factor: float):
    def wrapped(*a, **kw):
        return fn(*a, **kw) * factor
    return wrapped


def half_objective(fn):
    """The stage-2 objective of the first half of the batch."""
    def wrapped(score, eps, t, var, e2int, weight, eta, *a, **kw):
        h = eps.shape[0] // 2
        return fn(score, eps[:h], t[:h], var[:h], e2int[:h], weight[:h],
                  eta[:h], *a, **kw)
    return wrapped


def half_sampled(fn):
    """The first half of the batch sampled, then repeated."""
    import torch

    def wrapped(score, sde, batch, *a, **kw):
        if kw.get("label") is not None:
            kw["label"] = kw["label"][:batch // 2]
        out = fn(score, sde, batch // 2, *a, **kw)
        return torch.cat([out, out])
    return wrapped


def metrics_scaled(fn, factor: float):
    def wrapped(*a, **kw):
        return {k: v * factor for k, v in fn(*a, **kw).items()}
    return wrapped


def unchanged(state, *a, **kw):
    return state


def _table(kind: str) -> dict:
    from benchmark import harness

    return harness.runner_module(kind).faults()


def plant(kind: str, name: str):
    """(object, attribute, replacement) of fault `name` of runner `kind`."""
    obj, attr, make = _table(kind)[name]
    return obj, attr, make()


def names(kind: str) -> list:
    return list(_table(kind))
