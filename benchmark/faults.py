"""Faults planted in the program's timed path, each a way a later change
could go wrong unseen: a step that leaves the state unchanged, half of the
batch left out, an answer altered where it is produced. The comparison
that decides `correct` has to fail each (the CPU tests plant them at a
tiny size; `control.py --fault` reads them on the card)."""

from __future__ import annotations


def _scaled(fn, factor: float):
    def wrapped(*a, **kw):
        return fn(*a, **kw) * factor
    return wrapped


def _half_objective(fn):
    """The stage-2 objective of the first half of the batch."""
    def wrapped(score, eps, t, var, e2int, weight, eta, *a, **kw):
        h = eps.shape[0] // 2
        return fn(score, eps[:h], t[:h], var[:h], e2int[:h], weight[:h],
                  eta[:h], *a, **kw)
    return wrapped


def _half_sampled(fn):
    """The first half of the batch sampled, then repeated."""
    import torch

    def wrapped(score, sde, batch, *a, **kw):
        if kw.get("label") is not None:
            kw["label"] = kw["label"][:batch // 2]
        out = fn(score, sde, batch // 2, *a, **kw)
        return torch.cat([out, out])
    return wrapped


def _metrics_scaled(fn, factor: float):
    def wrapped(*a, **kw):
        return {k: v * factor for k, v in fn(*a, **kw).items()}
    return wrapped


def _unchanged(state, *a, **kw):
    return state


def _table() -> dict:
    """{runner: {fault: (object, attribute, make the replacement)}}."""
    from ldt_torch.eval import metrics
    from ldt_torch.models import compressor
    from ldt_torch.training import latent_sde_trainer as lst

    return {
        "train_stage2": {
            "state unchanged": (lst, "apply_update", lambda: _unchanged),
            "half the batch": (lst, "score_objective",
                               lambda: _half_objective(lst.score_objective)),
            "loss altered": (lst, "score_objective",
                             lambda: _scaled(lst.score_objective, 1.01))},
        "sample": {
            "latents altered": (lst, "sample_latents",
                                lambda: _scaled(lst.sample_latents, 1.01)),
            "half the batch": (lst, "sample_latents",
                               lambda: _half_sampled(lst.sample_latents)),
            "clouds altered": (compressor.Compressor, "sample",
                               lambda: _scaled(compressor.Compressor.sample,
                                               1.01))},
        "evaluate": {
            "emd altered": (metrics, "approx_match_cost",
                            lambda: _scaled(metrics.approx_match_cost,
                                            1.01)),
            "cd altered": (metrics, "pairwise_cd_means",
                           lambda: _scaled(metrics.pairwise_cd_means, 1.01)),
            "metrics altered": (metrics, "lgan_mmd_cov",
                                lambda: _metrics_scaled(metrics.lgan_mmd_cov,
                                                        1.001))},
    }


def plant(kind: str, name: str):
    """(object, attribute, replacement) of fault `name` of runner `kind`."""
    obj, attr, make = _table()[kind][name]
    return obj, attr, make()


def names(kind: str) -> list:
    return list(_table()[kind])
