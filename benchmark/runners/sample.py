"""Sampling as valsample runs it: `LatentSDETrainer.sample(batch[,
label=c])`, the 1000-step ancestral sampler of the trainer's EMA Score,
then the set-VAE decode to 2048-point clouds; one whole generation of
`batch` clouds a unit. With several categories each generation takes the
next label of a cycle through them from a start drawn from the seed (the
whole Score a step: a label cannot be hoisted into the modulations);
with one, none.

Each generation's draws come from the trainer's generator, seeded for
that generation from the run's seed. The check takes `check_rows` rows of
every generation, drawn from the seed, and runs the reference over them
once the window has closed: the same draws, made again from the same
generator state in the sampler's order (the initial draw, then one a
step), through the f32 reference sampler and its decode. It compares the
latents and the clouds row by row (relative L2, the worst row), and the
reference's decode of the program's own latents with the program's
clouds.
"""

from __future__ import annotations

import torch

from benchmark import faults as f
from benchmark import weights
from benchmark.runners import common
from benchmark.reference import diffusion as ref_diff
from benchmark.reference.models import Precision

# the traffic's parameters at the CPU tests' tiny size
TINY = {"batch": 4, "warmup_steps": 4, "traced_steps": 4, "traced_from": 2,
        "check_rows": 2}


def faults() -> dict:
    """{fault: (object, attribute, make the replacement)} (`faults.py`)."""
    from ldt_torch.models import compressor
    from ldt_torch.training import latent_sde_trainer as lst

    return {
        "latents altered": (lst, "sample_latents",
                            lambda: f.scaled(lst.sample_latents, 1.01)),
        "half the batch": (lst, "sample_latents",
                           lambda: f.half_sampled(lst.sample_latents)),
        "clouds altered": (compressor.Compressor, "sample",
                           lambda: f.scaled(compressor.Compressor.sample,
                                            1.01))}


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.dev = torch.device(ctx.device)
        self.attempted = 0
        self.kept = []  # (generation, rows, latents, clouds, label)
        self.generations = 0

    # --- set-up -------------------------------------------------------

    def setup(self):
        from ldt_torch.configs import sde_cfg
        from ldt_torch.diffusion import make_diffusion
        from ldt_torch.training.latent_sde_trainer import Trainer

        c, p = self.ctx.config, self.p
        self.batch = p["batch"]
        self.steps = c["sde"]["sample_N"]
        self.shape = (self.batch, c["score"]["z_scale"], c["score"]["z_dim"])
        cfg = common.namespace(c, "score", "compressor", "sde", "opt",
                               "common", "data")
        score, comp = common.ref_nets(c, self.ctx.seed, self.dev)
        self.trainer = Trainer(cfg, device=self.dev,
                               generator=weights.generator(
                                   self.ctx.seed, 5, self.dev))
        self.trainer.maybe_init({}, score_weights=common.state(score),
                                compressor_weights=common.state(comp))
        del score, comp
        cats = c["data"]["num_categorys"]
        start = common.pick_rows(self.ctx.seed, 6, cats, 1)[0]
        self.labels = [(start + i) % cats for i in range(cats)] \
            if cats > 1 else [None]
        # the warm-up: every kernel and shape of a generation, over a
        # schedule of `warmup_steps` steps
        warm = make_diffusion(sde_cfg(**dict(c["sde"], sample_N=p[
            "warmup_steps"])), device=self.dev)
        self._warm_up(warm, p["warmup_steps"])

    def _warm_up(self, sde, steps: int):
        from ldt_torch.generate import sample_latents

        label = self.labels[0]
        lab = None if label is None else torch.full(
            (self.batch,), label, device=self.dev)
        with self.trainer.ema_weights() as score, torch.inference_mode():
            lat = sample_latents(score, sde, self.batch, steps,
                                 device=self.dev, label=lab,
                                 generator=self._draws(-1))
            self.trainer.compressor.sample(
                (self.batch, self.trainer.compressor.cfg.outsize), lat)

    def _draws(self, gen: int) -> torch.Generator:
        return weights.generator(self.ctx.seed, 100 + gen, self.dev)

    def _rows(self, gen: int) -> list:
        return common.pick_rows(self.ctx.seed, 200 + gen, self.batch,
                                self.p["check_rows"])

    # --- the window ---------------------------------------------------

    def unit(self):
        gen = self.generations
        label = self.labels[gen % len(self.labels)]
        self.trainer.generator = self._draws(gen)
        clouds, lat = self.trainer.sample(self.batch, label=label)
        idx = torch.tensor(self._rows(gen), device=self.dev)
        self.kept.append((gen, self._rows(gen), lat[idx].float().clone(),
                          clouds[idx].float().clone(), label))
        self.generations += 1
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        return {"clouds": self.batch}

    def end_to_end(self, window_s, counts_):
        return {"gen_clouds_per_min": counts_["clouds"] * 60.0 / window_s}

    def traced(self, stretch):
        """One whole generation, the profiler over `traced_steps` steps
        from step `traced_from` (a hook counts the first block's calls)."""
        k, first = self.p["traced_steps"], self.p["traced_from"]
        calls = [0]

        def hook(module, args):
            if calls[0] == first:
                stretch.begin()
            elif calls[0] == first + k:
                stretch.end()
            calls[0] += 1

        blocks = self.trainer.score.transformer
        handle = blocks[0].register_forward_pre_hook(hook)
        try:
            self.unit()
        finally:
            handle.remove()
        return {"steps": k, "batch": self.batch,
                "label": self.labels[0] is not None,
                "dtype": common.compute_dtype(self.ctx.config)}

    def release(self):
        del self.trainer
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------

    def _draws_of(self, gen: int, rows: list):
        """(x0, noise) of generation `gen`'s `rows`, made again in the
        sampler's order."""
        g = self._draws(gen)
        idx = torch.tensor(rows, device=self.dev)
        x0 = torch.randn(self.shape, generator=g, device=self.dev)[idx]
        noise = torch.stack([torch.randn(self.shape, generator=g,
                                         device=self.dev)[idx]
                             for _ in range(self.steps)])
        return x0, noise

    def reference(self, precision: str = "f32", got_lat=None):
        """The reference's (latents, clouds, decode of `got_lat`, by
        default the program's latents) of every kept row."""
        c = self.ctx.config
        score, comp = common.ref_nets(c, self.ctx.seed, self.dev)
        sde = ref_diff.VPSDE(c["sde"]["beta_start"], c["sde"]["beta_end"],
                             self.steps, c["sde"]["sample_time_eps"],
                             self.dev)
        x0, noise, labels = [], [], []
        for gen, rows, _, _, label in self.kept:
            a, b = self._draws_of(gen, rows)
            x0.append(a)
            noise.append(b)
            labels += [label] * len(rows)
        x0, noise = torch.cat(x0), torch.cat(noise, dim=1)
        lab = None if labels[0] is None else torch.tensor(labels,
                                                          device=self.dev)
        if got_lat is None:
            got_lat = torch.cat([k[2] for k in self.kept])
        with Precision.use(precision), torch.no_grad():
            lat = ref_diff.ancestral_sample(score, sde, x0, noise, lab)
            return lat, comp.decode(lat), comp.decode(got_lat)

    def check(self, precision: str = "f32"):
        got_lat = torch.cat([k[2] for k in self.kept])
        got_clouds = torch.cat([k[3] for k in self.kept])
        return self.gaps(got_lat, got_clouds, *self.reference(precision))

    def control(self, precision: str):
        """The check's numbers with the reference in `precision` in the
        program's place."""
        lat, clouds, _ = self.reference(precision)
        return self.gaps(lat, clouds, *self.reference("f32", got_lat=lat))

    def gaps(self, got_lat, got_clouds, lat, clouds, decoded):
        lim = self.ctx.limits
        self.attempted = self.generations
        out = [("latents", common.rel_rows(got_lat, lat), lim["latents"]),
               ("clouds", common.rel_rows(got_clouds, clouds),
                lim["clouds"]),
               ("decode", common.rel_rows(got_clouds, decoded),
                lim["decode"])]
        return out
