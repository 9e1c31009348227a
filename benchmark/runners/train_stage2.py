"""Stage-2 training: `LatentSDETrainer.update` on [B, N, 3] clouds, steps
dispatched back to back with one synchronize an epoch (the losses of the
epoch read in one transfer and the epoch closed, as the training entry
does).

Feed: `batches` host batches of synthetic clouds made from the seed in
set-up and cycled, as the loader hands numpy arrays over; each step's
draws (t indices, the noise eta, the encode's reparameterization noise)
made on the device from the seed and passed to the call.

Set-up builds the trainer once, with the seed's weights, and runs the
first `check_steps` steps through the window's own call and feed. The
check follows them with the reference: each step's loss, the first step's
gradient as the optimizer took it (its first moment over 1 - b1), and the
change of every parameter and of its EMA after the steps, before the
window's first step. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change.
"""

from __future__ import annotations

import torch

from benchmark import faults as f
from benchmark import shapes, weights
from benchmark.runners import common
from benchmark.reference import diffusion as ref_diff
from benchmark.reference import optim as ref_optim
from benchmark.reference.models import Precision

# the traffic's parameters at the CPU tests' tiny size
TINY = {"batches": 2, "steps_per_epoch": 2, "traced_steps": 2}


def faults() -> dict:
    """{fault: (object, attribute, make the replacement)} (`faults.py`)."""
    from ldt_torch.training import latent_sde_trainer as lst

    return {
        "state unchanged": (lst, "apply_update", lambda: f.unchanged),
        "half the batch": (lst, "score_objective",
                           lambda: f.half_objective(lst.score_objective)),
        "loss altered": (lst, "score_objective",
                         lambda: f.scaled(lst.score_objective, 1.01))}


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.dev = torch.device(ctx.device)
        self.attempted = 0

    # --- set-up -------------------------------------------------------

    def setup(self):
        from ldt_torch.training.latent_sde_trainer import Trainer

        c, p, seed = self.ctx.config, self.p, self.ctx.seed
        self.cfg = common.namespace(c, "score", "compressor", "sde", "opt",
                                    "common", "data")
        b, n = c["data"]["batch_size"], c["data"]["tr_max_sample_points"]
        self.batch, self.points = b, n
        rng = shapes.rng(seed, 10)
        self.batches = [{"tr_points": shapes.synthetic_shapes(b, n, rng)}
                        for _ in range(p["batches"])]
        score, comp = common.ref_nets(c, seed, self.dev)
        self.trainer = Trainer(self.cfg, device=self.dev,
                               generator=weights.generator(seed, 3, self.dev))
        self.trainer.maybe_init(self.batches[0],
                                score_weights=common.state(score),
                                compressor_weights=common.state(comp))
        del score, comp
        self.feed = weights.generator(seed, 4, self.dev)
        self.step = 0
        self.draws = []
        losses = []
        for k in range(p["check_steps"]):
            losses.append(self._update(record=True))
            if k == 0:
                b1 = self.cfg.opt.beta1
                mu = self.trainer.state.opt_state.mu
                self.grad_norms = {k: v / (1.0 - b1) for k, v in
                                   common.leaf_norms(mu).items()}
        self.losses = torch.stack(losses).cpu().tolist()
        self.trainer.epoch_end()
        self._record_change()

    def _draws(self):
        cs, cz = self.cfg.score, self.cfg.compressor
        b = self.batch
        t_idx = torch.randint(0, self.cfg.sde.train_N, (b,),
                              generator=self.feed, device=self.dev)
        eta = torch.randn((b, cs.z_scale, cs.z_dim), generator=self.feed,
                          device=self.dev)
        enc = torch.randn((cz.n_layers, b, cz.z_scales, cz.z_dim),
                          generator=self.feed, device=self.dev)
        return t_idx, eta, enc

    def _update(self, record=False):
        data = self.batches[self.step % len(self.batches)]
        t_idx, eta, enc = self._draws()
        if record:
            self.draws.append((self.step % len(self.batches), t_idx, eta,
                               enc))
        self.step += 1
        return self.trainer.update(data, t_idx=t_idx, eta=eta,
                                   enc_noise=list(enc))

    @torch.no_grad()
    def _record_change(self):
        """Each leaf's change, and its EMA's, from the seed's weights."""
        score = weights.score(self.ctx.config, self.ctx.seed, self.dev)
        init = dict(score.named_parameters())
        st = self.trainer.state
        self.change = common.leaf_norms(
            {k: st.params[k] - init[k] for k in st.params})
        self.ema_change = common.leaf_norms(
            {k: st.ema_params[k] - init[k] for k in st.params})
        del score, init

    # --- the window ---------------------------------------------------

    def unit(self):
        from ldt_torch.tools.utils import sync_epoch_values

        steps = self.p["steps_per_epoch"]
        sync_epoch_values([self._update() for _ in range(steps)])
        self.trainer.epoch_end()
        return {"steps": steps}

    def end_to_end(self, window_s, counts_):
        return {"train_step_ms": window_s * 1e3 / counts_["steps"]}

    def traced(self, stretch):
        k = self.p["traced_steps"]
        stretch.begin()
        for _ in range(k):
            self._update()
        stretch.end()
        return {"steps": k, "batch": self.batch, "points": self.points,
                "dtype": common.compute_dtype(self.ctx.config)}

    def release(self):
        del self.trainer
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------

    def check(self, precision: str = "f32"):
        """(name, value, limit) of the program's first steps against the
        reference's, which runs in `precision`."""
        got = (self.losses, self.grad_norms, self.change, self.ema_change)
        return self.gaps(got, self.follow(precision))

    def control(self, precision: str):
        """The check's numbers with the reference in `precision` in the
        program's place."""
        return self.gaps(self.follow(precision), self.follow("f32"))

    def gaps(self, got, want):
        lim = self.ctx.limits
        self.attempted = len(want[0])
        med = sorted(want[1].values())[len(want[1]) // 2]
        moved = [k for k, v in want[1].items() if v >= 1e-3 * med]
        out = [("loss", max(abs(a - b) / abs(b)
                            for a, b in zip(got[0], want[0])), lim["loss"]),
               ("grad_norm", common.norm_gap(got[1], want[1]),
                lim["grad_norm"]),
               ("param_change", common.norm_gap(got[2], want[2], moved),
                lim["param_change"]),
               ("ema_change", common.norm_gap(got[3], want[3], moved),
                lim["ema_change"])]
        return out

    def follow(self, precision: str = "f32"):
        """The reference, in `precision`, through the recorded steps:
        (losses, the first step's clipped gradient norms, the change norms
        of the parameters and of the EMA)."""
        with Precision.use(precision):
            return self._follow()

    def _follow(self):
        c = self.ctx.config
        score, comp = common.ref_nets(c, self.ctx.seed, self.dev)
        comp.requires_grad_(False)
        sde = ref_diff.VPSDE(c["sde"]["beta_start"], c["sde"]["beta_end"],
                             c["sde"]["train_N"], c["sde"]["sample_time_eps"],
                             self.dev)
        params = dict(score.named_parameters())
        init = {k: v.detach().clone() for k, v in params.items()}
        o = c["opt"]
        adam = ref_optim.Adam(params, o["beta1"], o["beta2"],
                              o["grad_norm_clip_value"], o["ema_decay"])
        losses, first = [], None
        for itr, (bi, t_idx, eta, enc) in enumerate(self.draws):
            pts = torch.as_tensor(self.batches[bi]["tr_points"],
                                  device=self.dev)
            with torch.no_grad():
                lat = comp.encode(pts, enc)
            score.zero_grad(set_to_none=True)
            loss = ref_diff.train_loss(score, sde, lat, t_idx, eta)
            loss.backward()
            lr = ref_optim.warmup_lr(o["lr"], o["warmup_iters"], itr)
            clipped = adam.step(params, {k: p.grad for k, p in
                                         params.items()}, lr)
            losses.append(loss.item())
            if first is None:
                first = common.leaf_norms(clipped)
            del clipped
        with torch.no_grad():
            change = common.leaf_norms({k: params[k] - init[k]
                                        for k in params})
            ema_change = common.leaf_norms({k: adam.ema[k] - init[k]
                                            for k in params})
        return losses, first, change, ema_change

