"""Evaluation: `ldt_torch.eval.metrics.compute_all_metrics(smp, ref,
batch_size)`, valsample's call, one call a unit: the ref x sample, ref x
ref and sample x sample CD and EMD matrices (3 N M pairs) and MMD / COV /
1-NNA from them.

Feed: the reference set (the test split's stand-in) and `sample_sets`
sample sets of synthetic clouds made from the seed in set-up, numpy
arrays as valsample hands them over; the calls cycle through the sample
sets.

The check reads the six matrices each call computed (a recorder wrapped
around the module's `pairwise_EMD_CD`, which the call looks up by name)
and its metrics: the reference's MMD / COV / 1-NNA of those matrices
against the call's metrics (the largest absolute gap), and the
reference's CD and EMD of `check_pairs` pairs drawn from the seed across
the calls and matrices against the entries (the largest relative gap).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import faults as f
from benchmark import shapes
from benchmark.reference import evaluation as ref_eval
from benchmark.reference.models import Precision

# the traffic's parameters at the CPU tests' tiny size
TINY = {"clouds": 6, "batch_size": 4, "check_pairs": 16, "check_block": 8,
        "sample_sets": 2}


def faults() -> dict:
    """{fault: (object, attribute, make the replacement)} (`faults.py`)."""
    from ldt_torch.eval import metrics

    return {
        "emd altered": (metrics, "approx_match_cost",
                        lambda: f.scaled(metrics.approx_match_cost, 1.01)),
        "cd altered": (metrics, "pairwise_cd_means",
                       lambda: f.scaled(metrics.pairwise_cd_means, 1.01)),
        "metrics altered": (metrics, "lgan_mmd_cov",
                            lambda: f.metrics_scaled(metrics.lgan_mmd_cov,
                                                     1.001))}


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.dev = torch.device(ctx.device)
        self.attempted = 0
        self.calls = []  # (sample set index, [six matrices], metrics)

    def setup(self):
        from ldt_torch.eval import metrics

        n, pts = self.p["clouds"], self.ctx.config["data"][
            "te_max_sample_points"]
        self.ref = shapes.synthetic_shapes(n, pts, shapes.rng(self.ctx.seed,
                                                              20))
        self.smps = [shapes.synthetic_shapes(n, pts, shapes.rng(
            self.ctx.seed, 21 + i)) for i in range(self.p["sample_sets"])]
        self.metrics = metrics
        self._recording = None
        inner = metrics.pairwise_EMD_CD

        def recorder(*args, **kw):
            out = inner(*args, **kw)
            if self._recording is not None:
                self._recording.extend(out)
            return out

        self._inner = inner
        metrics.pairwise_EMD_CD = recorder
        self._call(0, keep=False)

    def _call(self, i: int, keep: bool = True):
        smp = self.smps[i % len(self.smps)]
        self._recording = [] if keep else None
        res = self.metrics.compute_all_metrics(
            smp, self.ref, self.p["batch_size"], verbose=False,
            device=self.dev)
        if keep:
            self.calls.append((i % len(self.smps), self._recording, res))
        self._recording = None
        return res

    def unit(self):
        self._call(len(self.calls))
        n = self.p["clouds"]
        return {"pairs": 3 * n * n}

    def end_to_end(self, window_s, counts_):
        return {"eval_pairs_per_s": counts_["pairs"] / window_s}

    def traced(self, stretch):
        stretch.begin()
        self.unit()
        stretch.end()
        n, pts = self.p["clouds"], self.ctx.config["data"][
            "te_max_sample_points"]
        return {"steps": 1, "calls": 1, "clouds": n, "points": pts}

    def release(self):
        self.metrics.pairwise_EMD_CD = self._inner
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision: str = "f32"):
        picks, got_cd, got_emd = self._picks()
        cd, emd = self._reference(picks, precision)
        return self.gaps(self._metric_gap(), got_cd, got_emd, cd, emd)

    def control(self, precision: str):
        """The check's numbers with the reference in `precision` in the
        program's place (the metrics' stage is the same code)."""
        picks, _, _ = self._picks()
        cd, emd = self._reference(picks, precision)
        return self.gaps(self._metric_gap(), cd, emd,
                         *self._reference(picks, "f32"))

    def gaps(self, metric_gap, got_cd, got_emd, cd, emd):
        lim = self.ctx.limits
        self.attempted = len(self.calls)
        out = [("metrics", metric_gap, lim["metrics"]),
               ("cd", float(np.max(np.abs(got_cd - cd) / np.abs(cd))),
                lim["cd"]),
               ("emd", float(np.max(np.abs(got_emd - emd) / np.abs(emd))),
                lim["emd"])]
        return out

    def _metric_gap(self) -> float:
        """The largest gap of a call's metrics from the reference's metrics
        of the call's own matrices."""
        gap = 0.0
        for _, mats, res in self.calls:
            want = ref_eval.all_metrics(*mats)
            gap = max([gap] + [abs(float(res[k]) - v)
                               for k, v in want.items()])
        return gap

    def _picks(self):
        """`check_pairs` entries drawn from the seed across the calls and
        matrices: ([(x, y)], their recorded CD and EMD)."""
        rng = np.random.default_rng([self.ctx.seed, 30])
        n = self.p["clouds"]
        picks, got_cd, got_emd = [], [], []
        for _ in range(self.p["check_pairs"]):
            call, which = int(rng.integers(len(self.calls))), \
                int(rng.integers(3))
            i, j = int(rng.integers(n)), int(rng.integers(n - 1))
            if which and j >= i:  # off the diagonal of a self matrix
                j += 1
            smp = self.smps[self.calls[call][0]]
            a, b = ((self.ref, smp), (self.ref, self.ref),
                    (smp, smp))[which]
            picks.append((a[i], b[j]))
            mats = self.calls[call][1]
            got_cd.append(mats[2 * which][i, j])
            got_emd.append(mats[2 * which + 1][i, j])
        return (picks, np.array(got_cd, np.float64),
                np.array(got_emd, np.float64))

    def _reference(self, picks, precision: str):
        """The reference's CD and EMD of the picked pairs, in blocks."""
        x = torch.as_tensor(np.stack([a for a, _ in picks]), device=self.dev)
        y = torch.as_tensor(np.stack([b for _, b in picks]), device=self.dev)
        cd, emd = [], []
        block = self.p["check_block"]
        with Precision.use(precision):
            for s in range(0, len(picks), block):
                cd.append(ref_eval.chamfer(x[s:s + block], y[s:s + block]))
                emd.append(ref_eval.approx_match_cost(
                    x[s:s + block], y[s:s + block]) / y.shape[1])
        return (torch.cat(cd).double().cpu().numpy(),
                torch.cat(emd).double().cpu().numpy())
