"""`ldt_torch.tools.profiling`'s span recorder: its rules, the spans the
stage-2 step, the sampler and the eval record at tiny sizes on the CPU,
and its clock against the profiler's. Imports no JAX (it runs on the card
too: python -m pytest --noconftest tests/test_torch_port_spans.py)."""

import numpy as np
import pytest
import torch

from ldt_torch.tools import profiling


@pytest.fixture(autouse=True)
def _off():
    profiling.stop()
    yield
    profiling.stop()


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_records_nothing_and_allocates_no_span():
    assert profiling.span("a") is profiling.span("b", 3)
    with profiling.span("a"):
        pass
    assert profiling.stop() == []


def test_nesting_parents_ids_and_steps():
    profiling.start()
    with profiling.span("outer", 7):
        with profiling.span("inner"):
            with profiling.span("leaf"):
                pass
        with profiling.span("inner"):
            pass
    for _ in range(2):
        with profiling.span("top"):
            with profiling.span("child"):
                pass
    spans = profiling.stop()
    assert [(s.name, s.id, s.parent, s.step) for s in spans] == [
        ("outer", 0, -1, 7), ("inner", 1, 0, 7), ("leaf", 2, 1, 7),
        ("inner", 3, 0, 7), ("top", 4, -1, 0), ("child", 5, 4, 0),
        ("top", 6, -1, 1), ("child", 7, 6, 1)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_spans_entered_off_or_left_open_are_dropped():
    with profiling.span("entered_off"):
        profiling.start()
        with profiling.span("kept"):
            pass
        opened = profiling.span("left_open")
        opened.__enter__()
        spans = profiling.stop()
    opened.__exit__(None, None, None)
    assert [(s.name, s.parent) for s in spans] == [("kept", -1)]
    # a span open across stop() and start() is not kept in the next
    profiling.start()
    straddle = profiling.span("straddle")
    straddle.__enter__()
    profiling.stop()
    profiling.start()
    straddle.__exit__(None, None, None)
    with profiling.span("fresh"):
        pass
    assert [s.name for s in profiling.stop()] == ["fresh"]


def test_stop_returns_and_clears():
    profiling.start()
    with profiling.span("a"):
        pass
    assert [s.name for s in profiling.stop()] == ["a"]
    assert profiling.stop() == []
    with profiling.span("b"):
        pass
    assert profiling.stop() == []


def test_a_span_is_closed_by_an_exception():
    profiling.start()
    with pytest.raises(ValueError):
        with profiling.span("outer"):
            with profiling.span("raises"):
                raise ValueError("x")
    with profiling.span("after"):
        pass
    assert [(s.name, s.parent) for s in profiling.stop()] == [
        ("outer", -1), ("raises", 0), ("after", -1)]


def test_clock_matches_the_profilers_timeline():
    """CPU aten ops run inside a span fall inside it on the profiler's
    timeline, and the ops just before and after it fall outside."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.start()
        torch.mm(x, x)
        with profiling.span("clock"):
            torch.addmm(x, x, x)
            torch.bmm(x[None], x[None])
        torch.exp(x).sum()
        (span,) = profiling.stop()
    ops = {}
    for e in prof.profiler.kineto_results.events():
        ops.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in ("aten::addmm", "aten::bmm"):
        for s, e in ops[name]:
            assert span.start_ns <= s and e <= span.end_ns, name
    assert max(e for _, e in ops["aten::mm"]) <= span.start_ns
    assert span.end_ns <= min(s for s, _ in ops["aten::exp"])


TINY_SCORE = dict(z_dim=8, z_scale=8, hidden_size=64, num_heads=4,
                  num_blocks=2, t_dim=64)
TINY_COMP = dict(outsize=64, max_outputs=64, z_dim=4, z_scales=8, p_dim=32,
                 n_layers=2, hidden_dim=32, num_heads=2)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_trainer_update_spans():
    """One `Trainer.update`: one `train.step` of the iteration, holding
    the batch, the encode, the loss, the backward and the optimizer in
    that order."""
    from ldt_torch.configs import latent_trainer_cfg
    from ldt_torch.training.latent_sde_trainer import Trainer

    cfg = latent_trainer_cfg(
        score=TINY_SCORE, compressor=TINY_COMP,
        sde=dict(sample_N=8, train_N=8),
        data=dict(batch_size=2, tr_max_sample_points=64,
                  te_max_sample_points=64))
    tr = Trainer(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    data = {"tr_points": np.random.default_rng(0).normal(
        size=(2, 64, 3)).astype(np.float32)}
    tr.update(data)
    profiling.start()
    tr.update(data)
    spans = profiling.stop()
    (step,) = _by_name(spans, "train.step")
    assert step.step == 1 and step.parent == -1
    assert _children(spans, step) == ["train.batch", "train.encode",
                                      "train.loss", "train.backward",
                                      "train.optimizer"]
    assert len(spans) == 6 and all(s.step == 1 for s in spans)


@pytest.mark.parametrize("label", [False, True])
def test_sampler_step_spans(label):
    """`sample_discrete` over N steps (through `generate.sample_latents`,
    hoisted or with a label): N `sample.step` spans of the step index,
    each holding one `sample.score`."""
    from ldt_torch.configs import score_cfg, sde_cfg
    from ldt_torch.diffusion import make_diffusion
    from ldt_torch.generate import sample_latents
    from ldt_torch.models import Score

    steps = 5
    cats = 3 if label else 1
    score = Score(score_cfg(**TINY_SCORE, num_categorys=cats),
                  device="cpu", generator=torch.Generator().manual_seed(1))
    sde = make_diffusion(sde_cfg(sample_N=steps), device="cpu")
    lab = torch.tensor([0, 2]) if label else None
    profiling.start()
    sample_latents(score, sde, 2, steps, device="cpu", label=lab,
                   generator=torch.Generator().manual_seed(2))
    spans = profiling.stop()
    steps_ = _by_name(spans, "sample.step")
    assert [s.step for s in steps_] == list(range(steps))
    for s in steps_:
        assert s.parent == -1 and _children(spans, s) == ["sample.score"]
    assert len(spans) == 2 * steps


def test_eval_call_spans():
    """`compute_all_metrics`: one `eval.call` holding every tile of its
    three matrices, each tile an `emd.distances` and an `eval.copy`."""
    from ldt_torch.eval import metrics

    rng = np.random.default_rng(3)
    smp = rng.normal(size=(6, 32, 3)).astype(np.float32)
    ref = rng.normal(size=(5, 32, 3)).astype(np.float32)
    profiling.start()
    metrics.compute_all_metrics(smp, ref, 2, verbose=False, device="cpu")
    spans = profiling.stop()
    (call,) = _by_name(spans, "eval.call")
    tiles = 0
    for a, b in ((ref, smp), (ref, ref), (smp, smp)):
        sb, rb = metrics._tile_shape(len(a), len(b), 2, None, 32, 32)
        tiles += len(list(metrics._iter_blocks(len(a), sb))) * \
            len(list(metrics._iter_blocks(len(b), rb)))
    got = _by_name(spans, "eval.tile")
    assert len(got) == tiles > 3
    assert _children(spans, call) == ["eval.tile"] * tiles
    for t in got:
        assert _children(spans, t) == ["emd.distances", "eval.copy"]
    assert len(spans) == 1 + 3 * tiles
