"""The program's spans laid over a traced stretch (`readers.program_spans`)
and the span readers, on planted kineto events; the span metrics listed in
`BENCHMARK.json`, each on spans the program opens; the traced run of each
cell, which records the spans, at the tiny size on the CPU."""

import re
from pathlib import Path

import pytest

from benchmark import harness, trace_spans
from benchmark.readers import program_spans, span_idle, span_ms, trace
from benchmark.tests import tiny
from ldt_torch.tools.profiling import Span

REPO = Path(__file__).resolve().parents[2]
SPAN_READERS = trace_spans.SPAN_READERS

LO = 1_792_000_000_000_000_000  # ns since the epoch, as kineto's


class Event:
    """A kineto event: on the device (a kernel or copy) or on the host (a
    runtime call), with its correlation id."""

    def __init__(self, name, start, dur, corr, device=True, act=None):
        self._name, self._start, self._dur, self._corr = name, start, dur, corr
        self._device = device
        self._act = act or ("kernel" if device else "cuda_runtime")

    def name(self):
        return self._name

    def start_ns(self):
        return LO + self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"

    def activity_type(self):
        return self._act

    def correlation_id(self):
        return self._corr


def _span(name, id_, parent, start, end, step=0):
    return Span(name, id_, parent, step, LO + start, LO + end)


# one stage-2 step: its batch copies a cloud up, the encode and the
# optimizer launch a kernel each, the loss two, the step itself one after
# them; one kernel is launched after the step (ns from LO)
SPANS = [_span("train.step", 0, -1, 1000, 10000),
         _span("train.batch", 1, 0, 1000, 2000),
         _span("train.encode", 2, 0, 2000, 4000),
         _span("train.loss", 3, 0, 4000, 6000),
         _span("train.optimizer", 4, 0, 6000, 9000)]
LAUNCH = "cudaLaunchKernel"
EVENTS = [Event("cudaMemcpyAsync", 1500, 10, 1, device=False),
          Event(LAUNCH, 2500, 10, 2, device=False),
          Event(LAUNCH, 4500, 10, 3, device=False),
          Event(LAUNCH, 4600, 10, 7, device=False),
          Event(LAUNCH, 6500, 10, 4, device=False),
          Event(LAUNCH, 9500, 10, 5, device=False),
          Event(LAUNCH, 11000, 10, 6, device=False),
          Event("Memcpy HtoD (Pageable -> Device)", 1800, 400, 1,
                act="gpu_memcpy"),
          Event("encoder_kernel", 3500, 1000, 2),
          Event("sm90_xmma_gemm_f32", 5000, 2000, 3),
          Event("packed_self_attention_tiled_kernel", 5000, 100, 7),
          Event("multi_tensor_apply_kernel", 7000, 1000, 4),
          Event("packed_self_attention_bwd_tiled_kernel", 9600, 200, 5),
          Event("approx_match_cluster_kernel", 11500, 100, 6)]


@pytest.fixture
def summary():
    return program_spans.summarize(EVENTS, 2e-5, SPANS)


def test_events_are_credited_to_the_span_that_launched_them(summary):
    got = {k[0]: i for k, i in zip(summary["kernels"],
                                   summary["kernel_spans"])}
    assert got == {"Memcpy HtoD (Pageable -> Device)": 1,
                   "encoder_kernel": 2, "sm90_xmma_gemm_f32": 3,
                   "packed_self_attention_tiled_kernel": 3,
                   "multi_tensor_apply_kernel": 4,
                   "packed_self_attention_bwd_tiled_kernel": 0,
                   "approx_match_cluster_kernel": None}
    # span times share the kernels' origin (the first host event)
    assert summary["spans"][0][4:] == pytest.approx([-500e-9, 8500e-9])
    assert summary["kernels"][0][1] == pytest.approx(300e-9)


def test_span_ms_self_time_children_and_per(summary):
    def read(spans, per="train.step", children=False):
        m = {"spans": spans, "per": per, "children": children}
        return span_ms.read(m, summary, {})

    assert read(["train.encode"]) == pytest.approx(1000e-6)
    assert read(["train.loss", "train.optimizer"]) == pytest.approx(3100e-6)
    assert read(["train.step"]) == pytest.approx(200e-6)  # self time
    assert read(["train.step"], children=True) == pytest.approx(4700e-6)
    # per a `train.batch` span: one of them
    assert read(["train.batch"], per="train.batch") == pytest.approx(400e-6)
    assert read(["train.encode"], per="sample.step") is None


def test_span_idle_innermost_and_with_children(summary):
    def read(spans, children=False):
        m = {"spans": spans, "per": "train.step", "children": children}
        return span_idle.read(m, summary, {})

    # idle gaps: 2200-3500 (host in the encode), 4500-5000 (the loss),
    # 8000-9600 (the optimizer to 9000, then the step), 9800-11500 (the
    # step to 10000, then no span)
    assert read(["train.batch", "train.encode"]) == pytest.approx(1300e-6)
    assert read(["train.loss"]) == pytest.approx(500e-6)
    assert read(["train.optimizer"]) == pytest.approx(1000e-6)
    assert read(["train.step"]) == pytest.approx(800e-6)
    assert read(["train.step"], children=True) == pytest.approx(3600e-6)


def test_idle_gaps_are_labelled_span_then_call(summary):
    gaps = dict(summary["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({
        f"train.encode / {LAUNCH}": 1300e-9,
        f"train.loss / {LAUNCH}": 500e-9,
        f"train.optimizer / {LAUNCH}": 1600e-9,
        f"(no span) / {LAUNCH}": 1700e-9})


def test_a_span_off_the_path_reads_nothing(summary):
    """A metric whose spans were not recorded in the stretch is silent, not
    0, though its `per` spans were: the span has left the path."""
    for read in (span_ms.read, span_idle.read):
        m = {"spans": ["emd.distances"], "per": "train.step"}
        assert read(m, summary, {}) is None
        m = {"spans": ["emd.distances", "train.loss"], "per": "train.step"}
        assert read(m, summary, {}) is not None


def test_readers_find_nothing_without_spans_or_device():
    plain = trace.summarize(EVENTS, 2e-5)
    m = {"spans": ["train.encode"], "per": "train.step"}
    assert span_ms.read(m, plain, {}) is None
    assert span_idle.read(m, plain, {}) is None
    host_only = program_spans.summarize(
        [e for e in EVENTS if not e._device], 2e-5, SPANS)
    assert span_ms.read(m, host_only, {}) is None
    assert span_idle.read(m, host_only, {}) is None


WORK = {"airplane.train_stage2": {"steps": 8, "batch": 64, "points": 2048,
                                  "dtype": "float32"},
        "all55.sample_label": {"steps": 32, "batch": 32, "label": True,
                               "dtype": "float32"},
        "airplane.eval": {"steps": 1, "calls": 1, "clouds": 64,
                          "points": 2048}}


@pytest.mark.parametrize("name", list(WORK))
def test_existing_readers_read_the_same(name):
    """Every per-layer metric `BENCHMARK.json` lists reads the same from
    the summary with the spans as from `trace.summarize`'s, whose every
    key but the idle gaps' labels is kept."""
    c = harness.cell(name)
    work = dict(WORK[name], config=c["config"])
    plain = trace.summarize(EVENTS, 2e-5)
    spans = program_spans.summarize(EVENTS, 2e-5, SPANS)
    for key, value in plain.items():
        if key != "breakdown":
            assert spans[key] == value, key
    assert spans["breakdown"]["device_ops"] == plain["breakdown"][
        "device_ops"]
    # the same gaps, split further by span
    assert sum(s for _, s in spans["breakdown"]["idle_gaps"]) == \
        pytest.approx(sum(s for _, s in plain["breakdown"]["idle_gaps"]))
    for m in c["per_layer"]:
        if m["reader"] in SPAN_READERS:  # nothing to read without spans
            continue
        read = harness.reader(m["reader"])
        assert read(m, spans, work) == read(m, plain, work), m["name"]
        assert read(m, plain, work) is not None, m["name"]


def program_span_names() -> set:
    """The names of the spans `ldt_torch` opens (`profiling.span("...")`
    in its sources)."""
    pattern = re.compile(r"profiling\.span\(\s*\"([^\"]+)\"")
    return {n for p in (REPO / "ldt_torch").rglob("*.py")
            for n in pattern.findall(p.read_text())}


def test_span_metrics_have_their_files_and_the_programs_spans():
    """Every per-layer metric that reads spans has its metric file, and its
    `spans` and `per` are spans the program opens."""
    opened = program_span_names()
    assert {"train.step", "sample.step", "eval.call"} <= opened
    listed = [m for w in harness.spec()["workloads"]
              for m in harness.cell(w["name"])["per_layer"]
              if m["reader"] in SPAN_READERS]
    assert len(listed) >= 7
    for m in listed:
        assert m["source"] == "device_trace" and len(m["workloads"]) == 1
        assert set(m["spans"]) <= opened, m["name"]
        assert m["per"] in opened, m["name"]
    assert not (harness.ROOT / "span_metrics.json").exists()


@pytest.mark.parametrize("name", list(WORK))
def test_span_run_on_the_cpu(name):
    """A cell's traced run through the harness, tiny on the CPU: correct,
    the program's spans recorded in the stretch, the span metrics silent
    (no device)."""
    stretch = program_spans.Stretch("cpu")
    r = tiny.run(name, True, stretch=stretch)
    assert r["correct"] and stretch.spans
    span_metrics = {m["name"] for m in harness.cell(name)["per_layer"]
                    if m["reader"] in SPAN_READERS}
    assert span_metrics and span_metrics <= set(r["silent"])
    assert all(" / " in label for label, _ in r["breakdown"]["idle_gaps"])


def test_trace_spans_on_the_cpu():
    """`trace_spans.py`'s run: the result line with the coverage keys, the
    compared numbers last; on the CPU no device time to cover."""
    name = "airplane.eval"
    config, params = tiny.cut(harness.cell(name)["traffic"]["runner"])
    r = trace_spans.run(name, tiny.SEED, device="cpu", config_over=config,
                        params_over=params)
    assert r["correct"] and r["span_coverage"] is None
    assert list(r)[-1] == "checks"
