"""The program's spans on the card's trace. Marked `cuda`; skips without a
card.

    python -m pytest -m cuda benchmark/tests/test_bench_spans_cuda.py
"""

import pytest


@pytest.mark.cuda
def test_kernels_are_credited_to_the_span_that_launched_them():
    """Within a span-recording stretch: kernels launched inside a span are
    credited to it through the correlation ids, their launch calls start
    inside the span's interval on the trace's clock, kernels launched
    outside it are not credited, and crediting follows the launch, not the
    execution (the device runs the span's kernels after it has closed)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.readers import program_spans, trace
    from ldt_torch.tools import profiling

    big = torch.randn(4096, 4096, device="cuda")
    x = torch.randn(256, 256, device="cuda")
    torch.mm(big, big), torch.mm(x, x), x.exp(), x.sin()
    stretch = program_spans.Stretch("cuda")
    stretch.begin()
    for _ in range(8):  # tens of ms queued ahead of the span's kernels
        torch.mm(big, big)
    with profiling.span("inside"):
        for _ in range(4):
            torch.mm(x, x)
        x.exp()
    x.sin()
    stretch.end()
    (span,) = stretch.spans
    summary = stretch.summary()
    events = list(stretch.prof.profiler.kineto_results.events())
    dev, host = program_spans._split(events)
    launch = {trace._call(e, "correlation_id"): trace._ns(e)[0]
              for e in host if trace._call(e, "correlation_id")}
    kernels = [(e, i) for e, i in zip(dev, summary["kernel_spans"])
               if trace._is_kernel(e)]
    inside = [e for e, i in kernels if i == span.id]
    outside = [e for e, i in kernels if i is None]
    assert len(inside) >= 5 and len(outside) >= 9
    assert len(inside) + len(outside) == len(kernels)
    for e, i in kernels:
        t = launch.get(trace._call(e, "correlation_id"))
        assert t is not None, f"no launch call for {e.name()}"
        assert (span.start_ns <= t <= span.end_ns) == (i == span.id)
    assert max(trace._ns(e)[0] for e in inside) > span.end_ns
    assert summary["busy_s"] > 0
