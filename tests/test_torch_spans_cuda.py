"""The port's spans (audio_inpainting_torch/utils/profiling.py) on the
card: in a profiler session of CUDA activity alone, primed and closed as
the benchmark's traced slices are (benchmark/trace.py), spans are
recorded, and every launch made inside a span starts within that span's
stamps: the spans and CUPTI's runtime records share one clock. This test
needs a GPU and skips without one; it imports no JAX:

    python -m pytest --noconftest -q -s tests/test_torch_spans_cuda.py
"""

import time

import pytest
import torch

from audio_inpainting_torch.utils import profiling

SPANS = 20
LAUNCHES = 50          # a span's launches
SLACK_US = 5.0         # how far a launch may start outside its span's stamps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_launches_inside_a_span_start_within_its_stamps(cuda):
    from benchmark import trace

    x = torch.zeros(1 << 16, device=cuda)
    x.add_(1)
    torch.cuda.synchronize()
    since = time.time_ns()
    prof = trace.session(ops=False)
    enabled = torch.autograd._profiler_enabled()
    for _ in range(SPANS):
        with profiling.span("test.launches", clips=1):
            for _ in range(LAUNCHES):
                x.add_(1)
        time.sleep(0.001)      # nothing launched between spans
    torch.cuda.synchronize()
    trace.close(prof)
    assert enabled, "torch.autograd._profiler_enabled() is false in a CUDA-only session"
    recorded = [s for s in profiling.spans(since) if s.name == "test.launches"]
    assert len(recorded) == SPANS
    launches = sorted(e.start for e in trace.events(prof)
                      if e.kind == "runtime" and trace.LAUNCH_CALLS.search(e.name))
    assert len(launches) == SPANS * LAUNCHES
    # the k-th span's launches are the k-th LAUNCHES of the slice: how far
    # each starts outside its span (negative: inside, by that much)
    outside = [max(max(s.start_ns / 1e3 - t, t - s.end_ns / 1e3)
                   for t in launches[k * LAUNCHES:(k + 1) * LAUNCHES])
               for k, s in enumerate(recorded)]
    first = [launches[k * LAUNCHES] - s.start_ns / 1e3 for k, s in enumerate(recorded)]
    last = [s.end_ns / 1e3 - launches[(k + 1) * LAUNCHES - 1] for k, s in enumerate(recorded)]
    print(f"\nlargest offset of a launch outside its span: {max(outside):.3f} us "
          f"(negative: inside); the first launch {min(first):.3f}-{max(first):.3f} us "
          f"after its span's start, the last {min(last):.3f}-{max(last):.3f} us "
          f"before its end ({torch.cuda.get_device_name(cuda)})")
    assert max(outside) <= SLACK_US
