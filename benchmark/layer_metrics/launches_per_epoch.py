"""launches_per_epoch: the launches of one training epoch, read in the
traced ``device`` slice (device activity alone).

The port opens a span over each trainer epoch (``unet.epoch``,
``gan.epoch``: ``audio_inpainting_torch.utils.profiling``), stamped on the
clock of the profiler's events. The runtime calls that queue a kernel, a
copy or a memset (``trace.LAUNCH_CALLS``) whose start falls inside an
epoch span that lies wholly in the slice, over the number of those spans.
None where the slice holds no whole epoch span, where the port's buffer
dropped a span that may lie in the slice, or where the port records no
spans.
"""

import bisect

from audio_inpainting_torch.utils import profiling
from benchmark import trace

EPOCHS = ("unet.epoch", "gan.epoch")


def epoch_spans(r: trace.Reading) -> list[tuple[float, float]] | None:
    """The port's epoch spans that lie in the slice ``r`` wholly or in
    part, as (start, end) in µs by start; None where the port records no
    spans or dropped one that may lie in the slice."""
    spans = getattr(profiling, "spans", None)
    if spans is None or not r.events:
        return None
    try:
        found = spans(int(r.t0 * 1e3), int(r.t1 * 1e3))
    except profiling.SpansDropped:
        return None
    return [(s.start_ns / 1e3, s.end_ns / 1e3) for s in found if s.name in EPOCHS]


def whole(r: trace.Reading, epochs: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The spans of ``epochs`` that lie wholly in the slice ``r``."""
    return [(s, e) for s, e in epochs if s >= r.t0 and e <= r.t1]


def read(ctx):
    r = ctx.reading
    epochs = whole(r, epoch_spans(r) or [])
    if not epochs:
        return None
    starts = sorted(e.start for e in r.events
                    if e.kind == "runtime" and trace.LAUNCH_CALLS.search(e.name))
    launches = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
                   for s, e in epochs)
    return launches / len(epochs)
