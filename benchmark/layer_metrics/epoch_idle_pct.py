"""epoch_idle_pct: the share of the traced ``device`` slice (device
activity alone) in which the device idled while the host was inside one
of the port's training epochs, %.

The idle gaps are those of ``device_idle_pct``: the slice less the union of
its kernel, copy and memset intervals. A gap counts where its middle falls
inside a ``unet.epoch`` or ``gan.epoch`` span of the port
(``launches_per_epoch.epoch_spans``), as ``trace.Reading.idle_by_range``
places a gap; the sum over the slice's seconds. So the metric is a part of
``device_idle_pct``, and the rest is the idle time of the request's glue
and of the harness's loop. None where the slice holds no whole epoch span,
where the port's buffer dropped a span that may lie in the slice, or where
the port records no spans.
"""

import bisect

from benchmark.layer_metrics.launches_per_epoch import epoch_spans, whole


def read(ctx):
    r = ctx.reading
    epochs = epoch_spans(r)
    if not epochs or not whole(r, epochs) or r.window_s <= 0:
        return None
    starts = [s for s, _ in epochs]
    idle, prev = 0.0, r.t0
    for s, e in r.busy + [(r.t1, r.t1)]:
        if s > prev:
            mid = (prev + s) / 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and epochs[i][1] >= mid:
                idle += s - prev
        prev = max(prev, e)
    return 100.0 * idle / 1e6 / r.window_s
