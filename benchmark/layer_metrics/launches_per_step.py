"""launches_per_step: the launches of one denoising evaluation of the SD
sampler, read in the traced ``device`` slice (device activity alone).

The runtime calls that queue a kernel, a copy or a memset
(``trace.LAUNCH_CALLS``) whose start falls inside a port ``sd.step`` span
that lies wholly in the slice, over the number of those spans. None where
no whole ``sd.step`` span lies in the slice, where the port's buffer
dropped a span that may lie in it, or where the port records no spans.
"""

import bisect

from benchmark import trace
from benchmark.layer_metrics.sd_mfu_pct import whole_spans


def read(ctx):
    r = ctx.reading
    steps = whole_spans(r, ("sd.step",))
    if not steps:
        return None
    starts = sorted(e.start for e in r.events
                    if e.kind == "runtime" and trace.LAUNCH_CALLS.search(e.name))
    launches = sum(bisect.bisect_right(starts, s.end_ns / 1e3)
                   - bisect.bisect_left(starts, s.start_ns / 1e3) for s in steps)
    return launches / len(steps)
