"""attention_roofline: the SD model's attention calls against their
roofline, %, read in the traced ``device`` slice (device activity alone).

The port opens a span over each call of its attention
(``sd.attention``, models/sd/unet2d.py ``attention``: the UNet's self- and
cross-attention, 32 a CFG evaluation, and the VAE's), with its batch,
heads, query and key tokens and head width. The sum over the spans that
lie wholly in the slice of each call's bound (``counting_sd.
attention_bound_s``: its two products' FLOPs at the float32 peak or q, k,
v read and the output written once at HBM's rate, the larger), over the
device time of the work those calls launched: the union of the intervals
of the device events whose launch (``trace.LAUNCH_CALLS``, matched by
correlation id) started inside one of those spans. The bound is the
function's own, so the same work reads the same whatever implements it.
None where no whole span lies in the slice, where nothing launched inside
one was recorded, where the port's buffer dropped a span that may lie in
the slice, or where the port records no spans.
"""

import bisect

from benchmark import counting_sd, trace
from benchmark.layer_metrics.sd_mfu_pct import whole_spans

SHAPE = ("batch", "heads", "q_tokens", "k_tokens", "head_dim")


def read(ctx):
    r = ctx.reading
    calls = whole_spans(r, ("sd.attention",))
    if not calls:
        return None
    bound = sum(counting_sd.attention_bound_s(*(s.attrs[k] for k in SHAPE)) for s in calls)
    spans = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in calls]
    starts = [s for s, _ in spans]
    inside = set()
    for e in r.events:
        if e.kind == "runtime" and trace.LAUNCH_CALLS.search(e.name):
            i = bisect.bisect_right(starts, e.start) - 1
            if i >= 0 and e.start <= spans[i][1]:
                inside.add(e.corr)
    ran = trace._union((e.start, e.end) for e in r.device if e.corr in inside)
    device_s = sum(e - s for s, e in ran) / 1e6
    if device_s <= 0:
        return None
    return 100.0 * bound / device_s
