"""sd_mfu_pct: the SD sampler's model calls' share of the chip's float32
peak over the device's busy time, %, read in the traced ``device`` slice
(device activity alone).

The port opens a span over each denoising evaluation (``sd.step``) and
each VAE call (``sd.encode``, ``sd.decode``: models/sd/pipeline.py),
stamped on the clock of the profiler's events. The closed-form FLOPs of
each such span that lies wholly in the slice (``counting_sd``: a CFG
evaluation, the canvas's encode, the latents' decode, at the
configuration's widths), summed, over the seconds the device was busy in
the slice (the union of its kernel, copy and memset intervals) and the
float32 peak (67 TFLOP/s, TF32 off). The busy time holds the device's
share of the glue (the analysis, Griffin-Lim) and of the spans cut by the
slice's edges, and norms, activations and the softmax are not counted, so
this is a floor of the rate ``audio_per_device_s`` reads; the host's idle
time is not in it. None where no such span lies wholly in the slice,
where the port's buffer dropped a span that may lie in it, or where the
port records no spans.
"""

from audio_inpainting_torch.utils import profiling
from benchmark import counting_sd, trace

FLOPS = {"sd.step": counting_sd.step_flops, "sd.encode": counting_sd.encode_flops,
         "sd.decode": counting_sd.decode_flops}


def whole_spans(r: trace.Reading, names) -> list | None:
    """The port's spans named in ``names`` that lie wholly in the slice
    ``r``, by start; None where the port records no spans or dropped one
    that may lie in the slice."""
    spans = getattr(profiling, "spans", None)
    if spans is None or not r.events:
        return None
    try:
        found = spans(int(r.t0 * 1e3), int(r.t1 * 1e3))
    except profiling.SpansDropped:
        return None
    return [s for s in found if s.name in names
            and s.start_ns / 1e3 >= r.t0 and s.end_ns / 1e3 <= r.t1]


def read(ctx):
    r = ctx.reading
    found = whole_spans(r, FLOPS)
    if not found or r.busy_s <= 0:
        return None
    flops = sum(FLOPS[s.name](ctx.config) for s in found)
    return 100.0 * flops / r.busy_s / counting_sd.peak_flops(ctx.config)
