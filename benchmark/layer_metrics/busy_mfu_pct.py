"""busy_mfu_pct: the training epochs' share of the chip's peak while the
device was busy, %.

``epoch_mfu_pct`` over the traced ``device`` slice's busy seconds (the
union of its kernel, copy and memset intervals) instead of its length: the
share that moves ``audio_per_device_s``, which a host that lags the device
leaves as it is. A floor, as ``epoch_mfu_pct`` is.
"""

from benchmark import counting


def read(ctx):
    busy = ctx.reading.busy_s
    if not ctx.clip_epochs or busy <= 0:
        return None
    flops = counting.epoch_flops(ctx.config, *ctx.clip_shape) * ctx.clip_epochs
    return 100.0 * flops / busy / counting.peak_flops(ctx.config)
