"""epoch_mfu_pct: the training epochs' share of the chip's peak, %.

The convolution FLOPs of one clip-epoch (``counting.epoch_flops``, at the
configuration's widths and the clip's padded spectrogram) times the
clip-epochs that the traced ``device`` slice (device activity alone) ran,
over the slice's seconds and the peak FLOP/s of the configuration's conv
dtype. BatchNorm, elementwise work and Adam are not counted, so this is a
floor; the slice's analysis, readout and synthesis time is in the
denominator.
"""

from benchmark import counting


def read(ctx):
    window = ctx.reading.window_s
    if not ctx.clip_epochs or window <= 0 or not ctx.reading.device:
        return None
    flops = counting.epoch_flops(ctx.config, *ctx.clip_shape) * ctx.clip_epochs
    return 100.0 * flops / window / counting.peak_flops(ctx.config)
