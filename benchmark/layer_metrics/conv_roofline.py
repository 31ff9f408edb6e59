"""conv_roofline: the training epochs' convolutions against their roofline, %.

The sum over one clip-epoch's convolution calls (forward, data and weight
gradients) of each call's least time on the H100 (``counting``: FLOPs over
the peak of its dtype or bytes, each input read once and each output
written once, over HBM's rate, whichever is larger), times the clip-epochs
of the traced ``ops`` slice, over the device time in which work launched
under the ops named in OPS (cuDNN's convolution kernels and the layout
transposes and bias adds they launch) from inside the ``epoch`` ranges
ran: the union of its intervals, so that kernels overlapping on side
streams count once.
"""

from benchmark import counting

OPS = ("aten::convolution", "aten::convolution_backward")


def read(ctx):
    device_s = ctx.ops_reading.device_s_under(OPS, "epoch")
    if not ctx.ops_clip_epochs or device_s <= 0:
        return None
    bound = counting.epoch_conv_bound_s(ctx.config, *ctx.clip_shape) * ctx.ops_clip_epochs
    return 100.0 * bound / device_s
