"""audio_rtf.gan: ``audio_rtf`` read in the traced ``device`` slice (device
activity alone), audio_s/s: clip seconds x the slice's clip-epochs /
epochs a request / the slice's seconds.

In a cell whose epochs the host paces, this wall-clock rate swings with
the host's speed from process to process; the cell's end-to-end rate is
``audio_per_device_s``, and this reading shows how much of it the host
lets through.
"""


def read(ctx):
    window = ctx.reading.window_s
    if not ctx.clip_epochs or window <= 0 or not ctx.reading.device:
        return None
    t = ctx.traffic
    return t["clip_seconds"] * ctx.clip_epochs / t["epochs"] / window
