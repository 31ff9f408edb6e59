"""device_idle_pct: the share of the traced ``device`` slice (device
activity alone) in which no kernel, copy or memset ran on the device (one
minus the union of their intervals over the slice), %."""


def read(ctx):
    r = ctx.reading
    if not r.device or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
