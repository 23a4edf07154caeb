"""``device_idle.<cell's loop>``: the share of the traced window in which
no operation ran on the card, one minus the union of the kernels',
copies' and fills' intervals over the window (profiler trace)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
