"""Share of the traced window in which no kernel, copy or set runs on
the card: 100 * (1 - union of the device operations' intervals /
window). Layer: the device."""


def read(ctx):
    t = ctx.trace
    if not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
