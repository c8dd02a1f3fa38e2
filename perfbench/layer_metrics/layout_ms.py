"""Device time of the operations launched inside the program's
``xmtpu_torch.layout`` ranges, ms per batch: the entry's copies between
the caller's time-first layout and the device's time-last one
(``api._to_f32_device``, ``api._from_f32_device``). Layer: the entry's
layout copies."""

RANGE = "xmtpu_torch.layout"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
