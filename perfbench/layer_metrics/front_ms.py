"""Device time of the operations launched inside the program's
``xmtpu_torch.mixfirst`` and ``xmtpu_torch.normalize`` ranges, ms per
batch. Layer: the step's front (mix, rate conversion, peak normalize)."""

RANGES = ("xmtpu_torch.mixfirst", "xmtpu_torch.normalize")


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(*RANGES)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
