"""Shared by the roofline readers: a stage's least time over its device
time per batch, in percent."""

from perfbench import roofline


def share(ctx, ops, counts):
    if not ops or ctx.peaks is None:
        return None
    t = ctx.trace.device_time_s(ops) / ctx.batches
    if t <= 0:
        return None
    return 100.0 * roofline.least_seconds(*counts, ctx.peaks) / t
