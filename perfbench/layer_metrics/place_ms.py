"""Device time of the operations launched inside the program's
``xmtpu_torch.mix_place`` ranges (the mixer's placement: the int16
conversion, the resample kernel under ``mix_resample``, the loop, the
gain and fade, the pad and upmix, the bus sums), ms per batch. Layer:
the mixer's placement."""

RANGE = "xmtpu_torch.mix_place"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
