"""Device time of the operations launched inside the program's
``xmtpu_torch.lufs`` range (BS.1770 loudness normalization: the
K-weighting, the block powers and gates, the gain's product), ms per
batch. Layer: the mixer's loudness normalization."""

RANGE = "xmtpu_torch.lufs"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
