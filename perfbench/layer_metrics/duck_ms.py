"""Device time of the operations launched inside the program's
``xmtpu_torch.duck`` range (the mixer's side-chain ducking: the gain's
float64 scans and knee, the ducked bus's product and sum), ms per batch.
Layer: the mixer's side-chain ducking."""

RANGE = "xmtpu_torch.duck"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
