"""Device time of the operations launched inside the program's
``xmtpu_torch.ns`` range (the noise-suppression effect with the adaptive
estimate: float64 analysis, the tracker, the synthesis), ms per batch.
Layer: the noise-suppression effect (STFT Wiener)."""

RANGE = "xmtpu_torch.ns"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
