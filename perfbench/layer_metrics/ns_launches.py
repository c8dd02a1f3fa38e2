"""Kernel launches, memcpys and memsets on the card inside the program's
``xmtpu_torch.ns`` range, per batch: the noise-suppression stage's
dispatch count. Layer: the noise-suppression effect (STFT Wiener)."""

RANGE = "xmtpu_torch.ns"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return len(ops) / ctx.batches
