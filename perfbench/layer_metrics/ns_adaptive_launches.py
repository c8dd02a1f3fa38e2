"""Kernel launches, memcpys and memsets on the card inside the program's
``xmtpu_torch.ns`` range, per batch: the dispatch count of the
noise-suppression effect with the adaptive estimate (a loop over frames
on the host shows here as launches in proportion to the frames). Layer:
the noise-suppression effect (STFT Wiener)."""

RANGE = "xmtpu_torch.ns"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return len(ops) / ctx.batches
