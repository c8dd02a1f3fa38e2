"""Kernel launches, memcpys and memsets on the card inside the program's
``xmtpu_torch.duck`` range, per batch: the ducking stage's dispatch
count. Layer: the mixer's side-chain ducking."""

RANGE = "xmtpu_torch.duck"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return len(ops) / ctx.batches
