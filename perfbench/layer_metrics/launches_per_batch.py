"""Kernel launches, memcpys and memsets on the card in the traced
window, per batch. Layer: the entry's host dispatch."""


def read(ctx):
    if not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.batches
