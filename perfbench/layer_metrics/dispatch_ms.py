"""Host time inside the program's entry ranges (``xmtpu_torch.step``,
``xmtpu_torch.effects``) on the traced window's host thread, clipped to
the window, ms per batch: the time the host spends issuing a batch's
work. Layer: the entry's host dispatch.

It is read under the profiler, which records every aten op, so it reads
above the host's time in an untraced run; compare it only with itself."""

RANGES = ("xmtpu_torch.step", "xmtpu_torch.effects")


def read(ctx):
    t = ctx.trace
    host = t._threads.get(t.host)
    if host is None:
        return None
    spans = sorted((max(s, t.t0), min(e, t.t1)) for s, e, name in host.r
                   if name in RANGES)
    total, end = 0.0, t.t0
    for s, e in spans:  # the union: an entry may call another inside it
        s = max(s, end)
        if e > s:
            total += e - s
            end = e
    if not spans:
        return None
    return total / 1e3 / ctx.batches
