"""Device time of the operations launched inside the program's
``xmtpu_torch.envelope_pass_a`` and ``xmtpu_torch.envelope_pass_b``
ranges, ms per batch: the segmented envelope's two launches of the
envelope core (``kernels/envelope._envelope_seg``), without the segment
chains and the correction between them. Layer: the limiter kernels (K2;
K3/K4 and the curve)."""

RANGES = ("xmtpu_torch.envelope_pass_a", "xmtpu_torch.envelope_pass_b")


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(*RANGES)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
