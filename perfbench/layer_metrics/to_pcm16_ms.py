"""Device time of the operations launched inside the program's
``xmtpu_torch.to_pcm16`` range, ms per batch. Layer: the step's last
stage, the float32 -> int16 conversion (``ops/convert.f32_to_pcm16``)."""

RANGE = "xmtpu_torch.to_pcm16"


def read(ctx):
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        return None
    return 1e3 * ctx.trace.device_time_s(ops) / ctx.batches
