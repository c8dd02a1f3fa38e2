"""The loudness stage's share of its roofline: the stage's least time
(``roofline_mix.lufs_stage`` at the reference's shapes: channels,
samples) over the device time of the operations under the program's
``xmtpu_torch.lufs`` range per batch. Layer: the mixer's loudness
normalization."""

from perfbench import roofline_mix

RANGE = "xmtpu_torch.lufs"


def read(ctx):
    st = ctx.stages.get("lufs")
    if st is None:
        return None
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    from perfbench.layer_metrics import _stage

    return _stage.share(ctx, ops, roofline_mix.lufs_stage(**st))
