"""The ducking stage's share of its roofline: the stage's least time
(``roofline_mix.duck_stage`` at the reference's shapes: channels,
samples) over the device time of the operations under the program's
``xmtpu_torch.duck`` range per batch. Layer: the mixer's side-chain
ducking."""

from perfbench import roofline_mix

RANGE = "xmtpu_torch.duck"


def read(ctx):
    st = ctx.stages.get("duck")
    if st is None:
        return None
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    from perfbench.layer_metrics import _stage

    return _stage.share(ctx, ops, roofline_mix.duck_stage(**st))
