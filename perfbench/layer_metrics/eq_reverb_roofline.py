"""The EQ+reverb convolution's share of its roofline: the stage's least
time (``roofline.fir_stage`` at the reference's shapes: rows, samples,
the folded IR's taps) over its device time per batch. The device time is
that of the operations under the program's ``xmtpu_torch.eq+reverb``
range where the program has one (the flagship step); where it has none
(``effects()``, whose chain has no ranges), that of the call's
operations outside every ``xmtpu_torch.*`` range: the convolution plus
the entry's two layout copies. Layer: the K1 kernel."""

from perfbench import roofline

RANGE = "xmtpu_torch.eq+reverb"


def read(ctx):
    st = ctx.stages.get("eq_reverb")
    if st is None:
        return None
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    if not ops:
        ops = [o for o in ctx.trace.ops if "perfbench.batch" in o.stack
               and not any(r.startswith("xmtpu_torch.") for r in o.stack)]
    from perfbench.layer_metrics import _stage

    return _stage.share(ctx, ops, roofline.fir_stage(**st))
