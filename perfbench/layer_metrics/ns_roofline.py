"""The noise suppressor's share of its roofline: the stage's least time
(``roofline_ns.ns_stage`` at the reference's shapes: rows, samples,
nfft) over the device time of the operations under the program's
``xmtpu_torch.ns`` range per batch. Layer: the noise-suppression effect
(STFT Wiener)."""

from perfbench import roofline_ns

RANGE = "xmtpu_torch.ns"


def read(ctx):
    st = ctx.stages.get("ns")
    if st is None:
        return None
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    from perfbench.layer_metrics import _stage

    return _stage.share(ctx, ops, roofline_ns.ns_stage(**st))
