"""The limiter's share of its roofline: the stage's least time
(``roofline.limiter_stage`` at the reference's shapes) over the device
time of the operations under the program's limiter ranges per batch:
``xmtpu_torch.limiter`` (the flagship step's fused kernel), or
``xmtpu_torch.envelope`` and ``xmtpu_torch.curve`` (the envelope kernels
and the torch curve), or ``xmtpu_torch.linked limiter``. Layer: the
limiter kernels (K2; K3/K4 and the curve)."""

from perfbench import roofline

RANGES = ("xmtpu_torch.limiter", "xmtpu_torch.envelope", "xmtpu_torch.curve",
          "xmtpu_torch.linked limiter")


def read(ctx):
    st = ctx.stages.get("limiter")
    if st is None:
        return None
    ops = [o for o in ctx.trace.ops if o.under(*RANGES)]
    from perfbench.layer_metrics import _stage

    return _stage.share(ctx, ops, roofline.limiter_stage(**st))
