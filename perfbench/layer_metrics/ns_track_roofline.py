"""The adaptive noise tracker's share of its roofline: the stage's least
time (``roofline_ns_track.track_stage`` at the reference's ``ns_track``
shapes: rows, samples, nfft) over the device time of the operations
under the program's ``xmtpu_torch.ns_track`` range per batch. A program
without that range reads nothing. Layer: the noise-suppression effect
(STFT Wiener)."""

from perfbench import roofline_ns_track

RANGE = "xmtpu_torch.ns_track"


def read(ctx):
    st = ctx.stages.get("ns_track")
    if st is None:
        return None
    ops = [o for o in ctx.trace.ops if o.under(RANGE)]
    from perfbench.layer_metrics import _stage

    return _stage.share(ctx, ops, roofline_ns_track.track_stage(**st))
