"""Float64 reference of the effects chain on (B, n, channels) float32
clips: the EQ (the exact IIR) and the reverb (dry/wet) on every channel,
then the limiter with its channels linked (``precision``: see ``dsp``)."""

from __future__ import annotations

import numpy as np

from perfbench.reference import dsp


def run(config: dict, inputs: dict, precision: str = "float64") -> np.ndarray:
    c = config["chain"]
    sr = int(c["sample_rate"])
    x = np.moveaxis(np.asarray(inputs["pcm"], np.float64), 1, -1)  # (B, ch, n)
    ir = dsp.synthetic_ir(c["ir_seconds"], sr, seed=c["ir_seed"])
    y = dsp.eq_reverb(x, dsp.eq_sos(c["bands"], sr), ir, c["wet"], c["dry"],
                      precision)
    y = dsp.limiter(y, sr, **c["limiter"])
    return np.moveaxis(y, -1, 1)


def stages(config: dict, traffic: dict) -> dict:
    c = config["chain"]
    sr = int(c["sample_rate"])
    B, ch = int(traffic["clips_per_batch"]), int(traffic["channels"])
    n = int(round(traffic["clip_seconds"] * sr))
    sos = dsp.eq_sos(c["bands"], sr)
    ir = dsp.synthetic_ir(c["ir_seconds"], sr, seed=c["ir_seed"])
    return {"eq_reverb": {"rows": B * ch, "n": n,
                          "taps": dsp.folded_taps(sos, ir, c["wet"], c["dry"])},
            "limiter": {"rows": B, "channels": ch, "n": n}}
