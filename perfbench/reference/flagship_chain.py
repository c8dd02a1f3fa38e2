"""Float64 reference of the podcast chain: int16 voice and BGM mixed
(``bgm_gain``), converted to the bus rate, faded in and out, peak
normalized, EQ'd (the exact IIR, not folded), reverbed (dry/wet),
limited and rounded to int16 (``precision``: see ``dsp``). Rows are clips; the last axis is time."""

from __future__ import annotations

import numpy as np

from perfbench.reference import dsp


def run(config: dict, inputs: dict, precision: str = "float64") -> np.ndarray:
    c = config["chain"]
    rnd = dsp.rounder(precision)
    sr_in, sr_bus = int(c["sr_in"]), int(c["sr_bus"])
    x = (np.asarray(inputs["voice"], np.float64)
         + c["bgm_gain"] * np.asarray(inputs["bgm"], np.float64)) / 32768.0
    m = dsp.resample(x, sr_in, sr_bus, rnd)
    nb = m.shape[-1]
    fade = int(round(c["fade_ms"] * sr_bus / 1000.0))
    m = dsp.peak_normalize(m * dsp.fade_ramp(nb, fade, fade), c["normalize_db"])
    sos = dsp.eq_sos(c["bands"], sr_bus)
    ir = dsp.synthetic_ir(c["ir_seconds"], sr_bus, seed=c["ir_seed"])
    y = dsp.eq_reverb(m, sos, ir, c["wet"], c["dry"], precision)
    y = dsp.limiter(y[:, None, :], sr_bus, **c["limiter"])[:, 0, :]
    return dsp.to_pcm16(y)


def stages(config: dict, traffic: dict) -> dict:
    """The shapes each stage of this chain reads and writes at the
    traffic's batch (for the roofline counts)."""
    c = config["chain"]
    sr_in, sr_bus = int(c["sr_in"]), int(c["sr_bus"])
    L, M = dsp.ratio(sr_in, sr_bus)
    rows = int(traffic["clips_per_batch"])
    n = int(round(traffic["clip_seconds"] * sr_in))
    nb = -(-n * L // M)
    sos = dsp.eq_sos(c["bands"], sr_bus)
    ir = dsp.synthetic_ir(c["ir_seconds"], sr_bus, seed=c["ir_seed"])
    return {"eq_reverb": {"rows": rows, "n": nb,
                          "taps": dsp.folded_taps(sos, ir, c["wet"], c["dry"])},
            "limiter": {"rows": rows, "channels": 1, "n": nb}}
