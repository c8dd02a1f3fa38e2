"""The voice-effects chain through the public effects entry:
``xmtpu_torch.effects(pcm, sr, chain, device_out=True)`` on (B, n, 1)
float32 tracks on the device -> the same layout on the device. The
chain is the configuration's, in order: noise suppression, the EQ
bands, the reverb (a synthetic IR made by the program's
``synthetic_ir``, passed as a float32 array), the volume, the limiter.
``config["call"]`` passes further keywords to ``effects`` (an engine,
for a run on the CPU's twins)."""

from __future__ import annotations

import numpy as np


def chain(c: dict) -> list:
    """The effects list of a configuration's ``chain`` block."""
    from xmtpu_torch.ops.reverb import synthetic_ir

    sr = int(c["sample_rate"])
    return [
        {"name": "noise_suppression", "params": dict(c["ns"])},
        {"name": "equalizer", "params": {"bands": [dict(b) for b in c["bands"]]}},
        {"name": "reverb", "params": {
            "ir": synthetic_ir(float(c["ir_seconds"]), sr,
                               seed=int(c["ir_seed"])).astype(np.float32),
            "wet": float(c["wet"]), "dry": float(c["dry"])}},
        {"name": "volume", "params": {"gain_db": float(c["volume_db"])}},
        {"name": "limiter", "params": dict(c["limiter"])},
    ]


def build(config: dict, traffic: dict, device):
    from xmtpu_torch import effects

    c = config["chain"]
    sr = int(c["sample_rate"])
    if int(traffic["sample_rate"]) != sr:
        raise ValueError("the traffic's rate is not the chain's rate")
    effect_list = chain(c)
    kw = dict(config.get("call", {}))

    def call(batch):
        return effects(batch["pcm"], sr, effect_list, device=device,
                       device_out=True, **kw)

    return call
