"""The public effects entry: ``xmtpu_torch.effects(pcm, sr, chain,
device_out=True)`` on (B, n, channels) float32 clips on the device ->
the same layout on the device. The chain is the configuration's: the
EQ bands, a synthetic IR made by the program's ``synthetic_ir`` and
passed as a float32 array (as the JAX harness's config 3 passes it),
the limiter's parameters. ``config["call"]`` passes further keywords to
``effects`` (an engine, for a run on the CPU's twins)."""

from __future__ import annotations

import numpy as np


def build(config: dict, traffic: dict, device):
    from xmtpu_torch import effects
    from xmtpu_torch.ops.reverb import synthetic_ir

    c = config["chain"]
    sr = int(c["sample_rate"])
    if int(traffic["sample_rate"]) != sr:
        raise ValueError("the traffic's rate is not the chain's rate")
    chain = [
        {"name": "equalizer", "params": {"bands": [dict(b) for b in c["bands"]]}},
        {"name": "reverb", "params": {
            "ir": synthetic_ir(float(c["ir_seconds"]), sr,
                               seed=int(c["ir_seed"])).astype(np.float32),
            "wet": float(c["wet"]), "dry": float(c["dry"])}},
        {"name": "limiter", "params": dict(c["limiter"])},
    ]
    kw = dict(config.get("call", {}))

    def call(batch):
        return effects(batch["pcm"], sr, chain, device=device,
                       device_out=True, **kw)

    return call
