"""The flagship step: ``xmtpu_torch.batch.make_flagship_step`` built
from the configuration's chain, called as ``step(voice_i16, bgm_i16)``
-> int16 (B, n_bus) on the device. ``config["step"]`` passes further
keywords to the factory (the front, a forced branch)."""

from __future__ import annotations


def build(config: dict, traffic: dict, device):
    from xmtpu_torch import batch as tb

    c = config["chain"]
    lim = c["limiter"]
    fixed = {"attack_ms": tb.LIM_ATTACK_MS, "release_ms": tb.LIM_RELEASE_MS,
             "knee_db": 6.0, "ceiling_db": 0.0}
    for key, want in fixed.items():
        if float(lim[key]) != want:
            raise ValueError(f"the flagship step's limiter has {key}={want}; "
                             f"the configuration asks {lim[key]}")
    if float(c["normalize_db"]) != -1.0 or int(c["ir_seed"]) != 7:
        raise ValueError("the flagship step normalizes to -1 dBFS and uses "
                         "the synthetic IR of seed 7")
    if int(traffic["sample_rate"]) != int(c["sr_in"]):
        raise ValueError("the traffic's rate is not the chain's input rate")
    step = tb.make_flagship_step(
        sr_in=int(c["sr_in"]), sr_bus=int(c["sr_bus"]), bands=c["bands"],
        ir_seconds=float(c["ir_seconds"]), wet=float(c["wet"]),
        dry=float(c["dry"]), bgm_gain=float(c["bgm_gain"]),
        fade_ms=float(c["fade_ms"]), threshold_db=float(lim["threshold_db"]),
        device=device, **config.get("step", {}))

    def call(batch):
        return step(batch["voice"], batch["bgm"])

    return call
