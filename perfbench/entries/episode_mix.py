"""The generator's mix through the public mixer: ``xmtpu_torch.mix(tracks,
sr, normalize=..., target_db=..., duck_params=..., voice_effects=...,
device_out=True)`` on row 0 of a batch -> (1, n, channels) on the
device, int16 as the voice track is.

The tracks are the configuration's, each a signal of the traffic: the
voice at ``voice_sr`` (the traffic's rate) whole; the bed read as
``bgm_sr`` material, its first ``bgm_seconds``. The voice chain is
``entries/voice_effects.chain`` of the configuration's ``chain`` block,
made at the bus rate. ``config["chain"]["backend"]``, where given, is
passed to the chain's effects that take one (the kernels' twins, for a
run on the CPU)."""

from __future__ import annotations

BACKEND_EFFECTS = ("equalizer", "reverb", "limiter")


def build(config: dict, traffic: dict, device):
    from perfbench.entries import voice_effects
    from xmtpu_torch import mix

    if int(traffic["sample_rate"]) != int(config["voice_sr"]):
        raise ValueError("the traffic's rate is not the voice's rate")
    if int(traffic["clips_per_batch"]) != 1:
        raise ValueError("the mix takes one episode a call")
    c = config["chain"]
    sr = int(config["sample_rate"])
    if int(c["sample_rate"]) != sr:
        raise ValueError("the voice chain runs at the bus rate")
    effects = voice_effects.chain(c)
    if "backend" in c:
        for e in effects:
            if e["name"] in BACKEND_EFFECTS:
                e["params"]["backend"] = c["backend"]
    # (signal, samples read or None for all, the track's keywords)
    bgm = int(round(float(config["bgm_seconds"]) * int(config["bgm_sr"])))
    specs = []
    for t in config["tracks"]:
        t = dict(t)
        signal = t.pop("signal")
        t["sr"] = int(config["bgm_sr" if signal == "bgm" else "voice_sr"])
        specs.append((signal, bgm if signal == "bgm" else None, t))

    def call(batch):
        tracks = [dict(t, pcm=batch[s][0, :n]) for s, n, t in specs]
        out = mix(tracks, sr, normalize=config["normalize"],
                  target_db=float(config["target_db"]),
                  duck_params=dict(config["duck"]), voice_effects=effects,
                  device=device, device_out=True)
        return out[None] if out.dim() == 2 else out[None, :, None]

    return call
