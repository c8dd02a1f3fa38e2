"""The voice-effects chain with the adaptive noise estimate, called as
``voice_effects`` calls it: ``xmtpu_torch.effects(pcm, sr, chain,
device_out=True)`` on (B, n, 1) float32 tracks on the device.

The configuration holds the program to the float64 definition's tracker
decisions (its ``program_float64``). A program whose adaptive suppressor
has no float64 tracker (``xmtpu_torch.kernels.ns.track``) decides from
float32 spectra: on minute-long tracks about one in 8 to 16 flips
decisions and reads about -60 to -72 dB against the -80 dB guarantee,
and it steps the frames from the host, about 100,000 launches a batch.
Such a program is refused at set-up, before any batch is made, and the
run exits with an error in place of a result line."""

from __future__ import annotations

from perfbench.entries import voice_effects


def build(config: dict, traffic: dict, device):
    from xmtpu_torch.kernels import ns

    if not callable(getattr(ns, "track", None)):
        raise RuntimeError(
            f"{config['name']}: this program's adaptive noise suppressor "
            "has no float64 tracker (xmtpu_torch.kernels.ns.track); its "
            "float32 decisions cannot hold the configuration's "
            f"{config['limit_db']} dB guarantee")
    return voice_effects.build(config, traffic, device)
