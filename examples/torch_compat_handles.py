"""Reference-style handle API on the PyTorch port: the call shape of
``xm_audio_utils`` (counterpart of ``compat_handles.py``).

Every handle the upstream C library exposes (mixer, voice effects,
decoder, async generator) driven the way a migrated call site would.

    python examples/torch_compat_handles.py [workdir] [--device cpu]
"""

import argparse
import json
import tempfile

import numpy as np

from xmtpu_torch import compat
from xmtpu_torch.io.wav import read_wav, write_wav


def main(workdir: str, device=None) -> None:
    sr = 16000
    rng = np.random.default_rng(7)
    voice_path = f"{workdir}/voice.wav"
    write_wav(voice_path,
              (9000 * rng.standard_normal(sr * 2)).astype(np.int16), sr)

    h = compat.XmAudioUtils(device=device)

    # -- decoder handle (audio_decoder_create / seekTo / get_pcm) --
    h.decoder_create(voice_path)
    h.decoder_seek(500.0)
    chunk = h.decoder_get_pcm(1024)
    print(f"decoder: {chunk.shape} int16 from 500 ms")
    h.decoder_freep()

    # -- mixer handle (mixer_init / mixer_seek / mixer_get_frame) --
    cfg = {"sampleRate": sr, "tracks": [
        {"url": voice_path, "volume": 0.9, "fadeInTimeMs": 50}]}
    h.mixer_init(json.dumps(cfg))
    h.mixer_seek(0.0)
    n_frames = 0
    while h.mixer_get_frame() is not None:
        n_frames += 1
    print(f"mixer: {n_frames} frames of 20 ms, then end-of-stream")

    # -- voice-effects handle (xm_audio_effects_*) --
    chain = [{"name": "equalizer", "params": {"bands": [
                 {"freq_hz": 1000.0, "gain_db": 3.0, "q": 1.0}]}},
             {"name": "limiter", "params": {"threshold_db": -6.0}}]
    h.effects_init({"effects": chain, "sampleRate": sr}, voice_path)
    h.effects_seek(250.0)
    frame = h.effects_get_frame()
    print(f"effects: {frame.shape} int16 frame from 250 ms")
    h.freep()

    # -- async generator (xm_audio_generator_start / progress / wait) --
    out_path = f"{workdir}/mixed.wav"
    g = compat.XmAudioGenerator(device=device)
    g.start(json.dumps({**cfg, "normalize": "peak"}), out_path)
    status = g.wait(120)
    pcm, out_sr = read_wav(out_path)
    print(f"generator: status {status} progress {g.get_progress():.0f}% "
          f"-> {out_path} ({pcm.shape[0]} samples @ {out_sr} Hz)")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    a = p.parse_args()
    if a.workdir:
        main(a.workdir, a.device)
    else:
        with tempfile.TemporaryDirectory() as d:
            main(d, a.device)
