"""Float64 reference of the generator's mix (the ``mix48k``
configuration) on batches of int16 voice and bed rows -> int16 (B, n,
channels) (``precision``: see ``dsp``).

Written from definitions, in numpy, scipy and ``torch``'s host FFT (the
suppressor's); it imports nothing of the program:

1. Placement. Each track's int16 row over 32768, converted to the bus
   rate by ``dsp.resample``; a loop track tiled and cut to the program,
   whose length is the end of the last track that does not loop; the
   track's gain times its linear fades (``dsp.fade_ramp``) over its
   placed length; a start offset padded with zeros in front. Three buses
   as the mixer defines them: the voice (kind ``voice``, not ducked),
   the ducked (``side_duck``) and the others.
2. The voice chain on the voice bus, at the bus rate, from
   ``voice_chain``'s stages: the suppressor, the EQ and the reverb (the
   volume folded into wet and dry), the limiter with its channels
   linked.
3. Ducking of the ducked bus under the side-chain bus s (voice plus
   others), channel by channel: ``env[t] = max(|s[t]|, k env[t-1])``
   (``dsp.decaying_max``), the one-pole ``e[t] = (1-c) e[t-1] + c
   env[t]`` (``scipy.signal.lfilter``), ``x = clip((20 log10 e -
   threshold) / knee + 0.5, 0, 1)`` and the gain ``10^(-depth x / 20)``;
   k and c from the release and attack times as the limiter's.
4. BS.1770-4 loudness of the mixed bus: the K-weighting from the
   standard's table at 48 kHz (a shelf, then a high-pass), the mean
   square of each 400 ms block at a 100 ms hop, block by block, summed
   over the channels (weights 1), the -70 LUFS absolute gate and the
   -10 LU relative gate; the bus scaled by ``10^((target - L) / 20)``
   (silence passes through).
5. int16 by the pinned rule (``dsp.to_pcm16``).

Departures from the program, none in the arithmetic: a mono track stays
one channel until it meets a wider bus (the program upmixes at
placement), so the voice chain and the duck's side chain run once on a
mono voice bus; every stage there is per channel, or links the channels
by their maximum, so identical channels give identical results. The
recurrences run one sample after another where the program runs
log-depth scans and kernels, the block powers are block sums where it
takes a cumulative sum, and everything is float64.

At ``precision="tf32"`` the resampler's filter and signal and the folded
FIR's taps and signal are rounded, as in the other chains.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as sps

from perfbench.reference import dsp, voice_chain

# ITU-R BS.1770-4, Table 1 (the shelf) and Table 2 (the high-pass), 48 kHz
K_SHELF = ([1.53512485958697, -2.69169618940638, 1.19839281085285],
           [1.0, -1.69065929318241, 0.73248077421585])
K_HIGHPASS = ([1.0, -2.0, 1.0], [1.0, -1.99004745483398, 0.99007225036621])
K_SR = 48000
ABS_GATE_LUFS = -70.0
REL_GATE_LU = -10.0


def k_weighting_sos() -> np.ndarray:
    """The two stages as a (2, 6) sos array at 48 kHz."""
    return np.array([K_SHELF[0] + K_SHELF[1], K_HIGHPASS[0] + K_HIGHPASS[1]])


def block_powers(x: np.ndarray, sr: int) -> np.ndarray:
    """Mean square of each 400 ms block (100 ms hop) of the K-weighted
    (ch, n) ``x``, summed over the channels."""
    if sr != K_SR:
        raise ValueError(f"the K-weighting table is for {K_SR} Hz, got {sr}")
    y = sps.sosfilt(k_weighting_sos(), x, axis=-1)
    block, hop = int(round(0.4 * sr)), int(round(0.1 * sr))
    if y.shape[-1] < block:
        raise ValueError("shorter than one 400 ms block")
    nblk = (y.shape[-1] - block) // hop + 1
    return np.array([np.sum(np.mean(y[:, j * hop:j * hop + block] ** 2,
                                    axis=-1)) for j in range(nblk)])


def integrated_loudness(x: np.ndarray, sr: int) -> float:
    """Gated loudness (LUFS) of (ch, n) ``x``; -inf where no block
    passes the absolute gate."""
    p = block_powers(x, sr)
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(p)
    kept = lk > ABS_GATE_LUFS
    if not kept.any():
        return -math.inf
    rel = -0.691 + 10.0 * math.log10(np.mean(p[kept])) + REL_GATE_LU
    kept &= lk > rel
    return -0.691 + 10.0 * math.log10(np.mean(p[kept]))


def duck_gain(s: np.ndarray, sr: int, threshold_db: float = -40.0,
              depth_db: float = 12.0, knee_db: float = 10.0,
              attack_ms: float = 10.0,
              release_ms: float = 300.0) -> np.ndarray:
    """The ducking gain of each channel of the side-chain bus ``s``."""
    env = dsp.decaying_max(np.abs(s), dsp.release_coeff(release_ms, sr))
    c = dsp.attack_coeff(attack_ms, sr)
    e = env if c >= 1.0 else sps.lfilter([c], [1.0, c - 1.0], env, axis=-1)
    x = np.clip((20.0 * np.log10(np.maximum(e, 1e-12)) - threshold_db)
                / knee_db + 0.5, 0.0, 1.0)
    return 10.0 ** (-depth_db * x / 20.0)


def voice_fx(x: np.ndarray, c: dict, precision: str) -> np.ndarray:
    """The voice chain over a (ch, n) bus at ``c["sample_rate"]``."""
    sr = int(c["sample_rate"])
    y = voice_chain.suppress(x, **c["ns"])
    g = dsp.db_to_amp(float(c["volume_db"]))
    ir = dsp.synthetic_ir(c["ir_seconds"], sr, seed=c["ir_seed"])
    y = dsp.eq_reverb(y, dsp.eq_sos(c["bands"], sr), ir, g * c["wet"],
                      g * c["dry"], precision)
    return dsp.limiter(y, sr, **c["limiter"])


def _rate(config: dict, signal: str) -> int:
    return int(config["bgm_sr"] if signal == "bgm" else config["voice_sr"])


def _signal(config: dict, inputs: dict, signal: str, row: int) -> np.ndarray:
    """Row ``row`` of ``signal`` as float64 (ch, n), the samples the mix
    reads."""
    x = np.asarray(inputs[signal][row], np.float64) / 32768.0
    if signal == "bgm":
        x = x[:int(round(float(config["bgm_seconds"])
                         * int(config["bgm_sr"])))]
    return x[None] if x.ndim == 1 else x.T


def _ms(ms: float, sr: int) -> int:
    return int(round(ms * sr / 1000.0))


def mix_row(config: dict, inputs: dict, row: int,
            precision: str = "float64") -> np.ndarray:
    """One episode -> int16 (n, channels)."""
    rnd = dsp.rounder(precision)
    sr = int(config["sample_rate"])
    tracks = []
    for t in config["tracks"]:
        x = _signal(config, inputs, t["signal"], row)
        if _rate(config, t["signal"]) != sr:
            x = dsp.resample(x, _rate(config, t["signal"]), sr, rnd)
        tracks.append((x, t))
    nch = max(x.shape[0] for x, _ in tracks)
    ends = [_ms(t.get("start_ms", 0.0), sr) + x.shape[-1]
            for x, t in tracks if not t.get("loop", False)]
    total = max(ends) if ends else max(
        _ms(t.get("start_ms", 0.0), sr) + x.shape[-1] for x, t in tracks)
    buses = {"voice": None, "ducked": None, "other": None}
    for x, t in tracks:
        start = min(_ms(t.get("start_ms", 0.0), sr), total)
        if t.get("loop", False) and x.shape[-1] < total - start:
            x = np.tile(x, (1, -(-(total - start) // x.shape[-1])))
        x = x[:, :total - start]
        x = x * (float(t.get("gain", 1.0)) * dsp.fade_ramp(
            x.shape[-1], _ms(t.get("fade_in_ms", 0.0), sr),
            _ms(t.get("fade_out_ms", 0.0), sr)))
        placed = np.zeros((x.shape[0], total))
        placed[:, start:start + x.shape[-1]] = x
        bus = ("ducked" if t.get("side_duck", False) else
               "voice" if t.get("kind", "voice") == "voice" else "other")
        buses[bus] = placed if buses[bus] is None else buses[bus] + placed
    out = np.zeros((1, total))
    if buses["voice"] is not None:
        out = out + voice_fx(buses["voice"], config["chain"], precision)
    if buses["other"] is not None:
        out = out + buses["other"]
    if buses["ducked"] is not None:
        out = out + buses["ducked"] * duck_gain(out, sr, **config["duck"])
    if config["normalize"] != "lufs":
        raise ValueError("only LUFS normalization is defined here")
    out = np.broadcast_to(out, (nch, total))
    loud = integrated_loudness(out, sr)
    if math.isfinite(loud):
        out = out * 10.0 ** ((float(config["target_db"]) - loud) / 20.0)
    return dsp.to_pcm16(out).T


def run(config: dict, inputs: dict, precision: str = "float64") -> np.ndarray:
    rows = len(next(iter(inputs.values())))
    return np.stack([mix_row(config, inputs, r, precision)
                     for r in range(rows)])


def stages(config: dict, traffic: dict) -> dict:
    """The shapes of the program's stages at the traffic's episode: the
    voice chain and the duck on the stereo bus, as the program runs
    them."""
    c = config["chain"]
    sr = int(config["sample_rate"])
    L, M = dsp.ratio(int(config["voice_sr"]), sr)
    n = -(-int(round(traffic["clip_seconds"] * int(config["voice_sr"]))) * L
          // M)
    ch = int(traffic["channels"])
    sos = dsp.eq_sos(c["bands"], sr)
    ir = dsp.synthetic_ir(c["ir_seconds"], sr, seed=c["ir_seed"])
    g = dsp.db_to_amp(float(c["volume_db"]))
    return {"ns": {"rows": ch, "n": n, "nfft": int(c["ns"]["nfft"])},
            "eq_reverb": {"rows": ch, "n": n,
                          "taps": dsp.folded_taps(sos, ir, g * c["wet"],
                                                  g * c["dry"])},
            "limiter": {"rows": 1, "channels": ch, "n": n},
            "duck": {"channels": ch, "n": n},
            "lufs": {"channels": ch, "n": n}}
