"""Parity of the port's noise suppression (``xmtpu_torch.ops.ns``) with
the JAX package's (``xmtpu.ops.ns``) and its float64 oracle
``suppress_np``, on the CPU.

One size: 16,384 samples at 16 kHz (about 1 s): a tone at half level
over white noise, the first 0.25 s noise only; the streaming tests cut it
into blocks of 512 and 1,024 samples.

Tolerances: ``suppress`` (frozen and adaptive) against the JAX
``suppress`` and ``suppress_np`` at -80 dB (float32 FFTs on both sides;
about -135 dB measured); the STFT round trip at -100 dB; streaming block
invariance bit-exact; streaming against offline after the lead-in at
-100 dB; streaming against the JAX streaming at -80 dB; int16 output
within 1 LSB of the JAX output.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmtpu_torch
from xmtpu.graph import fx as xfx
from xmtpu.ops import ns as xns
from xmtpu_torch.graph import fx as tfx
from xmtpu_torch.ops import ns as tns

from . import torch_refs as refs

SR = 16000
N = 16384
MODES = ["frozen", "adaptive"]


@pytest.fixture(scope="module")
def noisy():
    rng = np.random.default_rng(51)
    t = np.arange(N) / SR
    clean = 0.5 * 0.3 * np.sin(2 * np.pi * 440.0 * t)
    clean[:4000] = 0.0
    return (clean + 0.03 * rng.standard_normal(N)).astype(np.float32)


@pytest.mark.parametrize("nfft", [256, 512])
def test_stft_istft_roundtrip(noisy, nfft):
    """Identity reconstruction (COLA), and the frames equal the JAX
    STFT's."""
    x = torch.from_numpy(noisy)
    X = tns.stft(x, nfft)
    Xj = np.asarray(xns.stft(jnp.asarray(noisy), nfft))
    assert X.shape == Xj.shape == (tns._frame_count(N, nfft), nfft // 2 + 1)
    assert refs.db(torch.view_as_real(X), np.stack([Xj.real, Xj.imag], -1)) \
        <= -100.0
    assert refs.db(tns.istft(X, N, nfft), noisy) <= -100.0


@pytest.mark.parametrize("shape", ["(n,)", "(2, n)"])
@pytest.mark.parametrize("mode", MODES)
def test_suppress_vs_jax_and_oracle(noisy, mode, shape):
    x = noisy if shape == "(n,)" else np.stack([noisy, noisy[::-1].copy()])
    y = tns.suppress(x, noise_update=mode, device="cpu")
    yj = np.asarray(xns.suppress(jnp.asarray(x), noise_update=mode))
    yn = tns.suppress_np(x, noise_update=mode)
    assert y.shape == x.shape and y.dtype == torch.float32
    print(f"{mode} {shape}: {refs.db(y, yj):.1f} dB vs JAX, "
          f"{refs.db(y, yn):.1f} vs float64")
    assert refs.db(y, yj) <= -80.0 and refs.db(y, yn) <= -80.0


@pytest.mark.parametrize("noise_frames", [7, 8])
def test_median_of_even_count_is_the_mean_of_the_middle_two(noisy,
                                                            noise_frames):
    """jnp.median and np.median average the two middle values of an even
    count; torch.median returns the lower one. The port's median follows
    numpy, and suppress() agrees with both references at either parity;
    the lower median gives another result where the count is even."""
    psd = torch.square(torch.abs(tns.stft(torch.from_numpy(noisy))))
    lead = psd[:noise_frames]
    np.testing.assert_allclose(tns.median(lead, dim=0).numpy(),
                               np.median(lead.numpy(), axis=0), rtol=1e-6)
    lower = torch.median(lead, dim=0).values
    assert torch.equal(lower, tns.median(lead, dim=0)) == (noise_frames % 2
                                                           == 1)
    y = tns.suppress(noisy, noise_frames=noise_frames, device="cpu")
    yj = np.asarray(xns.suppress(jnp.asarray(noisy),
                                 noise_frames=noise_frames))
    yn = tns.suppress_np(noisy, noise_frames=noise_frames)
    assert refs.db(y, yj) <= -80.0 and refs.db(y, yn) <= -80.0
    # what the lower median would give: noise estimate off, output off
    noise_lo = lower[None]
    P = tns._onepole_frames(psd, 0.7)
    snr = torch.clamp_min(P / torch.clamp_min(noise_lo, 1e-20) - 1.0, 0.0)
    G = torch.clamp_min(snr / (1.0 + snr), 0.1)
    y_lo = tns.istft(tns.stft(torch.from_numpy(noisy)) * G, N)
    if noise_frames % 2 == 0:
        assert refs.db(y_lo, yn) > -80.0
    else:
        assert refs.db(y_lo, yn) <= -80.0


def test_suppress_int16_pinned_conversion(noisy):
    x = np.round(noisy * 32768.0).astype(np.int16)
    y = tns.suppress(x, device="cpu")
    yj = np.asarray(xns.suppress(jnp.asarray(x)))
    assert y.dtype == torch.int16
    assert np.abs(y.numpy().astype(np.int32) - yj.astype(np.int32)).max() <= 1


def test_suppress_explicit_noise_psd(noisy):
    nz = np.full(257, 0.05, np.float32)
    y = tns.suppress(noisy, noise_psd=nz, device="cpu")
    yj = np.asarray(xns.suppress(jnp.asarray(noisy), noise_psd=jnp.asarray(nz)))
    assert refs.db(y, yj) <= -80.0
    assert refs.db(y, tns.suppress_np(noisy, noise_psd=nz)) <= -80.0


@pytest.mark.parametrize("kw,match", [
    ({"noise_update": "median"}, "noise_update"),
    ({"noise_update": "adaptive", "noise_psd": np.ones(257, np.float32)},
     "noise_psd"),
])
def test_suppress_argument_errors(noisy, kw, match):
    with pytest.raises(ValueError, match=match):
        tns.suppress(noisy, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        xns.suppress(jnp.asarray(noisy), **kw)


def test_suppress_improves_snr():
    """A tone under stationary noise: at least 6 dB better SNR (the
    JAX package's own check)."""
    rng = np.random.default_rng(6)
    clean = np.zeros(N, np.float32)
    t = np.arange(N - 4000) / SR
    clean[4000:] = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    noisy = clean + (0.03 * rng.standard_normal(N)).astype(np.float32)
    y = tns.suppress(noisy, device="cpu").numpy().astype(np.float64)

    def snr(sig):
        e_n = np.mean((sig[:3500] - clean[:3500]) ** 2)
        return 10 * np.log10(np.mean(clean[4000:] ** 2) / e_n)

    assert snr(y) - snr(noisy.astype(np.float64)) >= 6.0


def _stream(x, blk, mode, nfft=512, mod=tns):
    """x (..., n) streamed in blocks of ``blk`` through ``mod``."""
    tensor = mod is tns
    st = mod.stream_init(x.shape[:-1], nfft=nfft)
    outs = []
    for i in range(0, x.shape[-1], blk):
        b = x[..., i:i + blk]
        y, st = mod.stream_suppress(torch.from_numpy(b) if tensor
                                    else jnp.asarray(b), st, nfft=nfft,
                                    noise_update=mode)
        outs.append(np.asarray(y))
    return np.concatenate(outs, -1)


@pytest.mark.parametrize("mode", MODES)
def test_stream_block_invariance_and_offline_match(noisy, mode):
    x = noisy[None]
    y1, y2 = _stream(x, 512, mode), _stream(x, 1024, mode)
    np.testing.assert_array_equal(y1, y2)  # bit-exact block invariance
    off = tns.suppress(x, noise_update=mode, device="cpu").numpy()
    delay, skip = 256, 10 * 256  # after the lead-in, offline delayed
    assert refs.db(y1[0, delay + skip:], off[0, skip:N - delay]) <= -100.0


@pytest.mark.parametrize("mode", MODES)
def test_stream_vs_jax_batched(noisy, mode):
    x = np.stack([noisy, noisy[::-1].copy()])[:, None]  # (B, ch, n)
    y = _stream(x, 1024, mode)
    yj = _stream(x, 1024, mode, mod=xns)
    assert refs.db(y, yj) <= -80.0


def _reset_item1(st, fresh, cat):
    """``st`` with item 1's slices taken from ``fresh`` (the lead
    buffer's item axis is 1, every other field's 0)."""
    out = {}
    for k, v in st.items():
        if k == "lead":
            out[k] = cat([v[:, :1], fresh[k][:, 1:]], 1)
        else:
            out[k] = cat([v[:1], fresh[k][1:]], 0)
    return out


def test_stream_per_item_reset_reruns_leadin(noisy):
    """Resetting one item's state slices (its counter too) re-runs that
    item's lead-in while the other item keeps its estimate: as the JAX
    package does."""
    x = np.stack([noisy, noisy])[:, None]
    results = []
    for mod in (tns, xns):
        to = torch.from_numpy if mod is tns else jnp.asarray
        st = mod.stream_init((2, 1))
        outs = []
        for i in range(0, N, 1024):
            if i == N // 2:  # item 1 (re)joins: fresh state for it
                st = _reset_item1(st, mod.stream_init((2, 1)),
                                  torch.cat if mod is tns else jnp.concatenate)
            y, st = mod.stream_suppress(to(x[..., i:i + 1024]), st)
            outs.append(np.asarray(y))
        results.append(np.concatenate(outs, -1))
    y, yj = results
    assert refs.db(y, yj) <= -80.0
    # item 1 passes at unity through its new lead-in; item 0 does not
    seg = slice(N // 2 + 256, N // 2 + 256 + 8 * 256 - 256)
    assert not np.allclose(y[0, 0, seg], y[1, 0, seg])


def test_stream_legacy_scalar_counter_accepted(noisy):
    x = torch.from_numpy(np.stack([noisy[:1024], noisy[1024:2048]])[:, None])
    st = tns.stream_init((2, 1))
    legacy = dict(st, count=torch.zeros((), dtype=torch.int32))
    y1, s1 = tns.stream_suppress(x, st)
    y2, s2 = tns.stream_suppress(x, legacy)
    assert torch.equal(y1, y2) and s2["count"].shape == (2, 1)
    assert torch.equal(s1["count"], s2["count"])


@pytest.mark.parametrize("case", ["noise_frames", "n % hop", "batch shape"])
def test_stream_argument_errors(case):
    st = tns.stream_init(1, nfft=256)
    x = torch.zeros(1, 512)
    with pytest.raises(ValueError, match={"noise_frames": "lead buffer",
                                          "n % hop": "n % 128",
                                          "batch shape": "batch shape"}[case]):
        if case == "noise_frames":
            tns.stream_suppress(x, st, nfft=256, noise_frames=6)
        elif case == "n % hop":
            tns.stream_suppress(x[:, :500], st, nfft=256)
        else:
            tns.stream_suppress(torch.zeros(2, 512), st, nfft=256)


def test_ns_effect_in_chain_vs_jax(noisy):
    """The effect runs offline in a chain (it no longer refuses), as the
    JAX chain's; blocked mode stays refused (offline-only)."""
    x = np.stack([noisy, noisy[::-1].copy()], -1)  # (n, 2)
    chain = [{"name": "noise_suppression", "noise_update": "adaptive"},
             {"name": "volume", "gain_db": -3.0}]
    y = xmtpu_torch.effects(x, SR, chain, device="cpu")
    yj = np.asarray(xfx.apply_chain(x, SR, chain))
    assert y.shape == x.shape and refs.db(y, yj) <= -80.0
    with pytest.raises(tfx.ConfigError, match="offline-only"):
        xmtpu_torch.effects(x, SR, chain, device="cpu", block_size=4096)


def test_ns_effect_streaming_mode(noisy):
    """set_streaming switches the effect to the causal twin with
    nfft = the frame; state from init_state on the chain's device."""
    (fx,) = tfx.build_chain(SR, [{"name": "ns"}], device_type="cpu")
    with pytest.raises(tfx.ConfigError, match="even frame"):
        fx.set_streaming(321)
    fx.set_streaming(320)
    st = fx.init_state((1,), "cpu")
    assert st["lead"].shape == (8, 1, 161)
    y, st = fx.apply(torch.from_numpy(noisy[None, :3200]), st)
    (fj,) = xfx.build_chain(SR, [{"name": "ns"}])
    fj.set_streaming(320)
    yj, _ = fj.apply(jnp.asarray(noisy[None, :3200]), fj.init_state((1,)))
    assert int(st["count"][0]) == 20 and refs.db(y, np.asarray(yj)) <= -80.0
