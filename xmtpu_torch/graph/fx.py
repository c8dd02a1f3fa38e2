"""Effect chain: ordered effects over a PCM stream (counterpart of
``xmtpu.graph.fx``; BASELINE config 3 is EQ -> reverb -> limiter).

Each effect is a small object with ``init_state`` / ``apply``, so the
same code serves the whole-clip path (state ``None``) and the blocked
path with carried state. Each effect runs on one of the JAX package's
two engines:

* ``pallas``, the port's kernels: the EQ on the biquad kernel
  (``kernels.iir.sosfilt``), the reverb and every folded LTI run on the
  fftconv kernel (``ops.reverb.reverb``), the limiter on the envelope
  kernel (``ops.limiter.limiter``; its gain form with ``linked_fuse``).
  Each wrapper runs the kernel on a CUDA tensor and its plain twin on a
  CPU tensor, so the device of the signal picks; ``pallas_interpret``
  (the JAX kernels in interpret mode) is accepted on the CPU only, where
  the twins stand in. Adjacent LTI effects with a reverb fold into one
  convolution;
* ``scan`` (``scan``/``oracle``/``xla``), the float64 engine: the EQ as
  float64 associative scans (``ops.biquad.sosfilt_scan``), the reverb on
  ``torch.fft`` (``ops.reverb``'s ``"xla"`` form; blocked: the output
  tail carried by ``reverb_block``), the limiter in float64
  (``limiter(backend="scan")``). Nothing folds. Its states are the JAX
  scan engine's (float64 IIR and limiter state, the reverb's output tail)
  and differ in shape and dtype from the kernel engine's.

``auto`` (or no backend) resolves by the device the chain runs on, as
the JAX package's does by its platform: the kernels on ``cuda``, the
float64 scans on the CPU; a limiter with ``linked_fuse`` under ``auto``
runs the gain form (on the CPU its twin), the computation its caller
asked for. Host design (EQ sections, the synthetic IR, the LTI fold and
its combined IR) is numpy, bit-exact with the JAX package. There is no
jit: :func:`get_compiled_chain` caches the built effect lists per device
type.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from xmtpu_torch.api import _from_f32_device, _to_f32_device
from xmtpu_torch.kernels.iir import sosfilt
from xmtpu_torch.ops import biquad as _biquad
from xmtpu_torch.ops import limiter as _limiter
from xmtpu_torch.ops import ns as _ns
from xmtpu_torch.ops import reverb as _reverb
from xmtpu_torch.utils.device import check_interpret, resolve_device
from xmtpu_torch.utils.errors import ConfigError
from xmtpu_torch.utils.profiling import stage

_SCAN_BACKENDS = ("scan", "oracle", "xla")
_AUTO = (None, "auto")
_MAX_FOLD_BLOCK = 131072  # the JAX fftconv kernel's largest block


def _as_batch_shape(batch_shape) -> tuple:
    """init_state accepts the legacy ``nch`` int or a full batch shape
    tuple (..., ch): batched clips carry per-clip state."""
    if isinstance(batch_shape, (tuple, list)):
        return tuple(int(b) for b in batch_shape)
    return (int(batch_shape),)


def _resolve_backend(backend: str | None,
                     device_type: str = "cuda") -> tuple[str, bool]:
    """-> (engine, interpret), engine in {"scan", "pallas"}: ``auto``
    (or None) is the kernels on ``device_type`` "cuda" and the float64
    scans on "cpu"; ``scan``/``oracle``/``xla`` the scans; ``pallas`` the
    kernels (their twins on the CPU); ``pallas_interpret`` (True) the
    kernels' twins on the CPU only (see :func:`apply_chain`)."""
    if backend in _AUTO:
        return ("scan" if device_type == "cpu" else "pallas"), False
    if backend in _SCAN_BACKENDS:
        return "scan", False
    if backend == "pallas":
        return "pallas", False
    if backend == "pallas_interpret":
        return "pallas", True
    raise ConfigError(f"unknown effect backend {backend!r}; use "
                      "auto|scan|pallas")


def _conv(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Same-length causal convolution of x (..., n) on the fftconv
    kernel."""
    return _reverb.reverb(x, ir, wet=1.0, dry=0.0)


class _DeviceIR:
    """An effect's float32 host IR, copied once to each device it runs
    on."""

    def __init__(self, ir: np.ndarray):
        self.ir = np.ascontiguousarray(ir, np.float32)
        self._on = {}

    def ir_on(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.ir, device=device)
        return self._on[key]


def _conv_with_history(fx, x, state):
    """conv(history ++ x) minus the history: the overlap-save input
    history (last m-1 input samples) carries the convolution across
    blocks. -> (w, new_state); a None state is the whole clip."""
    m = len(fx.ir)
    if state is None or m == 1:  # whole clip: zero history
        return _conv(x, fx.ir_on(x.device)), state
    xa = torch.cat([state.to(x.dtype), x], dim=-1)
    w = _conv(xa, fx.ir_on(x.device))[..., m - 1:]
    return w, xa[..., -(m - 1):].clone()


class EqualizerFx:
    """Cascaded RBJ biquad EQ. params: bands=[{freq_hz, gain_db, q,
    kind}], backend (see :func:`_resolve_backend`)."""

    PARAMS = frozenset({"bands", "backend"})
    stage_name = "eq"

    def __init__(self, sample_rate: int, params, device_type: str = "cuda"):
        p = dict(params)
        bands = p.get("bands")
        if not bands:
            raise ConfigError("equalizer: 'bands' is required and non-empty")
        if not isinstance(bands, (list, tuple)) or not all(
                isinstance(b, dict) for b in bands):
            raise ConfigError(
                f"equalizer: 'bands' must be a list of objects, got "
                f"{bands!r}")
        try:
            self.sos = _biquad.eq_sos(list(bands), sample_rate)
        except (TypeError, ValueError, KeyError) as e:
            raise ConfigError(f"equalizer: bad band: {e}") from e
        self.engine, self.interpret = _resolve_backend(p.get("backend"),
                                                       device_type)
        self._on = {}

    def init_state(self, batch_shape, device="cpu"):
        bs = _as_batch_shape(batch_shape)
        dt = torch.float32 if self.engine == "pallas" else torch.float64
        return torch.zeros((self.sos.shape[0],) + bs + (2,), dtype=dt,
                           device=device)

    def apply(self, x, state):
        with stage(self.stage_name):
            if self.engine == "pallas":
                # the segmented biquad kernel, exact zi/zf carry
                return sosfilt(self.sos, x, zi=state)
            return _biquad.sosfilt_scan(self._sos_on(x.device), x, zi=state)

    def _sos_on(self, device) -> torch.Tensor:
        """The float64 sections on ``device``, copied once (a copy from
        pageable host memory per call synchronises the stream, and a
        streaming session calls this every frame)."""
        key = str(device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.sos, dtype=torch.float64,
                                            device=device)
        return self._on[key]


def _reverb_block_for(m: int) -> int:
    """The JAX fftconv kernel's block for an m-tap IR: the smallest
    power of two with hop >= block/2, floored at 32768. It decides the
    LTI fold (runs whose combined IR needs a block above 131072 stay
    unfolded); the port's kernel takes any IR."""
    b = 32768
    while b < 2 * max(1, m - 1):
        b *= 2
    return b


class ReverbFx(_DeviceIR):
    """FIR reverb. params: ir (array) | ir_wav (a WAV file: channel 0,
    the pinned int16 conversion, resampled to the bus rate by the
    float64 oracle) | ir_seconds (synthetic, with rt60, seed), wet, dry,
    backend."""

    PARAMS = frozenset({"ir", "ir_wav", "ir_seconds", "rt60", "seed",
                        "wet", "dry", "backend"})
    stage_name = "reverb"

    def __init__(self, sample_rate: int, params, device_type: str = "cuda"):
        p = dict(params)
        try:
            self.wet = float(p.get("wet", 0.3))
            self.dry = float(p.get("dry", 0.7))
            ir_seconds = float(p.get("ir_seconds", 0.5))
        except (TypeError, ValueError) as e:
            raise ConfigError(f"reverb: non-numeric parameter: {e}") from e
        if not (np.isfinite(self.wet) and np.isfinite(self.dry)):
            raise ConfigError(
                f"reverb: wet/dry must be finite, got {self.wet}/{self.dry}")
        if "ir_seconds" in p and not ir_seconds > 0:
            raise ConfigError(
                f"reverb: ir_seconds must be > 0, got {p['ir_seconds']}")
        if "ir" in p:
            try:
                ir = np.asarray(p["ir"], np.float64)
            except (TypeError, ValueError) as e:
                raise ConfigError(f"reverb: non-numeric ir: {e}") from e
            if ir.size == 0:
                raise ConfigError("reverb: ir must be non-empty")
            if ir.ndim != 1:
                raise ConfigError(
                    f"reverb: ir must be 1-D mono, got shape {ir.shape}")
            if not np.all(np.isfinite(ir)):
                raise ConfigError("reverb: ir contains NaN/inf")
        elif "ir_wav" in p:
            from xmtpu_torch.io.wav import read_wav
            from xmtpu_torch.ops.convert import pcm16_to_f32_np
            from xmtpu_torch.ops.resample import resample_oracle_np

            pcm, ir_sr = read_wav(p["ir_wav"])
            ir = pcm16_to_f32_np(pcm[:, 0]).astype(np.float64)
            if ir_sr != sample_rate:
                ir = resample_oracle_np(ir, ir_sr, sample_rate)
        else:
            ir = _reverb.synthetic_ir(
                ir_seconds, sample_rate,
                rt60=p.get("rt60"), seed=int(p.get("seed", 7)),
            )
        super().__init__(ir)
        self.engine, self.interpret = _resolve_backend(p.get("backend"),
                                                       device_type)
        self.block = _reverb_block_for(len(self.ir))
        req = str(p.get("backend", ""))
        if self.block > _MAX_FOLD_BLOCK and req.startswith("pallas"):
            # as the JAX package: an explicit kernel request past the
            # JAX kernel's plan raises; the auto pick runs (the port's
            # partitioned fftconv takes any IR)
            raise ConfigError(
                f"backend={req!r} unsupported for a {len(self.ir)}-tap "
                f"IR (needs block {self.block} > {_MAX_FOLD_BLOCK}); use "
                "backend='auto'")

    def init_state(self, batch_shape, device="cpu"):
        # kernels: the overlap-save input history (last m-1 input
        # samples); scans: the overlap-add output tail
        bs = _as_batch_shape(batch_shape)
        return torch.zeros(bs + (len(self.ir) - 1,), dtype=torch.float32,
                           device=device)

    def apply(self, x, state):
        with stage(self.stage_name):
            if self.engine == "pallas":
                w, new_state = _conv_with_history(self, x, state)
                return self.dry * x + self.wet * w, new_state
            ir = self.ir_on(x.device)
            if state is None:  # whole clip: overlap-save, no tail carry
                return _reverb.reverb(x, ir, wet=self.wet, dry=self.dry,
                                      block=self.block, backend="xla"), None
            return _reverb.reverb_block(x, ir, state, wet=self.wet,
                                        dry=self.dry)


class FusedLTIFx(_DeviceIR):
    """One combined-IR FIR stage standing in for an adjacent run of LTI
    effects (EQ / reverb / volume): the run is a composition of LTI
    systems, so it equals one convolution with the combined impulse
    response (host float64: each EQ cascade truncated at a -120 dB l1
    tail, reverb ``dry*delta + wet*ir``, volume a scalar). State is the
    last m-1 input samples, as :class:`ReverbFx`'s."""

    def __init__(self, ir: np.ndarray, interpret: bool, folded: tuple):
        super().__init__(ir)
        self.block = _reverb_block_for(len(self.ir))
        self.interpret = interpret
        self.folded = folded  # the effect objects this stage replaces
        # the profiler range: config 3's run reads "eq+reverb", the name
        # of the flagship step's folded stage
        self.stage_name = "+".join(f.stage_name for f in folded)

    def init_state(self, batch_shape, device="cpu"):
        bs = _as_batch_shape(batch_shape)
        return torch.zeros(bs + (len(self.ir) - 1,), dtype=torch.float32,
                           device=device)

    def apply(self, x, state):
        with stage(self.stage_name):
            return _conv_with_history(self, x, state)


def _lti_ir(fx):
    """The effect's (finite) impulse response in float64, or None if it
    is not foldable (not LTI, not on the kernel engine, or an IIR whose
    response does not truncate)."""
    if isinstance(fx, VolumeFx):
        return np.array([fx.gain], np.float64)
    if isinstance(fx, EqualizerFx) and fx.engine == "pallas":
        return _biquad.sos_impulse_np(fx.sos)
    if isinstance(fx, ReverbFx) and fx.engine == "pallas":
        h = fx.wet * fx.ir.astype(np.float64)
        h[0] += fx.dry
        return h
    return None


def _fold_lti(effects):
    """Collapse maximal adjacent runs of foldable LTI effects that
    contain a reverb into :class:`FusedLTIFx` stages, as the JAX package
    does (runs without a reverb keep their own kernels; a combined IR
    past the JAX kernel's largest block stays unfolded)."""
    out, run = [], []

    def flush():
        if not run:
            return
        if any(isinstance(f, ReverbFx) for f, _ in run) and len(run) > 1:
            h = np.ones(1, np.float64)
            for _, hi in run:
                h = np.convolve(h, hi)
            # re-trim: the composition can decay sooner than the parts
            h = _reverb.trim_ir_tail(h)
            if _reverb_block_for(len(h)) <= _MAX_FOLD_BLOCK:
                interp = any(getattr(f, "interpret", False) for f, _ in run)
                out.append(FusedLTIFx(h, interp, tuple(f for f, _ in run)))
                run.clear()
                return
        out.extend(f for f, _ in run)
        run.clear()

    for fx in effects:
        h = _lti_ir(fx)
        if h is not None:
            run.append((fx, h))
        else:
            flush()
            out.append(fx)
    flush()
    return out


class LimiterFx:
    """Soft-knee limiter. params: threshold_db, knee_db, attack_ms,
    release_ms, ceiling_db, backend, envelope_block (None or a power of
    two; the kernels step per sample, the scans ignore it), linked_fuse
    (the curve in the envelope kernel's gain form: the kernel engine,
    also under ``auto`` on the CPU, where its twin runs)."""

    PARAMS = frozenset({"threshold_db", "knee_db", "attack_ms",
                        "release_ms", "ceiling_db", "backend",
                        "envelope_block", "linked_fuse"})
    stage_name = "limiter"

    def __init__(self, sample_rate: int, params, device_type: str = "cuda"):
        p = dict(params)
        self.sr = sample_rate
        backend = p.get("backend")
        if p.get("linked_fuse"):
            if backend in _SCAN_BACKENDS:
                # the JAX package ignores the flag there and runs another
                # computation than the one asked for
                raise ConfigError(
                    f"linked_fuse=True runs the envelope kernel's gain form; "
                    f"backend={backend!r} has no such kernel")
            if backend in _AUTO:
                backend = "pallas"  # the gain form, whatever the device
        self.engine, self.interpret = _resolve_backend(backend, device_type)
        self.kw = dict(
            threshold_db=float(p.get("threshold_db", -3.0)),
            knee_db=float(p.get("knee_db", 6.0)),
            attack_ms=float(p.get("attack_ms", 1.0)),
            release_ms=float(p.get("release_ms", 100.0)),
            ceiling_db=float(p.get("ceiling_db", 0.0)),
            envelope_block=_limiter.check_envelope_block(
                p.get("envelope_block")),
            linked_fuse=bool(p.get("linked_fuse", False)),
        )

    def init_state(self, batch_shape, device="cpu"):
        bs = _as_batch_shape(batch_shape)[:-1]  # channels are linked
        dt = torch.float32 if self.engine == "pallas" else torch.float64
        z = torch.zeros(bs, dtype=dt, device=device)
        return (z, z.clone())

    def apply(self, x, state):
        with stage(self.stage_name):
            return _limiter.limiter(x, self.sr, state=state,
                                    backend=self.engine, **self.kw)


class CompressorFx(LimiterFx):
    """SoX-compand-style downward compressor (finite ratio + makeup).
    params: the limiter's, ratio, makeup_db."""

    PARAMS = LimiterFx.PARAMS | {"ratio", "makeup_db"}
    stage_name = "compressor"

    def __init__(self, sample_rate: int, params, device_type: str = "cuda"):
        p = dict(params)
        super().__init__(sample_rate, p, device_type)
        self.kw["ratio"] = float(p.get("ratio", 4.0))
        self.kw["makeup_db"] = float(p.get("makeup_db", 0.0))
        try:
            _limiter._knee_slope(self.kw["ratio"])
        except ValueError as e:
            raise ConfigError(f"compressor: {e}") from e


class ConvLimiterFx:
    """A :class:`FusedLTIFx` stage feeding a limiter/compressor (the
    config-3 chain: EQ+reverb folded into one convolution, then the
    output limiter). The JAX node hands the convolution's hop-padded
    output to the limiter with ``n_valid=``; the port's kernel writes
    exactly n samples, so the node runs the two stages in turn, whole
    clip or blocked."""

    def __init__(self, conv: FusedLTIFx, lim: LimiterFx):
        self.conv, self.lim = conv, lim
        self.folded = conv.folded + (lim,)
        self.interpret = conv.interpret or lim.interpret

    def init_state(self, batch_shape, device="cpu"):
        return (self.conv.init_state(batch_shape, device),
                self.lim.init_state(batch_shape, device))

    def apply(self, x, state):
        cs, ls = (None, None) if state is None else state
        y, cs = self.conv.apply(x, cs)
        y, ls = self.lim.apply(y, ls)
        return y, (None if state is None else (cs, ls))


def _pair_conv_limiter(effects):
    """Post-fold pass: a FusedLTIFx followed by a kernel-engine
    limiter/compressor becomes one :class:`ConvLimiterFx`."""
    out = []
    for fx in effects:
        if (out and isinstance(out[-1], FusedLTIFx)
                and isinstance(fx, LimiterFx) and fx.engine == "pallas"):
            out[-1] = ConvLimiterFx(out[-1], fx)
        else:
            out.append(fx)
    return out


class NoiseSuppressFx:
    """STFT Wiener noise suppression (``ops.ns``). params: nfft,
    noise_frames, smooth, floor, noise_update, noise_smooth,
    presence_thresh, up_leak; no backend (``torch.fft`` on the chain's
    device; on a card the smoothing and gain run on the Wiener kernel
    where the noise estimate is fixed, ``ops.ns``). Offline chains run
    the whole clip
    (``ns.suppress``); after :meth:`set_streaming` the effect runs the
    causal frame-carry twin (``ns.stream_suppress``: nfft = the session
    frame, output delayed by nfft/2, unity gain during the lead-in)."""

    PARAMS = frozenset({"nfft", "noise_frames", "smooth", "floor",
                        "noise_update", "noise_smooth",
                        "presence_thresh", "up_leak"})
    stage_name = "ns"

    def __init__(self, sample_rate: int, params, device_type: str = "cuda"):
        p = dict(params)
        self.kw = dict(
            nfft=int(p.get("nfft", 512)),
            noise_frames=int(p.get("noise_frames", 8)),
            smooth=float(p.get("smooth", 0.7)),
            floor=float(p.get("floor", 0.1)),
            noise_update=str(p.get("noise_update", "frozen")),
            noise_smooth=float(p.get("noise_smooth", 0.95)),
            presence_thresh=float(p.get("presence_thresh", 4.0)),
            up_leak=float(p.get("up_leak", 1.02)),
        )
        self._stream_nfft = None

    def set_streaming(self, frame_len: int) -> None:
        if frame_len % 2:
            raise ConfigError(
                f"streaming noise_suppression needs an even frame, got "
                f"{frame_len}")
        self._stream_nfft = int(frame_len)

    def init_state(self, batch_shape, device="cpu"):
        if self._stream_nfft is None:
            return ()
        return _ns.stream_init(_as_batch_shape(batch_shape),
                               nfft=self._stream_nfft,
                               noise_frames=self.kw["noise_frames"],
                               device=device)

    def apply(self, x, state):
        with stage(self.stage_name):
            if self._stream_nfft is None:
                return _ns.suppress(x, device=x.device, **self.kw), state
            return _ns.stream_suppress(
                x, state, **dict(self.kw, nfft=self._stream_nfft))


class VolumeFx:
    """Static gain. params: gain_db | gain (linear)."""

    PARAMS = frozenset({"gain", "gain_db"})
    stage_name = "volume"

    def __init__(self, sample_rate: int, params, device_type: str = "cuda"):
        p = dict(params)
        if "gain" in p:
            self.gain = float(p["gain"])
        else:
            self.gain = float(10.0 ** (float(p.get("gain_db", 0.0)) / 20.0))
        if not np.isfinite(self.gain):
            raise ConfigError(
                f"volume: gain must be finite, got {self.gain} "
                f"(params {params!r})")

    def init_state(self, batch_shape, device="cpu"):
        return ()

    def apply(self, x, state):
        with stage(self.stage_name):
            return x * self.gain, state


_EFFECTS = {
    "equalizer": EqualizerFx,
    "eq": EqualizerFx,
    "reverb": ReverbFx,
    "limiter": LimiterFx,
    "compressor": CompressorFx,
    "volume": VolumeFx,
    "noise_suppression": NoiseSuppressFx,
    "ns": NoiseSuppressFx,
}


def _split_entry(e) -> tuple:
    """An effect entry -> (name, params dict): an object with ``.name``
    and ``.params``, or a dict with ``name`` and either ``params`` or
    the parameters inline."""
    if hasattr(e, "name"):
        return e.name, dict(e.params)
    if not isinstance(e, dict):
        raise ConfigError(
            f"effect entry must be an object with a 'name': {e!r}")
    d = dict(e)
    if "name" not in d:
        raise ConfigError(f"effect entry missing 'name': {e!r}")
    name = d.pop("name")
    if "params" not in d:
        return name, d
    pv = d.pop("params")
    if not isinstance(pv, dict):
        raise ConfigError(f"{name}: 'params' must be an object, got {pv!r}")
    if d:
        raise ConfigError(
            f"{name}: unexpected top-level key(s) {sorted(d)} alongside "
            f"'params' — put effect parameters inside 'params'")
    return name, dict(pv)


def build_chain(sample_rate: int, chain, default_backend: str | None = None,
                fold: bool = True, device_type: str = "cuda"):
    """Resolve a list of effect entries into effect objects.

    ``default_backend``: backend for effects that don't name one.
    ``device_type``: where the chain will run ("cuda" or "cpu"), which
    ``auto`` resolves by (:func:`_resolve_backend`). ``fold``: collapse
    adjacent kernel-engine LTI runs with a reverb into single combined-IR
    FIR stages (:class:`FusedLTIFx`), then pair a folded stage with the
    limiter after it (:class:`ConvLimiterFx`), as the JAX package does;
    False keeps every effect its own kernel."""
    out = []
    for e in chain:
        name, params = _split_entry(e)
        if not isinstance(name, str):
            raise ConfigError(f"effect name must be a string: {name!r}")
        if name not in _EFFECTS:
            raise ConfigError(
                f"unknown effect {name!r}; known: {sorted(_EFFECTS)}")
        cls = _EFFECTS[name]
        allowed = getattr(cls, "PARAMS", None)
        if (default_backend is not None and "backend" not in params
                and (allowed is None or "backend" in allowed)):
            params["backend"] = default_backend
        if allowed is not None:
            unknown = set(params) - allowed
            if unknown:
                raise ConfigError(
                    f"{name}: unknown parameter(s) {sorted(unknown)}; "
                    f"accepted: {sorted(allowed)}")
        try:
            out.append(cls(sample_rate, params, device_type=device_type))
        except ConfigError:
            raise
        except (TypeError, ValueError, KeyError, OverflowError) as e:
            raise ConfigError(f"{name}: bad parameters: {e}") from e
    return _pair_conv_limiter(_fold_lti(out)) if fold else out


def chain_init_state(effects, batch_shape, device="cpu"):
    """Initial states on ``device``; ``batch_shape`` = x.shape[:-1]."""
    return tuple(fx.init_state(batch_shape, device) for fx in effects)


def chain_apply(effects, x, states):
    """Run the chain over one block (..., ch, n). A ``None`` state
    element means "initial state, whole clip"."""
    new_states = []
    for fx, st in zip(effects, states):
        x, st = fx.apply(x, st)
        new_states.append(st)
    return x, tuple(new_states)


# --- built-chain cache ------------------------------------------------------

_cache: dict = {}


def _chain_key(sample_rate: int, chain) -> str:
    def canon(e):
        name, params = _split_entry(e)
        if "ir_wav" in params:
            # an IR file keys by (path, size, mtime): a file rewritten in
            # place must not reuse the chain built from its old IR
            path = str(params["ir_wav"])
            try:
                st = os.stat(path)
                params["ir_wav"] = (path, st.st_size, st.st_mtime_ns)
            except OSError:
                params["ir_wav"] = path
        return {"name": name, "params": params}

    return json.dumps(
        {"sr": sample_rate, "chain": [canon(e) for e in chain]},
        sort_keys=True, default=_json_default,
    )


def _json_default(v):
    """json.dumps ``default`` that keys arrays and tensors by content
    (sha1 of their bytes, shape and dtype); numpy scalars unbox;
    anything else stringifies."""
    if isinstance(v, (np.ndarray, torch.Tensor)):
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else v
        return (f"<array:{hashlib.sha1(a.tobytes()).hexdigest()}:"
                f"{a.shape}:{a.dtype}>")
    if isinstance(v, np.generic):
        return v.item()
    return str(v)


def get_compiled_chain(sample_rate: int, chain,
                       default_backend: str | None = None,
                       device_type: str = "cuda"):
    """-> the built effect list for ``device_type``, cached by content
    and device type (an LRU of 64, so a hot chain survives a stream of
    cold ones)."""
    key = (device_type, default_backend, _chain_key(sample_rate, chain))
    hit = _cache.pop(key, None)
    if hit is None:
        hit = build_chain(sample_rate, chain,
                          default_backend=default_backend,
                          device_type=device_type)
    _cache[key] = hit
    if len(_cache) > 64:
        _cache.pop(next(iter(_cache)))
    return hit


def apply_chain(pcm, sample_rate: int, chain, block_size: int | None = None,
                backend: str | None = None, device_out: bool = False,
                device=None):
    """Public effects entry (BASELINE config 3).

    ``pcm``: int16 or float32, (n,), (n, ch) or batched (B, n, ch), a
    numpy array or a tensor; returns the same format, as a numpy array
    or, with ``device_out``, a tensor on the device. ``device``: where
    the chain runs, ``cuda`` unless given. ``backend``: default engine
    for effects that don't name one (:func:`_resolve_backend`; ``auto``:
    the kernels on ``cuda``, the float64 scans on the CPU, ``"pallas"``
    on the CPU: the kernels' plain twins). ``block_size``: process in
    fixed blocks with carried state, the last block zero-padded; the
    output does not depend on the block size, because every effect
    carries exact state. Noise suppression rejects blocked mode."""
    with stage("effects"):
        return _apply_chain(pcm, sample_rate, chain, block_size, backend,
                            device_out, device)


def _apply_chain(pcm, sample_rate, chain, block_size, backend, device_out,
                 device):
    dev = resolve_device(device)
    effects = get_compiled_chain(sample_rate, chain, default_backend=backend,
                                 device_type=dev.type)
    ndim = pcm.dim() if torch.is_tensor(pcm) else np.ndim(pcm)
    if ndim < 1 or ndim > 3:
        raise ValueError(
            f"pcm must be (n,), (n, ch), or (B, n, ch); got shape "
            f"{tuple(pcm.shape) if hasattr(pcm, 'shape') else ()}")
    check_interpret(any(getattr(fx, "interpret", False) for fx in effects),
                    dev)
    x, was_i16, was_1d = _to_f32_device(pcm, dev)
    n = x.shape[-1]
    if block_size is None or block_size >= n:
        y, _ = chain_apply(effects, x, tuple(None for _ in effects))
        return _from_f32_device(y, was_i16, was_1d, to_host=not device_out)

    for e in effects:
        if isinstance(e, NoiseSuppressFx):
            raise ConfigError(
                "noise_suppression needs the whole clip (offline-only); "
                "run it unblocked or before the blocked chain")
    states = chain_init_state(effects, x.shape[:-1], dev)
    outs = []
    for i in range(0, n, block_size):
        blk = x[..., i:i + block_size]
        pad = block_size - blk.shape[-1]
        if pad:  # one block shape; the zero tail only feeds past-end state
            with stage("layout"):
                blk = torch.nn.functional.pad(blk, (0, pad))
        y, states = chain_apply(effects, blk, states)
        outs.append(y[..., :block_size - pad] if pad else y)
    with stage("layout"):
        y = torch.cat(outs, dim=-1)
    return _from_f32_device(y, was_i16, was_1d, to_host=not device_out)
