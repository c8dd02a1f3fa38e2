"""Sequence parallelism: one long clip sharded along time over devices
(counterpart of ``xmtpu.parallel.sp``).

* **FIR** (reverb): each shard needs the previous shard's last
  ``taps-1`` samples, a halo passed left to right (``mesh.shift_right``,
  the JAX package's ``ppermute``).
* **IIR** (biquad cascade): each shard's whole-shard effect on the
  section state is an affine map ``z -> M z + v``; the shards' summaries
  are gathered (``mesh.all_gather``), the prefix is folded serially in
  float64 (exact, no approximation) and each shard applies its true
  incoming state to what it already computed.
* **Envelope** (limiter): the same in the (max, x) semiring for the
  decaying max, plus an affine chain for the one-pole smoother.

Each entry point takes the WHOLE tensor and a :class:`Mesh` with an
``"sp"`` axis and returns the whole result on the input's device. The
``_local_*`` functions are the counterparts of the JAX package's
``shard_map`` bodies over one row of shards (``parts``, ``devices``):
each stage is launched on every shard before the exchange that follows
it, so the shards of several cards overlap; the summaries are folded
once, on the row's first device, and each incoming state is sent to its
shard's device. Two engines, as in the JAX package: ``"scan"`` (float64
associative scans, ``ops.biquad.section_cums`` and the limiter's scans)
and ``"kernel"`` (the IIR kernel, ``kernels.iir.sosfilt``, and the
envelope kernel, ``kernels.envelope.envelope``, on every shard, with the
same exact cross-shard chains); ``"auto"`` takes the kernels from 32,768
samples a shard. On the CPU the kernels' plain twins run. The FIR is
``torch.fft`` (``ops.reverb.fir_convolve_os``/``fir_convolve_full``), as
the JAX package's is XLA's FFT.

The JAX package's jit cache (``_JIT_CACHE``, ``_cached_jit``,
``_array_sig``) is not ported: nothing here compiles.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.kernels import envelope as _kenv
from xmtpu_torch.kernels import iir as _kiir
from xmtpu_torch.kernels._seg import on_device
from xmtpu_torch.ops import biquad as _biquad
from xmtpu_torch.ops import limiter as _lim
from xmtpu_torch.ops.precision import require_fp32_matmul
from xmtpu_torch.ops.reverb import fir_convolve_full, fir_convolve_os
from xmtpu_torch.parallel.mesh import all_gather, shift_right
from xmtpu_torch.utils.device import check_interpret
from xmtpu_torch.utils.errors import ConfigError

ENGINES = ("auto", "scan", "kernel")
KERNEL_MIN_SHARD = 32768  # "auto" takes the kernels from here


def _prefix_select(parts, devices, fold, init):
    """Exact cross-shard prefix: the state entering each shard. The
    shards' summaries (``parts``, one tensor each) are gathered on the
    first device, folded there serially from ``init`` (shard k enters
    with shards 0..k-1 folded), and each shard's state is sent to its
    device."""
    g = all_gather(parts, devices[0])
    states = [init]
    for k in range(len(parts) - 1):
        states.append(fold(states[-1], g[k]))
    return [s.to(d, non_blocking=d.type == "cuda")
            for s, d in zip(states, devices)]


def _engine(engine: str, n_shard: int) -> str:
    if engine not in ENGINES:
        raise ConfigError(f"engine must be auto|scan|kernel, got {engine!r}")
    if engine == "auto":
        return "kernel" if n_shard >= KERNEL_MIN_SHARD else "scan"
    return engine


def _shard_map(mesh, x, spec, body):
    """``shard_map`` with the ``"sp"`` collectives scoped to each row of
    shards: ``x`` split by ``spec``, ``body(parts, devices)`` over each
    row, the result concatenated on x's device."""
    blocks = mesh.split(x, spec)
    return mesh.concat(mesh.map_rows(blocks, "sp", body), spec, x.device)


def _time_spec(x, mesh, dp_axis=None) -> list:
    mesh.axis_size("sp")
    spec = [None] * (x.dim() - 1) + ["sp"]
    if dp_axis is not None:
        spec[0] = dp_axis
    return spec


def _n_shard(x, mesh) -> int:
    return x.shape[-1] // mesh.axis_size("sp")


# ---------------------------------------------------------------------------
# FIR with the halo from the left neighbour
# ---------------------------------------------------------------------------


def _local_fir(parts, devices, taps: np.ndarray, block: int | None = None):
    """Causal FIR over a row of time shards; the left halo of taps-1
    samples comes from the left neighbour (zeros into shard 0).
    ``block``: overlap-save FFT block for long shards (None = one
    full-size transform)."""
    m = taps.shape[-1]
    halo = m - 1
    n = parts[0].shape[-1]
    if halo > n:
        # one hop supplies ONE neighbour's tail; a longer halo would need
        # shard k-2 and beyond, which would silently read as zeros
        raise ValueError(
            f"FIR halo {halo} exceeds the per-shard length {n}; use fewer "
            f"'sp' shards (need shard length >= taps-1)")
    if halo > 0:
        lefts = shift_right([p[..., -halo:] for p in parts], devices)
        parts_w = [torch.cat([left, p], dim=-1)
                   for left, p in zip(lefts, parts)]
    else:
        parts_w = parts
    key = ("sp_taps", taps.tobytes())
    out = []
    for xw, d in zip(parts_w, devices):
        h = on_device(key, d, lambda: {"h": taps})["h"]
        if block is not None:
            w = fir_convolve_os(xw, h, block)
        else:
            w = fir_convolve_full(xw, h)
        out.append(w[..., halo: halo + n])
    return out


def _fir_block_auto(n_shard: int, m: int) -> int | None:
    """Overlap-save block for the sharded FIR: None (full transform)
    for short shards, a 64k-floor power of two above the IR otherwise."""
    if n_shard <= 1 << 17:
        return None
    b = 65536
    while b <= 2 * (m - 1):
        b *= 2
    return b


def sp_fir(x: torch.Tensor, taps, mesh, wet: float = 1.0, dry: float = 0.0,
           block: int | str | None = "auto") -> torch.Tensor:
    """Convolve the last axis of ``x`` with ``taps`` (causal, same
    length), time-sharded over the mesh's ``sp`` axis. ``wet``/``dry``
    give the reverb mix (wet=1, dry=0: plain convolution)."""
    x = torch.as_tensor(x)
    taps = np.ascontiguousarray(np.asarray(taps, np.float32))
    if block == "auto":
        block = _fir_block_auto(_n_shard(x, mesh), taps.shape[-1])

    def body(parts, devices):
        ws = _local_fir(parts, devices, taps, block=block)
        return [dry * p + wet * w for p, w in zip(parts, ws)]

    return _shard_map(mesh, x, _time_spec(x, mesh), body)


# ---------------------------------------------------------------------------
# Biquad cascade with the exact cross-shard state chain
# ---------------------------------------------------------------------------


def _fold_affine2(z, row):
    m11, m12, m21, m22, v1, v2 = row
    return torch.stack((m11 * z[0] + m12 * z[1] + v1,
                        m21 * z[0] + m22 * z[1] + v2))


def _local_biquad(parts, devices, sos, state_dtype=torch.float64):
    """Cascaded sections over a row of time shards as associative scans
    in ``state_dtype``, the state chained across the shards section by
    section."""
    sos = np.asarray(sos, np.float64)
    ys = [p.to(state_dtype) for p in parts]
    batch = parts[0].shape[:-1]
    for s in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (float(c) for c in sos[s])
        cums = [_biquad.section_cums(y, b0, b1, b2, a1, a2) for y in ys]
        summaries = [torch.stack([t[..., -1] for t in c]) for c in cums]
        zero = torch.zeros((2,) + tuple(batch), dtype=state_dtype,
                           device=devices[0])
        zins = _prefix_select(summaries, devices, _fold_affine2, zero)
        for k, ((m11, m12, _, _, v1, _), zin) in enumerate(zip(cums, zins)):
            zi1, zi2 = zin[0][..., None], zin[1][..., None]
            z1 = m11 * zi1 + m12 * zi2 + v1
            z1_prev = torch.cat([zi1, z1[..., :-1]], dim=-1)
            ys[k] = b0 * ys[k] + z1_prev
    return [y.to(p.dtype) for y, p in zip(ys, parts)]


def _local_biquad_kernel(parts, devices, sos):
    """Cascaded sections over a row of time shards on the IIR kernel:
    each shard runs ``kernels.iir.sosfilt`` from zero state (segmented
    within the shard by its own rule), then the cross-shard chain applies
    the kernel's own segment-correction math across the shards: the
    shards' zero-state final states v_k are the summaries, incoming
    states fold as ``z @ A_seg.T + v`` in float64 (A_seg = A^n from
    ``kernels.iir._seg_consts``), and the output correction C A^t z is
    one FP32 product against the eigenvalue tables, truncated at the
    filter's memory. A cascade ``_seg_consts`` rejects (not safely
    diagonalizable) runs the exact scan body instead."""
    sos64 = np.asarray(sos, np.float64)
    n = parts[0].shape[-1]
    consts = _kiir._seg_consts(sos64, n)
    if consts is None:
        return _local_biquad(parts, devices, sos64)
    ns = sos64.shape[0]
    D = 2 * ns
    batch = parts[0].shape[:-1]
    R = int(np.prod(batch)) if batch else 1
    runs = [_kiir.sosfilt(sos64, p.float()) for p in parts]
    # zero-state final states (ns, ..., 2) -> (R, D) rows in probe order
    vs = [zf.reshape(ns, R, 2).permute(1, 0, 2).reshape(R, D).double()
          for _, zf in runs]

    def tabs(d):
        return on_device(("sp_biquad", sos64.tobytes(), n), d, lambda: {
            "A_t": np.ascontiguousarray(consts["A_seg"].T),
            "T": np.concatenate([consts["Tr"], consts["Ti"]]),
            "L": np.concatenate([consts["Lr"], -consts["Li"]])})

    a_t = tabs(devices[0])["A_t"]
    zins = _prefix_select(vs, devices, lambda z, v: z @ a_t + v,
                          torch.zeros((R, D), dtype=torch.float64,
                                      device=devices[0]))
    out = []
    for (y0, _), z, d, p in zip(runs, zins, devices, parts):
        require_fp32_matmul(d)
        t = tabs(d)
        # wr @ Lr - wi @ Li as one product, [wr, wi] @ [Lr; -Li]
        w = (z @ t["T"].T).float()
        y = y0.reshape(R, n)
        y[:, :t["L"].shape[-1]].addmm_(w, t["L"])
        out.append(y.reshape(*batch, n).to(p.dtype))
    return out


def sp_biquad(sos, x: torch.Tensor, mesh, state_dtype=torch.float64,
              engine: str = "auto", interpret: bool | None = None):
    """sosfilt over the last axis, time-sharded over the ``sp`` axis.

    ``engine``: ``"scan"`` (associative scans in ``state_dtype``),
    ``"kernel"`` (the IIR kernel and the exact affine state chain), or
    ``"auto"`` (the kernel from 32,768 samples a shard). Both equal the
    single-device ``ops.biquad.sosfilt_scan`` (the scans exactly, the
    kernel to the float32 sequential floor). ``interpret=True``: the
    kernels' twins, refused off the CPU."""
    check_interpret(interpret, *mesh.devices.flat)
    x = torch.as_tensor(x)
    engine = _engine(engine, _n_shard(x, mesh))
    sos = np.asarray(sos, np.float64)

    def body(parts, devices):
        if engine == "kernel":
            return _local_biquad_kernel(parts, devices, sos)
        return _local_biquad(parts, devices, sos, state_dtype)

    return _shard_map(mesh, x, _time_spec(x, mesh), body)


# ---------------------------------------------------------------------------
# Limiter envelope across shards (max-plus and affine chains)
# ---------------------------------------------------------------------------


def _powers(r: float, n: int, dtype, device) -> torch.Tensor:
    """r^t for t = 1..n, as the JAX scan body computes them
    (``exp(t * log(r))`` in ``dtype``); zeros for r = 0."""
    if r <= 0.0:
        return torch.zeros(n, dtype=dtype, device=device)
    expo = torch.arange(1, n + 1, dtype=dtype, device=device)
    return torch.exp(expo * torch.log(torch.tensor(r, dtype=dtype,
                                                   device=device)))


def _local_envelope(parts, devices, k_rel: float, c_att: float):
    """Smoothed envelope over a row of time shards as associative
    scans; the exact cross-shard carries."""
    n = parts[0].shape[-1]
    dt = parts[0].dtype
    batch = tuple(parts[0].shape[:-1])

    def zero(d):
        return torch.zeros(batch, dtype=dt, device=d)

    # decaying max: shard summary (env0[-1], k^n) in (max, *)
    env0s = [_lim.decaying_max_scan(p, k_rel, zero(d))[0]
             for p, d in zip(parts, devices)]
    summ = [torch.stack([e[..., -1], torch.full(batch, float(k_rel) ** n,
                                                dtype=dt, device=d)])
            for e, d in zip(env0s, devices)]
    e_ins = _prefix_select(summ, devices,
                           lambda e, row: torch.maximum(row[0], row[1] * e),
                           zero(devices[0]))
    envs = [torch.maximum(e0, _powers(k_rel, n, dt, d) * ein[..., None])
            for e0, ein, d in zip(env0s, e_ins, devices)]
    if c_att >= 1.0:
        return envs
    # one-pole smoother: affine chain (e2_0[-1], a^n), a zero incoming
    # state corrected after
    a = 1.0 - c_att
    e20s = [_lim.onepole_scan(env, c_att, zero(d))[0]
            for env, d in zip(envs, devices)]
    summ2 = [torch.stack([e[..., -1], torch.full(batch, a ** n, dtype=dt,
                                                 device=d)])
             for e, d in zip(e20s, devices)]
    s_ins = _prefix_select(summ2, devices,
                           lambda e, row: row[0] + row[1] * e,
                           zero(devices[0]))
    return [e2 + _powers(a, n, dt, d) * s[..., None]
            for e2, s, d in zip(e20s, s_ins, devices)]


def _decay_table(r: float, n: int, device) -> torch.Tensor:
    """r^t, t = 1..``_decay_cut(r, n)``, float32 (the correction window
    is the filter's memory: past it r^t < 1e-40)."""
    cut = _kenv._decay_cut(float(r), n)
    return on_device(("sp_decay", float(r), cut), device, lambda: {
        "t": (float(r) ** np.arange(1, cut + 1, dtype=np.float64)
              ).astype(np.float32)})["t"]


def _local_envelope_kernel(parts, devices, k_rel: float, c_att: float):
    """Kernel-engine twin of :func:`_local_envelope`: the two in-shard
    recurrences run as envelope-kernel calls (the decaying max alone,
    then the one-pole alone: the split the segmented envelope uses),
    with the same exact cross-shard folds; the corrections are cut at
    the filter's memory."""
    n = parts[0].shape[-1]
    batch = tuple(parts[0].shape[:-1])
    f32 = torch.float32

    def zero(d):
        return torch.zeros(batch, dtype=f32, device=d)

    # pass A: the decaying max only (c_att = 1: the output is env)
    runs = [_kenv.envelope(p.float(), k_rel, 1.0) for p in parts]
    summ = [torch.stack([last, torch.full(batch, float(k_rel) ** n,
                                          dtype=f32, device=d)])
            for (_, (last, _)), d in zip(runs, devices)]
    e_ins = _prefix_select(summ, devices,
                           lambda e, row: torch.maximum(row[0], row[1] * e),
                           zero(devices[0]))
    envs = []
    for (env, _), ein, d in zip(runs, e_ins, devices):
        decay = _decay_table(k_rel, n, d)
        kc = decay.shape[0]
        env[..., :kc] = torch.maximum(env[..., :kc], decay * ein[..., None])
        envs.append(env)
    if c_att >= 1.0:
        return [e.to(p.dtype) for e, p in zip(envs, parts)]
    # pass B: the one-pole only (k_rel = 0 passes its input through)
    a = 1.0 - float(c_att)
    runs = [_kenv.envelope(env, 0.0, c_att) for env in envs]
    summ2 = [torch.stack([last, torch.full(batch, a ** n, dtype=f32,
                                           device=d)])
             for (_, (_, last)), d in zip(runs, devices)]
    s_ins = _prefix_select(summ2, devices,
                           lambda e, row: row[0] + row[1] * e,
                           zero(devices[0]))
    out = []
    for (e2, _), s, d, p in zip(runs, s_ins, devices, parts):
        apow = _decay_table(a, n, d)
        e2[..., :apow.shape[0]] += apow * s[..., None]
        out.append(e2.to(p.dtype))
    return out


def sp_envelope(d: torch.Tensor, sr: int, mesh, attack_ms: float = 1.0,
                release_ms: float = 100.0, engine: str = "auto",
                interpret: bool | None = None) -> torch.Tensor:
    """The limiter's smoothed envelope of the detector ``d`` (..., n),
    time-sharded over the ``sp`` axis (engines as :func:`sp_biquad`)."""
    check_interpret(interpret, *mesh.devices.flat)
    d = torch.as_tensor(d)
    k_rel = _lim._release_coeff(release_ms, sr)
    c_att = _lim._attack_coeff(attack_ms, sr)
    engine = _engine(engine, _n_shard(d, mesh))

    def body(parts, devices):
        if engine == "kernel":
            return _local_envelope_kernel(parts, devices, k_rel, c_att)
        return _local_envelope(parts, devices, k_rel, c_att)

    return _shard_map(mesh, d, _time_spec(d, mesh), body)


# ---------------------------------------------------------------------------
# The effects chain, time-sharded (config 3's chain on ONE long clip)
# ---------------------------------------------------------------------------


def sp_effects_chain(x: torch.Tensor, sr: int, mesh, bands, ir, wet=0.3,
                     dry=0.7, threshold_db=-3.0, knee_db=6.0, attack_ms=1.0,
                     release_ms=100.0, ceiling_db=0.0,
                     dp_axis: str | None = None, engine: str = "auto",
                     interpret: bool | None = None,
                     fir_block: int | str | None = "auto") -> torch.Tensor:
    """EQ -> FIR reverb -> soft-knee limiter on (ch, n) PCM, the time
    axis sharded over the mesh's ``sp`` axis. Exchanges: one gather of
    the EQ state summaries a section (the scan engine) or one (the
    kernel engine), one taps-1 halo, two small gathers for the limiter;
    everything else is local to each shard.

    ``bands``: EQ band dicts or an (ns, 6) sos array. ``engine``: as
    :func:`sp_biquad` (``"auto"``: the kernels from 32,768 samples a
    shard). ``fir_block``: the sharded reverb's overlap-save block
    (``"auto"``: one transform up to 131,072 samples a shard).

    With ``dp_axis`` (a 2-D ``(dp, sp)`` mesh), ``x`` is (B, ch, n):
    clips shard over ``dp`` while time shards over ``sp``, and the
    ``sp`` exchanges stay inside each ``dp`` row.

    The output equals the single-device chain to float32 tolerance (the
    scan engine exactly, the kernel engine to the sequential float32
    floor, <= -80 dB) and lands on x's device."""
    check_interpret(interpret, *mesh.devices.flat)
    x = torch.as_tensor(x)
    sos = (np.asarray(bands, np.float64) if np.ndim(bands) == 2
           else _biquad.eq_sos(list(bands), sr))
    irh = np.ascontiguousarray(np.asarray(ir, np.float32))
    k_rel = _lim._release_coeff(release_ms, sr)
    c_att = _lim._attack_coeff(attack_ms, sr)
    ceil_amp = 10.0 ** (ceiling_db / 20.0)
    spec = _time_spec(x, mesh, dp_axis)
    n_shard = _n_shard(x, mesh)
    engine = _engine(engine, n_shard)
    if fir_block == "auto":
        fir_block = _fir_block_auto(n_shard, irh.shape[-1])

    def body(parts, devices):
        if engine == "kernel":
            ys = _local_biquad_kernel(parts, devices, sos)
        else:
            ys = _local_biquad(parts, devices, sos)
        ws = _local_fir(ys, devices, irh, block=fir_block)
        ys = [dry * y + wet * w for y, w in zip(ys, ws)]
        if engine == "kernel":
            ds = [y.abs().amax(dim=-2).float() for y in ys]
            e2s = [e.double() for e in _local_envelope_kernel(
                ds, devices, k_rel, c_att)]
        else:
            ds = [y.double().abs().amax(dim=-2) for y in ys]
            e2s = _local_envelope(ds, devices, k_rel, c_att)
        out = []
        for y, e2 in zip(ys, e2s):
            level_db = 20.0 * torch.log10(torch.clamp_min(e2, 1e-12))
            gain = torch.pow(10.0, _lim.soft_knee_gain_db(
                level_db, threshold_db, knee_db) / 20.0)
            out.append(torch.clamp(y.double() * gain[..., None, :],
                                   -ceil_amp, ceil_amp).to(x.dtype))
        return out

    return _shard_map(mesh, x, spec, body)

