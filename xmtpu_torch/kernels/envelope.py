"""Limiter envelope kernels (counterparts of ``xmtpu.kernels.envelope``).

All run the envelope recurrences over rows of a detector signal

    env[t] = max(d[t], k_rel * env[t-1])
    e2[t]  = (1 - c_att) * e2[t-1] + c_att * env[t]

from ``init`` = (env, e2), in the hand-written kernels of
``csrc/envelope.cu``, in three forms:

- :func:`limiter_pass`: one pass of the fused soft-knee limiter over
  signed rows (the JAX ``limiter_pallas`` on its unsegmented path,
  ``curve_mode="apply"``): detector ``|x|``, the recurrences, the gain
  evaluated exactly as the JAX kernel's ``_curve_gain`` (exp/log in
  float32) and the ceiling clamp;
- :func:`envelope_pass` with ``curve_mode="envelope"``: the smoothed
  envelope alone, with an optional inline correction ``d[t] ->
  max(d[t], E * k^(t+1))`` or, instead, the detector ``|d|`` of a
  signed input (``abs_detector``);
- :func:`envelope_pass` with ``curve_mode="gain"``: the envelope-only
  form writing the soft-knee gain of each e2 instead of e2 (the JAX
  kernels' ``curve_mode="gain"``), the curve's log and exp by the card's
  approximate log2 / exp2 (relative error ~2^-22 against
  :func:`curve_gain`).

The last two share one core, 32 rows a block (one per lane of its chain
warp); the fused form keeps its own kernel, 8 rows a block.

:func:`envelope` (the JAX ``envelope_pallas``), :func:`linked_limiter`
(the JAX ``linked_limiter_pallas``) and the fused :func:`limiter` are
time-segmented: each row's S segments run from zero state as R*S rows.
Pass A (:func:`_seg_pass_a`, the decaying max with c_att = 1) and the
exact max chain over the segments are shared; pass B runs the one-pole
(k_rel = 0) over the inline-corrected envelope, from zero state with the
sum chain and the correction ``s_in * a^(t+1)`` after it
(:func:`envelope`), or from the exact per-segment state ``s_in``
(:func:`_seg_e2_carries`: a decay-window dot per segment, then the sum
chain) in the gain form (:func:`linked_limiter`) or, from the exact
``(e_in, s_in)``, in the fused form (:func:`limiter`). The chains over
the segments are closed forms over a table of powers (a masked multiply
and an ``amax`` or a sum: a few launches whatever S is). The glue is
plain torch. On CUDA each driver takes S from the card's rule
(``_seg.card_segments``) fed its form's occupancy query and rows per
block: :func:`limiter` the fused form's (:func:`limiter_segments`),
:func:`envelope` and :func:`linked_limiter` the envelope-only and gain
forms' (:func:`envelope_segments`, :func:`linked_segments`). On the CPU
:func:`limiter` runs unsegmented and the other two pick S as the JAX
package does (``pick_segments(R, n, lanes=256)``), unless ``segments``
says otherwise.

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they
run the plain twins (:func:`limiter_plain`, :func:`envelope_plain`),
torch loops over time, which the CPU tests and the on-card comparison
use. Every form propagates NaN as the JAX kernels' ``jnp.maximum`` and
``jnp.clip`` and the twins' ``torch.maximum``, ``clamp_min`` and
``clamp`` do (the detector, the level meter's floor, the fused form's
ceiling clamp), so a NaN sample or state gives NaN where the twin's
does, segmented or not. The TPU kernels' block-8 lookahead is not used:
the kernel steps per sample, the same function in exact arithmetic.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.kernels._seg import LANES  # noqa: F401  (the JAX value)
from xmtpu_torch.kernels._seg import card_segments, on_device, pick_segments
from xmtpu_torch.utils.profiling import stage

# the JAX package's default block lookahead of its envelope kernel
# (xmtpu.kernels.envelope.DEFAULT_BLOCK); the card's kernels step per
# sample, the same function in exact arithmetic at any block
DEFAULT_BLOCK = 8

# Launches of the CUDA kernel in this process, by form (the fused
# limiter, the envelope alone, the gain form); callers may reset them.
launches = 0
envelope_launches = 0
gain_launches = 0

CURVE_MODES = ("envelope", "gain")  # envelope_pass's forms

# the JAX envelope's lane target, which pick_segments fills
_LANES_TARGET = 256
_MIN_SEGLEN = 4096  # the shortest segment the segment rules make
# envelope()'s on a card (its carries' cost does not depend on S: judged
# by the S sweep of chip_smoke.py phase 7, as graph replays), and the
# multiple of 4 samples the envelope core's tensor-map staging needs
_ENVELOPE_MIN_SEGLEN = 2048
_CORE_ALIGN = 4
# rows of one kernel block: the fused form's (kFusedRows in
# csrc/envelope.cu), and the envelope-only and gain forms' (RowCore::kRows)
_FUSED_ROWS_PER_BLOCK = 8
_ROWS_PER_BLOCK = 32
# the forms of xm_envelope_blocks_per_sm
_FORM_ENVELOPE, _FORM_GAIN = 0, 1

_LN10 = math.log(10.0)
_EPS = 1e-12  # level-meter floor of the curve (and of ops.limiter's)


def _knee_slope(ratio) -> float:
    """Reduction slope from a compression ratio (inf = limiter)."""
    if not float(ratio) >= 1.0:  # also rejects NaN
        raise ValueError(f"ratio must be >= 1 (inf = limiter), got {ratio}")
    return 1.0 if ratio == float("inf") else 1.0 - 1.0 / float(ratio)


def curve_of(threshold_db: float, knee_db: float = 6.0,
             ceiling_db: float = 0.0, ratio: float = float("inf"),
             makeup_db: float = 0.0) -> tuple[float, ...]:
    """The curve 5-tuple (threshold_db, knee_db, ceiling_db, slope,
    makeup_db) of the JAX kernel's ``curve=`` argument."""
    return (float(threshold_db), float(knee_db), float(ceiling_db),
            _knee_slope(ratio), float(makeup_db))


def curve_consts(curve) -> tuple[float, ...]:
    """The curve's constants in the kernel's argument order: (20/ln10,
    eps, threshold, W/2, 2W, slope, makeup, ln10/20, ceiling amp)."""
    threshold_db, knee_db, ceiling_db, slope, makeup_db = map(float, curve)
    w = max(knee_db, 1e-6)
    return (20.0 / _LN10, _EPS, threshold_db, 0.5 * w, 2.0 * w, slope,
            makeup_db, _LN10 / 20.0, 10.0 ** (ceiling_db / 20.0))


def curve_gain(e2: torch.Tensor, consts: tuple[float, ...]) -> torch.Tensor:
    """Soft-knee gain of the smoothed envelope ``e2`` (float32)."""
    lvl, eps, thr, half_w, two_w, slope, makeup, exp_s, _ = consts
    level = lvl * torch.log(torch.clamp_min(e2, eps))
    over = level - thr
    in_knee = slope * (over + half_w) ** 2 / two_w
    red = torch.where(over <= -half_w, 0.0,
                      torch.where(over >= half_w, slope * over, in_knee))
    return torch.exp((makeup - red) * exp_s)


def curve_apply(x: torch.Tensor, e2: torch.Tensor,
                consts: tuple[float, ...]) -> torch.Tensor:
    """Soft-knee gain from ``e2`` applied to ``x``, clamped (float32)."""
    ceil_amp = consts[-1]
    return torch.clamp(x * curve_gain(e2, consts), -ceil_amp, ceil_amp)


def _check_x(x) -> None:
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a 2-D float32 tensor (rows, n)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty x {tuple(x.shape)}")


def _check_init(init, x) -> None:
    R = x.shape[0]
    if (not torch.is_tensor(init) or init.dtype != torch.float32
            or tuple(init.shape) != (2, R) or not init.is_contiguous()
            or init.device != x.device):
        raise ValueError(
            f"init must be a contiguous float32 (2, {R}) tensor on "
            f"{x.device}")


def limiter_plain(x: torch.Tensor, k_rel: float, c_att: float,
                  consts: tuple[float, ...], init: torch.Tensor):
    """Plain twin: the recurrences as a torch loop over time, float32
    coefficients as the kernel receives them, then the curve."""
    k = float(np.float32(k_rel))
    c = float(np.float32(c_att))
    a = float(np.float32(1.0) - np.float32(c_att))
    d = x.abs().T.contiguous()  # (n, R): one contiguous row per step
    env = init[0].clone()
    e2 = init[1].clone()
    e2_t = torch.empty_like(d)
    for t in range(d.shape[0]):
        env = torch.maximum(d[t], k * env)
        e2 = a * e2 + c * env
        e2_t[t] = e2
    return curve_apply(x, e2_t.T, consts), torch.stack([env, e2])


def limiter(x: torch.Tensor, k_rel: float, c_att: float, curve,
            init: torch.Tensor | None = None, segments=None, run=None):
    """x (R, n) contiguous float32 -> (y (R, n), zf (2, R) = (env, e2)).
    ``curve``: the 5-tuple of :func:`curve_of`. ``init``: (2, R)
    float32 starting state, None = zeros.

    ``segments``: time segmentation (exact), None = the card's rule
    (:func:`limiter_segments`) on CUDA and 1 on the CPU; 1 is one fused
    pass (:func:`limiter_pass`). ``run``: pass A's one-pass function,
    :func:`envelope_pass` by default (:func:`envelope_plain` runs pass A
    on the twin)."""
    curve_consts(curve)
    _check_x(x)
    if init is None:
        init = torch.zeros((2, x.shape[0]), dtype=torch.float32,
                           device=x.device)
    _check_init(init, x)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no envelope kernel for device {x.device}")
    R, n = x.shape
    S = (limiter_segments(R, n, c_att, x.device) if segments is None
         else _segments(segments, R, n))
    if S == 1:
        return limiter_pass(x, k_rel, c_att, curve, init)
    return _limiter_seg(x, k_rel, c_att, curve, init, S,
                        envelope_pass if run is None else run)


def limiter_pass(x: torch.Tensor, k_rel: float, c_att: float, curve,
                 init: torch.Tensor):
    """One pass of the fused limiter over independent rows: x (R, n),
    init (2, R), contiguous float32 on one device -> (y (R, n), zf (2,
    R)). The kernel on CUDA, :func:`limiter_plain` on the CPU."""
    global launches
    consts = curve_consts(curve)
    _check_x(x)
    _check_init(init, x)
    if x.device.type == "cpu":
        return limiter_plain(x, k_rel, c_att, consts, init)
    if x.device.type != "cuda":
        raise ValueError(f"no envelope kernel for device {x.device}")
    R, n = x.shape
    lib = _build.load()
    y = torch.empty_like(x)
    zf = torch.empty_like(init)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xm_limiter_f32(
            x.data_ptr(), init.data_ptr(), y.data_ptr(), zf.data_ptr(),
            R, n, k_rel, c_att, *consts, stream)
    _build.check(rc, "envelope")
    launches += 1
    return y, zf


def limiter_segments(R: int, n: int, c_att: float, device) -> int:
    """The fused limiter's segment count: 1 on the CPU; on a card,
    ``_seg.card_segments`` with the kernel's occupancy query, segments
    at least :func:`carry_min_seglen` long."""
    return card_segments(R, n, device, "xm_limiter_blocks_per_sm", (),
                         _FUSED_ROWS_PER_BLOCK, carry_min_seglen(c_att, n), 1)


def carry_min_seglen(c_att: float, n: int) -> int:
    """The shortest segment of a call with envelope carries: 4096
    samples, and the carries' decay window (``_decay_cut(1 - c_att)``)."""
    return max(_MIN_SEGLEN, _decay_cut(1.0 - float(c_att), n))


def _limiter_seg(x, k_rel, c_att, curve, init2, S, run):
    """Segmented fused limiter: pass A (|x| detector, c_att = 1) over
    the R*S segment rows and the max chain give the envelope entering
    each segment, e_in; the decay-window dot and the sum chain give its
    e2, s_in; pass B, the fused form over the same segment rows from
    (e_in, s_in), is then the unsegmented recurrence in exact
    arithmetic. zf is the state after each row's last segment."""
    R, n = x.shape
    with stage("limiter_pass_a"):
        env0, _, e_in, ktab = _seg_pass_a(x, k_rel, init2, S, run,
                                          abs_detector=True)
    with stage("limiter_carries"):
        s_in, _ = _seg_e2_carries(env0, e_in, ktab, c_att, init2[1], S)
    with stage("limiter_pass_b"):
        y, zf_b = limiter_pass(x.reshape(R * S, n // S), k_rel, c_att, curve,
                               torch.stack([e_in, s_in]))
        return y.reshape(R, n), zf_b.reshape(2, R, S)[:, :, -1].contiguous()


# ------------------------------------------------ the envelope alone


def _decay_cut(r: float, n: int) -> int:
    """Samples until r^t < 1e-40 (below any f32 signal's resolution):
    the correction window is the filter's memory, not the segment."""
    if r <= 0.0:
        return 1
    if r >= 1.0:
        return n
    return min(n, int(np.ceil(np.log(1e-40) / np.log(r))))


def seg_ktab(k_rel: float, seglen: int) -> np.ndarray:
    """Pass B's correction column k^(t+1), t < seglen, float32 (the JAX
    ``_seg_pass_a``'s ``ktab``; underflow to 0 is exact)."""
    t1k = np.arange(1, seglen + 1, dtype=np.float64)
    with np.errstate(under="ignore"):
        return (float(k_rel) ** t1k).astype(np.float32)


def seg_atab(c_att: float, seglen: int) -> np.ndarray:
    """The one-pole correction a^(t+1), a = 1 - c_att, for the first
    ``_decay_cut(a, seglen)`` samples, float32 (the JAX
    ``_envelope_seg``'s ``atab``)."""
    a = 1.0 - float(c_att)
    t1a = np.arange(1, _decay_cut(a, seglen) + 1, dtype=np.float64)
    return (a ** t1a).astype(np.float32)


def seg_avec(c_att: float, seglen: int) -> np.ndarray:
    """The decay window a^(ac-1-t), t < ac = ``_decay_cut(a, seglen)``,
    float32 (the JAX ``_linked_seg_gain``'s ``avec``): a zero-init
    segment's final e2 is c_att times its dot with the last ac samples
    of the corrected envelope."""
    a = 1.0 - float(c_att)
    ac = _decay_cut(a, seglen)
    with np.errstate(under="ignore"):
        return (a ** np.arange(ac - 1, -1, -1, dtype=np.float64)).astype(
            np.float32)


def _check_corr(ktab, ecorr, d) -> None:
    if (ktab is None) != (ecorr is None):
        raise ValueError("ktab and ecorr go together")
    if ktab is None:
        return
    R, n = d.shape
    for name, t, size in (("ktab", ktab, n), ("ecorr", ecorr, R)):
        if (not torch.is_tensor(t) or t.dtype != torch.float32
                or tuple(t.shape) != (size,) or not t.is_contiguous()
                or t.device != d.device):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"({size},) tensor on {d.device}")


def _check_mode(curve, curve_mode, abs_detector=False, ktab=None) -> None:
    """One of the pass's two forms, with what it takes."""
    if curve_mode not in CURVE_MODES:
        raise ValueError(f"curve_mode={curve_mode!r}; the pass's forms "
                         f"are {CURVE_MODES} (the fused form is limiter())")
    if (curve is None) != (curve_mode == "envelope"):
        raise ValueError(f"curve_mode={curve_mode!r} "
                         + ("takes no curve" if curve is not None
                            else "needs the curve"))
    if abs_detector and (curve_mode != "envelope" or ktab is not None):
        raise ValueError("abs_detector is the envelope form's, without "
                         "the inline correction (the limiter's pass A)")


def envelope_plain(d: torch.Tensor, k_rel: float, c_att: float,
                   init: torch.Tensor, ktab=None, ecorr=None, curve=None,
                   curve_mode: str = "envelope", abs_detector: bool = False):
    """Plain twin of one pass (:func:`envelope_pass`): a torch loop over
    time, float32 coefficients as the kernel receives them and one
    elementwise op per operation, so its e2 matches the kernel bit for
    bit; the gain form then applies :func:`curve_gain`."""
    _check_mode(curve, curve_mode, abs_detector, ktab)
    k = float(np.float32(k_rel))
    c = float(np.float32(c_att))
    a = float(np.float32(1.0) - np.float32(c_att))
    dt = (d.abs() if abs_detector else d).T.contiguous()  # (n, R)
    if ktab is not None:
        dt = torch.maximum(dt, ecorr[None, :] * ktab[:, None])
    env = init[0].clone()
    e2 = init[1].clone()
    e2_t = torch.empty_like(dt)
    for t in range(dt.shape[0]):
        env = torch.maximum(dt[t], k * env)
        e2 = a * e2 + c * env
        e2_t[t] = e2
    out = e2_t.T.contiguous()
    if curve_mode == "gain":
        out = curve_gain(out, curve_consts(curve))
    return out, torch.stack([env, e2])


def envelope_pass(d: torch.Tensor, k_rel: float, c_att: float,
                  init: torch.Tensor, ktab=None, ecorr=None, curve=None,
                  curve_mode: str = "envelope", abs_detector: bool = False):
    """One pass of the recurrences over independent rows: d (R, n),
    init (2, R), and optionally the inline correction ``d[t] ->
    max(d[t], ecorr[r] * ktab[t])`` (ktab (n,), ecorr (R,)); contiguous
    float32 on one device -> (out (R, n), zf (2, R) = (env, e2)).

    ``curve_mode`` picks the kernel's form: ``"envelope"`` (out = e2)
    or ``"gain"`` (out = the soft-knee gain of e2 under ``curve``, the
    5-tuple of :func:`curve_of`); any other value raises.
    ``abs_detector`` (envelope form, no correction): d is signed and
    the detector is ``|d|``, taken in the kernel. The kernel on CUDA,
    the twin on the CPU."""
    global envelope_launches, gain_launches
    _check_mode(curve, curve_mode, abs_detector, ktab)
    _check_x(d)
    _check_init(init, d)
    _check_corr(ktab, ecorr, d)
    if d.device.type == "cpu":
        return envelope_plain(d, k_rel, c_att, init, ktab, ecorr, curve,
                              curve_mode, abs_detector)
    if d.device.type != "cuda":
        raise ValueError(f"no envelope kernel for device {d.device}")
    R, n = d.shape
    lib = _build.load()
    out = torch.empty_like(d)
    zf = torch.empty_like(init)
    ptrs = (d.data_ptr(), init.data_ptr(),
            None if ktab is None else ktab.data_ptr(),
            None if ecorr is None else ecorr.data_ptr(),
            out.data_ptr(), zf.data_ptr())
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        if curve_mode == "gain":
            rc = lib.xm_envelope_gain_f32(*ptrs, R, n, k_rel, c_att,
                                          *curve_consts(curve), stream)
        else:
            rc = lib.xm_envelope_f32(*ptrs, R, n, k_rel, c_att,
                                     int(abs_detector), stream)
    _build.check(rc, "envelope")
    if curve_mode == "gain":
        gain_launches += 1
    else:
        envelope_launches += 1
    return out, zf


def _seg_table(name: str, make, coef: float, seglen: int,
               device) -> torch.Tensor:
    """A host table of the segmented path on ``device`` (cached)."""
    return on_device((name, float(coef), seglen), device,
                     lambda: {name: make(coef, seglen)})[name]


def _chain_powers(coef: float, S: int) -> dict:
    """The closed form of the chain s_k = f_(k-1) + coef * s_(k-1) over
    S segments: s_k = sum (or max) over j of pow[k, j] * v[j], v = (s_0,
    f_0 .. f_(S-1)), with pow[k, 0] = coef^k and pow[k, j+1] =
    coef^(k-1-j) for j < k, k = 0 .. S. Returns ``pow`` (S+1, S+1)
    float32 (float64 powers of the float32 coefficient, rounded once)
    and ``mask``, where pow applies."""
    k = np.arange(S + 1)[:, None]
    j = np.arange(S + 1)[None, :]
    e = np.where(j == 0, k, k - j)
    mask = (j == 0) | (j <= k)
    c = float(np.float32(coef))
    with np.errstate(under="ignore"):
        pw = np.where(mask, c ** np.maximum(e, 0).astype(np.float64), 0.0)
    return {"pow": pw.astype(np.float32), "mask": mask}


def _decay(coef, seglen: int) -> float:
    """A segment's decay as the kernel steps it: the float32
    coefficient to the power seglen (in float64)."""
    return float(np.float32(coef)) ** seglen


def _chain(first, finals, coef, reduce):
    """All S+1 states of a segment chain (:func:`_chain_powers`):
    ``first`` (R,) the state entering segment 0, ``finals`` (R, S) each
    segment's zero-init final; ``reduce`` "max" (the decaying max) or
    "sum" (the one-pole). -> (R, S+1): entering each segment, then after
    the last. Masked, so a NaN final reaches only later segments."""
    S = finals.shape[1]
    t = on_device(("chain", float(np.float32(coef)), S), first.device,
                  lambda: _chain_powers(coef, S))
    v = torch.cat([first[:, None], finals], 1)[:, None, :]  # (R, 1, S+1)
    terms = torch.where(t["mask"], t["pow"] * v, 0.0)
    return terms.amax(-1) if reduce == "max" else terms.sum(-1)


def _seg_pass_a(d2d, k_rel, init2, S, run, **kw):
    """Segmented pass A (the decaying max from zero state, c_att = 1,
    over R*S segment rows; ``kw`` to ``run``) and the exact max chain
    over the segments, shared by every pass-B strategy (the JAX
    ``_seg_pass_a``). Returns (env0 (R*S, seglen), e_last (R,), e_in
    (R*S,) the envelope entering each segment, ktab (seglen,) pass B's
    correction column)."""
    R, n = d2d.shape
    seglen = n // S
    env0, zf_a = run(d2d.reshape(R * S, seglen), k_rel, 1.0,
                     d2d.new_zeros((2, R * S)), **kw)
    return (env0, *_seg_max_carries(init2[0], zf_a[0].reshape(R, S), k_rel,
                                    seglen))


def _seg_max_carries(e_first, finals, k_rel, seglen):
    """The exact max chain over the segments: ``e_first`` (R,) the
    envelope entering each row, ``finals`` (R, S) each segment's
    zero-state final envelope -> (e_last (R,), e_in (R*S,) the envelope
    entering each segment, ktab (seglen,) pass B's correction column)."""
    R, S = finals.shape
    e = _chain(e_first, finals, _decay(k_rel, seglen), "max")
    ktab = _seg_table("ktab", seg_ktab, k_rel, seglen, finals.device)
    return e[:, S], e[:, :S].reshape(R * S), ktab


def _seg_e2_carries(env0, e_in, ktab, c_att, s0, S):
    """The exact e2 entering each segment, s_in (R*S,), and after each
    row's last, (R,): a zero-init segment's final e2 depends only on the
    last ``_decay_cut(a)`` samples of its corrected envelope (a^t is
    below any float32 signal's resolution past that), so one
    decay-window dot per segment row gives the finals that the sum
    chain carries from ``s0`` (R,)."""
    RS, seglen = env0.shape
    avec = _seg_table("avec", seg_avec, c_att, seglen, env0.device)
    ac = avec.shape[0]
    tail = torch.maximum(env0[:, seglen - ac:],
                         e_in[:, None] * ktab[seglen - ac:])
    # float32 multiply and sum (no matmul, so no TF32 question)
    e2f = (float(c_att) * (tail * avec).sum(-1)).reshape(RS // S, S)
    s = _chain(s0, e2f, _decay(1.0 - np.float32(c_att), seglen), "sum")
    return s[:, :S].reshape(RS), s[:, S]


def _seg_pass_b(env0, e_in, ktab, c_att, s0, S, run):
    """Pass B of the segmented envelope: the one-pole alone (k_rel = 0
    passes the input through) over the zero-state decaying max ``env0``
    (R*S, seglen) corrected inline, max(env0[t], e_in * k^(t+1)), from
    zero state; then the sum chain from ``s0`` (R,) and the correction
    ``s_in * a^(t+1)``. Returns (e2 (R*S, seglen), e2_last (R,))."""
    RS, seglen = env0.shape
    e2, zf_b = run(env0, 0.0, c_att, env0.new_zeros((2, RS)), ktab, e_in)
    s = _chain(s0, zf_b[1].reshape(RS // S, S),
               _decay(1.0 - np.float32(c_att), seglen), "sum")
    atab = _seg_table("atab", seg_atab, c_att, seglen, env0.device)
    e2[:, :atab.shape[0]] += s[:, :S].reshape(RS, 1) * atab
    return e2, s[:, S]


def _in_stage(name: str, run):
    """``run`` with each call inside the range ``xmtpu_torch.<name>``."""
    def staged(*args, **kw):
        with stage(name):
            return run(*args, **kw)
    return staged


def _envelope_seg(d2d, k_rel, c_att, init2, S, run):
    """Segmented exact envelope: d2d (R, n) -> (e2 (R, n), zf (2, R)).
    Each pass's launch runs inside its own range (``envelope_pass_a``,
    ``envelope_pass_b``); the segment chains and the correction do not."""
    R, n = d2d.shape
    env0, e_last, e_in, ktab = _seg_pass_a(
        d2d, k_rel, init2, S, _in_stage("envelope_pass_a", run))
    e2, e2_last = _seg_pass_b(env0, e_in, ktab, c_att, init2[1], S,
                              _in_stage("envelope_pass_b", run))
    return e2.reshape(R, n), torch.stack([e_last, e2_last])


def _init2(init, R, device):
    """(env, e2), each (...,) with R elements, or None -> (2, R)."""
    if init is None:
        return torch.zeros((2, R), dtype=torch.float32, device=device)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                         device=device).reshape(R)
                        for v in init]).contiguous()


def envelope_segments(R: int, n: int, device) -> int:
    """The segment count of :func:`envelope`: on a card,
    ``_seg.card_segments`` with the envelope-only form's occupancy query
    and 32 rows per block, segments at least 2048 samples (the carries'
    ``atab`` correction costs the same at any S) and a multiple of 4;
    elsewhere the JAX rule, ``pick_segments(R, n, lanes=256)``."""
    return card_segments(R, n, device, "xm_envelope_blocks_per_sm",
                         (_FORM_ENVELOPE,), _ROWS_PER_BLOCK,
                         _ENVELOPE_MIN_SEGLEN,
                         pick_segments(R, n, lanes=_LANES_TARGET),
                         _CORE_ALIGN)


def linked_segments(R: int, n: int, c_att: float, device) -> int:
    """The segment count of :func:`linked_limiter`: on a card,
    ``_seg.card_segments`` with the gain form's occupancy query and 32
    rows per block, segments at least :func:`carry_min_seglen` long (the
    decay window of the e2 carries) and a multiple of 4; elsewhere the
    JAX rule, ``pick_segments(R, n, lanes=256)``."""
    return card_segments(R, n, device, "xm_envelope_blocks_per_sm",
                         (_FORM_GAIN,), _ROWS_PER_BLOCK,
                         carry_min_seglen(c_att, n),
                         pick_segments(R, n, lanes=_LANES_TARGET),
                         _CORE_ALIGN)


def _segments(segments, R, n) -> int:
    S = int(segments)
    if S < 1 or n % S:
        raise ValueError(f"segments={S} does not divide n={n} (exact state "
                         "corrections need equal segments)")
    return S


def envelope(d: torch.Tensor, k_rel: float, c_att: float, init=None,
             segments=None, n_valid=None, run=None):
    """Smoothed limiter envelope of the detector ``d`` (..., n) float32
    -> (e2 (..., n), (env_last, e2_last) each (...,)).

    ``init``: (env, e2), each (...,), or None (zeros). ``segments``:
    time segmentation (exact; 1 = one pass with (k_rel, c_att)), None =
    :func:`envelope_segments`: the card's rule on CUDA, the JAX
    package's ``pick_segments(R, n, lanes=256)`` on the CPU.
    ``n_valid``: only the first n_valid samples are signal. ``run``: the
    one-pass function, :func:`envelope_pass` by default; passing
    :func:`envelope_plain` runs the same path on the twin.

    ``d`` and ``init`` must be nonnegative (the limiter's ``|x|``
    detector): the max-chain corrections compose with the zero-init
    pass, which floors the envelope at 0."""
    if not torch.is_tensor(d) or d.dtype != torch.float32 or d.dim() < 1:
        raise ValueError("d must be a float32 tensor (..., n)")
    batch = d.shape[:-1]
    n = d.shape[-1] if n_valid is None else int(n_valid)
    if not 1 <= n <= d.shape[-1]:
        raise ValueError(f"n_valid={n} outside [1, {d.shape[-1]}]")
    R = int(np.prod(batch)) if batch else 1
    d2d = d.reshape(R, d.shape[-1])[:, :n].contiguous()
    init2 = _init2(init, R, d.device)
    S = (envelope_segments(R, n, d.device) if segments is None
         else _segments(segments, R, n))
    run = envelope_pass if run is None else run
    if S > 1:
        e2, zf = _envelope_seg(d2d, k_rel, c_att, init2, S, run)
    else:
        e2, zf = run(d2d, k_rel, c_att, init2)
    return e2.reshape(*batch, n), (zf[0].reshape(batch),
                                   zf[1].reshape(batch))


# ------------------------------------------ the channel-linked limiter


def _linked_seg_gain(d2d, k_rel, c_att, init2, S, curve, run):
    """Segmented envelope whose pass B writes the soft-knee gain (the
    JAX ``_linked_seg_gain``): pass B starts each segment from its exact
    one-pole state ``s_in`` (:func:`_seg_e2_carries`), so the curve can
    run in the kernel. Returns (g (R, n), zf (2, R) = (env_last,
    e2_last))."""
    R, n = d2d.shape
    env0, e_last, e_in, ktab = _seg_pass_a(d2d, k_rel, init2, S, run)
    s_in, s = _seg_e2_carries(env0, e_in, ktab, c_att, init2[1], S)
    init_b = torch.stack([torch.zeros_like(s_in), s_in])
    g, _ = run(env0, 0.0, c_att, init_b, ktab, e_in, curve=curve,
               curve_mode="gain")
    return g.reshape(R, n), torch.stack([e_last, s])


def linked_limiter(x: torch.Tensor, k_rel: float, c_att: float,
                   threshold_db: float, knee_db: float = 6.0,
                   ceiling_db: float = 0.0, ratio: float = float("inf"),
                   makeup_db: float = 0.0, init=None, n_valid=None,
                   segments=None, run=None):
    """Channel-linked soft-knee limiter of ``x`` (..., ch, n) float32
    (the JAX ``linked_limiter_pallas``): one gain per time step from
    the linked detector ``max_ch |x|``, evaluated in the gain form of
    the envelope kernel, applied to every channel and clamped at the
    ceiling. Returns (y (..., ch, n_valid or n), (env_last, e2_last)
    each (...,)).

    ``init``: (env, e2), each (...,), or None (zeros). ``segments``:
    time segmentation (S = 1: one gain-form pass with (k_rel, c_att)),
    None = :func:`linked_segments`: the card's rule on CUDA, the JAX
    package's ``pick_segments(R, n, lanes=256)`` on the CPU. ``run``:
    the one-pass function, :func:`envelope_pass` by default;
    :func:`envelope_plain` runs the same path on the twin."""
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() < 2:
        raise ValueError(f"linked limiter needs a float32 (..., ch, n) "
                         f"tensor, got {getattr(x, 'shape', x)!r}")
    curve = curve_of(threshold_db, knee_db, ceiling_db, ratio, makeup_db)
    batch = x.shape[:-2]
    n = x.shape[-1] if n_valid is None else int(n_valid)
    if not 1 <= n <= x.shape[-1]:
        raise ValueError(f"n_valid={n} outside [1, {x.shape[-1]}]")
    xf = x[..., :n]
    R = int(np.prod(batch)) if batch else 1
    d2d = torch.amax(xf.abs(), dim=-2).reshape(R, n).contiguous()
    init2 = _init2(init, R, x.device)
    S = (linked_segments(R, n, c_att, x.device) if segments is None
         else _segments(segments, R, n))
    run = envelope_pass if run is None else run
    if S > 1:
        g2, zf = _linked_seg_gain(d2d, k_rel, c_att, init2, S, curve, run)
    else:
        g2, zf = run(d2d, k_rel, c_att, init2, curve=curve,
                     curve_mode="gain")
    ceil_amp = 10.0 ** (float(ceiling_db) / 20.0)
    y = torch.clamp(xf * g2.reshape(*batch, 1, n), -ceil_amp, ceil_amp)
    return y, (zf[0].reshape(batch), zf[1].reshape(batch))
