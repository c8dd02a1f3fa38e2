"""Fused biquad-cascade EQ + limiter envelope over mono rows
(counterpart of ``xmtpu.kernels.eq_env.eq_env_pallas``).

Per sample, in the JAX kernel's operation order (``v`` = the input,
then each section's output):

    per section:  y = b0*v + z1;  z1' = b1*v - a1*y + z2;  z2' = b2*v - a2*y
    env = max(|y|, k_rel * env);  e2 = (1 - c_att) * e2 + c_att * env

emitting the cascade output ``y`` and the smoothed envelope ``e2``: the
EQ and the limiter's detector in one sequential pass, the
``sosfilt`` -> ``envelope(|y|)`` composition. The flagship chain's
fused branch runs it when the EQ does not fold into the reverb.

On a CUDA tensor :func:`eq_env_pass` launches the hand-written kernel
``csrc/eq_env.cu``; on a CPU tensor it runs :func:`eq_env_plain`, a
torch loop over time with one elementwise op per operation, float32
coefficients as the kernel receives them, which the kernel equals bit
for bit.

:func:`eq_env` splits each row into S equal time segments, S from the
card's rule (:func:`eq_env_segments`) on CUDA and 1 on the CPU unless
``segments`` says otherwise, and computes the same function exactly:
the cascade is LTI and the envelope a decaying max followed by a
one-pole, so three passes over the R*S segment rows and chains over the
segments give the unsegmented result in exact arithmetic. Pass 0 (the
kernel's finals-only instance) gives each segment's zero-state final
cascade state, from which the exact state entering each segment follows
in float64 (``iir._state_chain``, K5's chain); pass A runs the kernel
from those states with the envelope at zero state and ``c_att = 1``, so
``y`` is the cascade's output and ``e2`` the segment's zero-state
decaying max (the envelope's pass A); pass B and the envelope's chains
are the segmented envelope's (``envelope._seg_max_carries``,
``envelope._seg_pass_b``: the envelope-only kernel with the inline
correction).
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.kernels import _build, envelope, iir
from xmtpu_torch.kernels._seg import LANES  # noqa: F401  (the JAX value)
from xmtpu_torch.kernels._seg import card_segments, on_device

# Launches of the CUDA kernel in this process, both instances; callers
# may reset it.
launches = 0

MAX_SECTIONS = 8  # the kernel's largest template instance
_ROWS_PER_BLOCK = 32  # rows of one kernel block (Pipe::kRows in the source)


def _check(x, sos, zi, ei) -> None:
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a 2-D float32 tensor (rows, n)")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    R, n = x.shape
    if R < 1 or n < 1:
        raise ValueError(f"empty x {tuple(x.shape)}")
    if (not torch.is_tensor(sos) or sos.dtype != torch.float32
            or sos.dim() != 2 or sos.shape[1] != 6
            or not sos.is_contiguous() or sos.device != x.device):
        raise ValueError(f"sos must be a contiguous float32 (ns, 6) tensor "
                         f"on {x.device}")
    ns = sos.shape[0]
    if not 1 <= ns <= MAX_SECTIONS:
        raise ValueError(f"{ns} sections: the kernel takes 1 to "
                         f"{MAX_SECTIONS}")
    for name, t, shape in (("zi", zi, (ns, 2, R)), ("ei", ei, (2, R))):
        if (not torch.is_tensor(t) or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {x.device}")


def eq_env_plain(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor,
                 ei: torch.Tensor, k_rel: float, c_att: float,
                 finals_only: bool = False):
    """Plain twin of the kernel: a torch loop over time on (R,) vectors,
    one elementwise op per operation, float32. ``finals_only``: as
    :func:`eq_env_pass`."""
    coef = [[float(c) for c in row] for row in sos.tolist()]
    k = float(np.float32(k_rel))
    c = float(np.float32(c_att))
    a = float(np.float32(1.0) - np.float32(c_att))
    z = [[zi[s, 0].clone(), zi[s, 1].clone()] for s in range(len(coef))]
    env = ei[0].clone()
    e2 = ei[1].clone()
    xt = x.T.contiguous()  # (n, R): one contiguous row per step
    yt = torch.empty_like(xt)
    et = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        v = xt[t]
        for s, (b0, b1, b2, _, a1, a2) in enumerate(coef):
            z1, z2 = z[s]
            y = b0 * v + z1
            z[s] = [b1 * v - a1 * y + z2, b2 * v - a2 * y]
            v = y
        yt[t] = v
        env = torch.maximum(v.abs(), k * env)
        e2 = a * e2 + c * env
        et[t] = e2
    zf = torch.stack([torch.stack(zs) for zs in z])
    if finals_only:
        return None, None, zf, None
    return yt.T.contiguous(), et.T.contiguous(), zf, torch.stack([env, e2])


def eq_env_pass(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor,
                ei: torch.Tensor, k_rel: float, c_att: float,
                finals_only: bool = False):
    """One pass over independent rows: x (R, n), sos (ns, 6), zi (ns, 2,
    R), ei (2, R) = (env, e2), contiguous float32 on one device -> (y
    (R, n), e2 (R, n), zf (ns, 2, R), ef (2, R)). ``finals_only``: the
    cascade's final state alone, (None, None, zf, None) (the kernel's
    finals-only instance: it stores no y and no e2). The kernel on CUDA,
    the twin on the CPU."""
    global launches
    _check(x, sos, zi, ei)
    if x.device.type == "cpu":
        return eq_env_plain(x, sos, zi, ei, k_rel, c_att, finals_only)
    if x.device.type != "cuda":
        raise ValueError(f"no eq_env kernel for device {x.device}")
    R, n = x.shape
    lib = _build.load()
    zf = torch.empty_like(zi)
    y = e2 = ef = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if finals_only:
            rc = lib.xm_eq_env_finals_f32(x.data_ptr(), sos.data_ptr(),
                                          zi.data_ptr(), zf.data_ptr(), R,
                                          n, sos.shape[0], stream)
        else:
            y = torch.empty_like(x)
            e2 = torch.empty_like(x)
            ef = torch.empty_like(ei)
            rc = lib.xm_eq_env_f32(x.data_ptr(), sos.data_ptr(),
                                   zi.data_ptr(), ei.data_ptr(), y.data_ptr(),
                                   e2.data_ptr(), zf.data_ptr(),
                                   ef.data_ptr(), R, n, sos.shape[0], k_rel,
                                   c_att, stream)
    _build.check(rc, "eq_env")
    launches += 1
    return y, e2, zf, ef


# The one-pass functions of the segmented path: the kernels (K6, then
# the envelope-only form for pass B) and their plain twins.
KERNELS = (eq_env_pass, envelope.envelope_pass)
TWINS = (eq_env_plain, envelope.envelope_plain)


def eq_env_segments(R: int, n: int, c_att: float, device, ns: int) -> int:
    """The segment count of :func:`eq_env`: 1 on the CPU; on a card,
    ``_seg.card_segments`` with the kernel's occupancy query at ``ns``
    sections, segments at least ``envelope.carry_min_seglen`` long."""
    return card_segments(R, n, device, "xm_eq_env_blocks_per_sm", (ns,),
                         _ROWS_PER_BLOCK,
                         envelope.carry_min_seglen(c_att, n), 1)


def _eq_env_seg(x2d, sos32, zi3, ei, k_rel, c_att, S, a_t, run):
    """Segmented exact EQ + envelope: x2d (R, n) -> (y (R, n), e2 (R,
    n), zf (ns, 2, R), ef (2, R)). Row r*S + k is segment k of row r."""
    eq_run, env_run = run
    ns = sos32.shape[0]
    R, n = x2d.shape
    seglen = n // S
    xs = x2d.reshape(R * S, seglen)
    zeros = x2d.new_zeros((2, R * S))
    # pass 0: each segment's zero-state final cascade state
    _, _, zf0, _ = eq_run(xs, sos32, x2d.new_zeros((ns, 2, R * S)), zeros,
                          k_rel, c_att, finals_only=True)
    zin, z = iir._state_chain(zf0, zi3, a_t, S)
    zin32 = zin.reshape(R * S, ns, 2).permute(1, 2, 0).float().contiguous()
    # pass A: the cascade's output from the exact entering state; with
    # the envelope at zero state and c_att = 1, e2 is the segment's
    # zero-state decaying max of |y|
    y, env0, _, ef_a = eq_run(xs, sos32, zin32, zeros, k_rel, 1.0)
    e_last, e_in, ktab = envelope._seg_max_carries(
        ei[0], ef_a[0].reshape(R, S), k_rel, seglen)
    e2, e2_last = envelope._seg_pass_b(env0, e_in, ktab, c_att, ei[1], S,
                                       env_run)
    zf = z.reshape(R, ns, 2).permute(1, 2, 0).float().contiguous()
    return (y.reshape(R, n), e2.reshape(R, n), zf,
            torch.stack([e_last, e2_last]))


def eq_env(sos, x: torch.Tensor, k_rel: float, c_att: float, zi=None,
           env_init=None, segments=None, run=None):
    """Fused EQ + envelope of mono rows ``x`` (..., n) float32 -> (y,
    e2, zf, (env_last, e2_last)) with the JAX ``eq_env_pallas``'s
    shapes: y and e2 like x, zf (ns, ..., 2), the last states (...,).

    ``sos``: host (ns, 6) array, 1 to 8 sections. ``zi``: (ns, ..., 2)
    or None (zeros); ``env_init``: (env, e2), each (...,), or None.
    ``segments``: time segmentation (exact), None = the card's rule
    (:func:`eq_env_segments`) on CUDA and 1 on the CPU; 1 is one pass;
    S must divide n. A cascade that ``iir._seg_consts`` rejects
    (unstable or ill-conditioned) runs in one pass. ``run``: the pair
    of one-pass functions (K6's, pass B's), :data:`KERNELS` by default;
    :data:`TWINS` runs the same path on the plain twins."""
    sos_host = np.asarray(sos, np.float64)
    if sos_host.ndim != 2 or sos_host.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos_host.shape}")
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError("x must be a float32 tensor (..., n)")
    ns = sos_host.shape[0]
    if not 1 <= ns <= MAX_SECTIONS:
        raise ValueError(f"{ns} sections: the kernel takes 1 to "
                         f"{MAX_SECTIONS}")
    batch, n = x.shape[:-1], x.shape[-1]
    R = int(np.prod(batch)) if batch else 1
    dev = x.device
    x2d = x.reshape(R, n).contiguous()
    if zi is None:
        zi3 = x.new_zeros((ns, 2, R))
    else:
        zi3 = torch.as_tensor(zi, dtype=torch.float32, device=dev).reshape(
            ns, R, 2).permute(0, 2, 1).contiguous()
    if env_init is None:
        ei = x.new_zeros((2, R))
    else:
        ei = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                          device=dev).reshape(R)
                          for v in env_init]).contiguous()
    S = (eq_env_segments(R, n, c_att, dev, ns) if segments is None
         else envelope._segments(segments, R, n))
    key = sos_host.tobytes()
    sos32 = on_device(key, dev, lambda: {
        "sos": sos_host.astype(np.float32)})["sos"]
    run = KERNELS if run is None else run
    consts = iir._seg_consts(sos_host, n // S) if S > 1 else None
    if consts is None:
        y, e2, zf3, ef = run[0](x2d, sos32, zi3, ei, k_rel, c_att)
    else:
        a_seg = on_device(("A_seg", key, n // S), dev, lambda: {
            "A_seg": consts["A_seg"]})["A_seg"]
        y, e2, zf3, ef = _eq_env_seg(x2d, sos32, zi3, ei, k_rel, c_att, S,
                                     a_seg.T, run)
    return (y.reshape(*batch, n), e2.reshape(*batch, n),
            zf3.permute(0, 2, 1).reshape((ns,) + batch + (2,)),
            (ef[0].reshape(batch), ef[1].reshape(batch)))
