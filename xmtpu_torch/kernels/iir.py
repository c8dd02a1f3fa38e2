"""Biquad cascade (IIR) over rows, time-segmented
(counterpart of ``xmtpu.kernels.iir.sosfilt_pallas``).

Per section, within one sample (``v`` = the previous section's output):

    y = b0*v + z1;   z1' = b1*v - a1*y + z2;   z2' = b2*v - a2*y

On a CUDA tensor :func:`sosfilt_pass` launches the hand-written kernel
``csrc/iir.cu`` (the cascade pipelined across the lanes of a warp). On a
CPU tensor it runs :func:`sosfilt_plain`, a torch loop over time in the
same operation order with the same float32 roundings, which the CPU
tests and the on-card comparison use.

:func:`sosfilt` splits each row into S equal time segments, S from the
card's rule (:func:`sosfilt_segments`: ``_seg.card_segments`` over the
kernel's occupancy) on CUDA and from the JAX package's
``pick_segments`` elsewhere, filters them from zero state as R*S rows in
one pass and corrects exactly. The cascade is LTI with state-space
matrices A, C (probed from the recurrence, :func:`_seg_consts`), so a
segment entered with state z outputs ``y0[t] + C A^t z``: the incoming
states chain over the segments in float64 (``z @ A_seg.T + v``;
:func:`_state_chain`, one launch of ``csrc/seg_chain.cu`` on CUDA, the
torch loop :func:`state_chain_plain` elsewhere), and the correction
``wr @ Lr - wi @ Li`` (A^t through its eigendecomposition, cut where
every |lam|^t < 1e-40) is one FP32 matmul, ``[wr, wi] @ [Lr; -Li]``,
added into the first ``t_cut`` samples of each segment. The host tables
are numpy, bit-exact with the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.kernels._seg import LANES  # noqa: F401  (the JAX value)
from xmtpu_torch.kernels._seg import card_segments, on_device, pick_segments
from xmtpu_torch.ops.precision import require_fp32_matmul

# Launches of the CUDA kernels in this process (the cascade, the float64
# state chain); callers may reset them.
launches = 0
chain_launches = 0

MAX_SECTIONS = 8  # the kernel's largest template instance
# The kernel's schedule (csrc/iir.cu): kChunk samples staged at a time;
# section s of a row on lane g*ns + s, kSkew ticks behind section s-1,
# 32 // ns rows per block (one warp).
CHUNK = 64
SKEW = 4
# K5's least segment length. The JAX rule's 4096 would stop the card's
# rule at S = 32 for 160000 samples; the S sweep of the sosfilt() call
# (chip_smoke.py phase 6) on an H100 measured it 30% faster on the card
# at S = 64 and no slower from the host, so the rule may go to 2048.
MIN_SEGLEN = 2048

_SEG_CACHE: dict = {}


def _cascade_step_np(state, x, sos):
    """One f64 numpy step of the kernel's exact cascade recurrence.
    ``state``: (ns, 2). -> (y, new_state)."""
    v = x
    new = np.empty_like(state)
    for s in range(sos.shape[0]):
        b0, b1, b2, a1, a2 = (sos[s, 0], sos[s, 1], sos[s, 2], sos[s, 4],
                              sos[s, 5])
        z1, z2 = state[s, 0], state[s, 1]
        y = b0 * v + z1
        new[s, 0] = b1 * v - a1 * y + z2
        new[s, 1] = b2 * v - a2 * y
        v = y
    return v, new


def _seg_consts(sos_np: np.ndarray, seglen: int):
    """Host segmentation constants for one (sos, seglen): ``A_seg`` =
    A^seglen (f64), ``Tr``/``Ti`` (the eigenbasis map, f64) and
    ``Lr``/``Li`` (lam^t for t < t_cut, f32); None when the cascade is
    unstable or not safely diagonalizable (the caller runs unsegmented)."""
    key = (sos_np.tobytes(), seglen)
    if key in _SEG_CACHE:
        return _SEG_CACHE[key]
    sos64 = np.asarray(sos_np, np.float64)
    ns = sos64.shape[0]
    D = 2 * ns
    A = np.zeros((D, D))
    C = np.zeros(D)
    for j in range(D):  # probe the recurrence with unit states, x=0
        e = np.zeros(D)
        e[j] = 1.0
        y, nstate = _cascade_step_np(e.reshape(ns, 2).copy(), 0.0, sos64)
        A[:, j] = nstate.reshape(D)
        C[j] = y
    lam, V = np.linalg.eig(A)
    if np.max(np.abs(lam)) >= 1.0 - 1e-12 or np.linalg.cond(V) > 1e8:
        _SEG_CACHE[key] = None
        return None
    T = (C @ V)[:, None] * np.linalg.inv(V)  # corr = sum_j lam_j^t (T z)_j
    # the per-sample table stops where every |lam|^t < 1e-40: the
    # correction is below any f32 signal's resolution past that
    lam_max = float(np.max(np.abs(lam)))
    t_cut = seglen if lam_max <= 0.0 else min(
        seglen, int(np.ceil(np.log(1e-40) / np.log(lam_max))))
    t = np.arange(max(1, t_cut))
    L = lam[:, None] ** t[None, :]  # (D, t_cut), |lam|<1 so underflow->0
    consts = {
        "A_seg": np.linalg.matrix_power(A, seglen),  # f64 (D, D)
        "Tr": np.ascontiguousarray(T.real),
        "Ti": np.ascontiguousarray(T.imag),
        "Lr": np.ascontiguousarray(L.real, np.float32),
        "Li": np.ascontiguousarray(L.imag, np.float32),
    }
    _SEG_CACHE[key] = consts
    if len(_SEG_CACHE) > 32:  # L tables are ~MBs per distinct seglen
        _SEG_CACHE.pop(next(iter(_SEG_CACHE)))
    return consts


def _check(x, sos, zi) -> None:
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
    if (not torch.is_tensor(zi) or zi.dtype != torch.float32
            or tuple(zi.shape) != (ns, 2, R) or not zi.is_contiguous()
            or zi.device != x.device):
        raise ValueError(f"zi must be a contiguous float32 ({ns}, 2, {R}) "
                         f"tensor on {x.device}")


def sosfilt_plain(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor):
    """Plain twin of the kernel: a torch loop over time on (R,) vectors,
    one elementwise op per operation of the cascade, float32."""
    coef = [[float(c) for c in row] for row in sos.tolist()]
    z = [[zi[s, 0].clone(), zi[s, 1].clone()] for s in range(len(coef))]
    xt = x.T.contiguous()  # (n, R): one contiguous row per step
    yt = torch.empty_like(xt)
    for t in range(xt.shape[0]):
        v = xt[t]
        for s, (b0, b1, b2, _, a1, a2) in enumerate(coef):
            z1, z2 = z[s]
            y = b0 * v + z1
            z[s] = [b1 * v - a1 * y + z2, b2 * v - a2 * y]
            v = y
        yt[t] = v
    zf = torch.stack([torch.stack(zs) for zs in z])
    return yt.T.contiguous(), zf


def rows_per_block(ns: int) -> int:
    """Rows of one block of the kernel at ns sections."""
    return 32 // ns


def sosfilt_pass(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor):
    """One pass of the cascade over independent rows: x (R, n), sos
    (ns, 6), zi (ns, 2, R), contiguous float32 on one device ->
    (y (R, n), zf (ns, 2, R)). The kernel on CUDA, the twin on the CPU."""
    global launches
    _check(x, sos, zi)
    if x.device.type == "cpu":
        return sosfilt_plain(x, sos, zi)
    if x.device.type != "cuda":
        raise ValueError(f"no IIR kernel for device {x.device}")
    R, n = x.shape
    lib = _build.load()
    y = torch.empty_like(x)
    zf = torch.empty_like(zi)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xm_sosfilt_f32(x.data_ptr(), sos.data_ptr(), zi.data_ptr(),
                                y.data_ptr(), zf.data_ptr(), R, n,
                                sos.shape[0], stream)
    _build.check(rc, "iir")
    launches += 1
    return y, zf


def sosfilt_segments(R: int, n: int, device, ns: int) -> int:
    """The segment count of ``sosfilt(segments=None)``: on a card,
    ``_seg.card_segments`` with the kernel's occupancy query and rows
    per block at ``ns`` sections and segments of at least
    :data:`MIN_SEGLEN` samples; elsewhere the JAX package's
    ``pick_segments``."""
    return card_segments(R, n, device, "xm_sosfilt_blocks_per_sm", (ns,),
                         rows_per_block(ns), MIN_SEGLEN, pick_segments(R, n))


def state_chain_plain(zf0, zi3, a_t, S):
    """Plain version of the state-chain kernel: the exact cascade state
    entering each segment, in float64. zf0 (ns, 2, R*S) the segments'
    zero-state final states (row r*S + k is segment k of row r), zi3
    (ns, 2, R) the state entering each row, a_t the transposed A^seglen
    -> (zin (R*S, D), z (R, D) after each row's last segment), D = 2*ns
    in probe order. A sequential loop over the segments, so a NaN final
    reaches only later segments."""
    ns = zf0.shape[0]
    D = 2 * ns
    R = zi3.shape[2]
    # zero-init segment final states -> (S, R, D) in probe order
    v = zf0.reshape(ns, 2, R, S).permute(3, 2, 0, 1).reshape(S, R, D).double()
    z = zi3.permute(2, 0, 1).reshape(R, D).double()
    z_ins = []
    for k in range(S):  # exact cross-segment state chain
        z_ins.append(z)
        z = z @ a_t + v[k]
    return torch.stack(z_ins, 1).reshape(R * S, D), z


def _state_chain(zf0, zi3, a_t, S):
    """:func:`state_chain_plain`'s function: on a CUDA tensor one launch
    of ``csrc/seg_chain.cu`` (whichever pass produced zf0), elsewhere
    the torch loop."""
    global chain_launches
    if zf0.device.type != "cuda":
        return state_chain_plain(zf0, zi3, a_t, S)
    ns = zf0.shape[0]
    D = 2 * ns
    R = zi3.shape[2]
    for name, t, shape, dtype in (
            ("zf0", zf0, (ns, 2, R * S), torch.float32),
            ("zi3", zi3, (ns, 2, R), torch.float32),
            ("a_t", a_t, (D, D), torch.float64)):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != zf0.device
                or (name != "a_t" and not t.is_contiguous())):
            raise ValueError(f"{name} must be a {dtype} {shape} tensor on "
                             f"{zf0.device}" + (", contiguous"
                                                if name != "a_t" else ""))
    if not 1 <= ns <= MAX_SECTIONS:
        raise ValueError(f"{ns} sections: the chain takes 1 to "
                         f"{MAX_SECTIONS}")
    zin = zf0.new_empty((R * S, D), dtype=torch.float64)
    z = zf0.new_empty((R, D), dtype=torch.float64)
    with torch.cuda.device(zf0.device):
        stream = torch.cuda.current_stream(zf0.device).cuda_stream
        rc = _build.load().xm_state_chain_f64(
            zf0.data_ptr(), zi3.data_ptr(), a_t.data_ptr(), a_t.stride(0),
            a_t.stride(1), zin.data_ptr(), z.data_ptr(), R, S, ns, stream)
    _build.check(rc, "state chain")
    chain_launches += 1
    return zin, z


def _sosfilt_seg(x2d, sos32, zi3, S, tabs, run):
    """Segmented exact cascade: x2d (R, n) -> (y (R, n), zf (ns, 2, R))."""
    ns = sos32.shape[0]
    R, n = x2d.shape
    seglen = n // S
    # row r*S + k is segment k of row r
    y0, zf0 = run(x2d.reshape(R * S, seglen), sos32,
                  x2d.new_zeros((ns, 2, R * S)))
    zin, z = _state_chain(zf0, zi3, tabs["A_seg"].T, S)
    # wr @ Lr - wi @ Li as one product: [wr, wi] @ [Lr; -Li]; past t_cut
    # the correction is < 1e-40 absolute: zero in float32
    w = (zin @ tabs["T"].T).float()
    y0[:, :tabs["L"].shape[-1]].addmm_(w, tabs["L"])
    zf = z.reshape(R, ns, 2).permute(1, 2, 0).to(
        torch.float32, memory_format=torch.contiguous_format)
    return y0.reshape(R, n), zf


def sosfilt(sos, x: torch.Tensor, zi=None, segments=None, run=None):
    """Biquad cascade of ``x`` (..., n) float32 -> (y (..., n), zf (ns,
    ..., 2)), the layouts of the JAX package's ``sosfilt_pallas``.

    ``sos``: host (ns, 6) array. ``zi``: (ns, ..., 2) or None (zeros).
    ``segments``: time-segmentation factor (exact; 1 = one pass), None =
    :func:`sosfilt_segments` (the card's rule on CUDA, the JAX
    package's ``pick_segments`` elsewhere). A cascade that
    ``_seg_consts`` rejects runs unsegmented. An empty cascade is the
    identity. ``run``: the one-pass function, :func:`sosfilt_pass` by
    default; passing :func:`sosfilt_plain` runs the same segmented path
    on the twin (the on-card comparison does; the state chain is the
    same in both)."""
    sos_host = np.asarray(sos, np.float64)
    if sos_host.ndim != 2 or sos_host.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos_host.shape}")
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError("x must be a float32 tensor (..., n)")
    ns = sos_host.shape[0]
    batch, n = x.shape[:-1], x.shape[-1]
    if ns == 0:
        return x.clone(), x.new_zeros((0,) + batch + (2,))
    if ns > MAX_SECTIONS:
        raise ValueError(f"{ns} sections: the kernel takes 1 to "
                         f"{MAX_SECTIONS}")
    R = int(np.prod(batch)) if batch else 1
    dev = x.device
    x2d = x.reshape(R, n).contiguous()
    if zi is None:
        zi3 = x.new_zeros((ns, 2, R))
    else:
        zi3 = torch.as_tensor(zi, dtype=torch.float32, device=dev).reshape(
            ns, R, 2).permute(0, 2, 1).contiguous()
    S = (sosfilt_segments(R, n, dev, ns) if segments is None
         else int(segments))
    if S < 1 or n % S:
        raise ValueError(f"segments={S} does not divide n={n} (exact state "
                         "corrections need equal segments)")
    run = sosfilt_pass if run is None else run
    consts = _seg_consts(sos_host, n // S) if S > 1 else None
    key = sos_host.tobytes()
    sos32 = on_device(key, dev, lambda: {
        "sos": sos_host.astype(np.float32)})["sos"]
    if consts is None:
        y2d, zf3 = run(x2d, sos32, zi3)
    else:
        require_fp32_matmul(dev)
        tabs = on_device((key, n // S), dev, lambda: {
            "A_seg": consts["A_seg"],
            "T": np.concatenate([consts["Tr"], consts["Ti"]]),
            "L": np.concatenate([consts["Lr"], -consts["Li"]])})
        y2d, zf3 = _sosfilt_seg(x2d, sos32, zi3, S, tabs, run)
    return (y2d.reshape(*batch, n),
            zf3.permute(0, 2, 1).reshape((ns,) + batch + (2,)))
