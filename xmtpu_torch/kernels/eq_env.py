"""Fused biquad-cascade EQ + limiter envelope over mono rows
(counterpart of ``xmtpu.kernels.eq_env.eq_env_pallas``).

Per sample, in the JAX kernel's operation order (``v`` = the input,
then each section's output):

    per section:  y = b0*v + z1;  z1' = b1*v - a1*y + z2;  z2' = b2*v - a2*y
    env = max(|y|, k_rel * env);  e2 = (1 - c_att) * e2 + c_att * env

emitting the cascade output ``y`` and the smoothed envelope ``e2``: the
EQ and the limiter's detector in one sequential pass, the
``sosfilt`` -> ``envelope(|y|)`` composition unsegmented. The flagship
chain's fused branch runs it when the EQ does not fold into the reverb.

On a CUDA tensor :func:`eq_env_pass` launches the hand-written kernel
``csrc/eq_env.cu``; on a CPU tensor it runs :func:`eq_env_plain`, a
torch loop over time with one elementwise op per operation, float32
coefficients as the kernel receives them, which the kernel equals bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.kernels import _build
from xmtpu_torch.kernels._seg import on_device

# Launches of the CUDA kernel in this process; callers may reset it.
launches = 0

MAX_SECTIONS = 8  # the kernel's largest template instance


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
                 ei: torch.Tensor, k_rel: float, c_att: float):
    """Plain twin of the kernel: a torch loop over time on (R,) vectors,
    one elementwise op per operation, float32."""
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
    return yt.T.contiguous(), et.T.contiguous(), zf, torch.stack([env, e2])


def eq_env_pass(x: torch.Tensor, sos: torch.Tensor, zi: torch.Tensor,
                ei: torch.Tensor, k_rel: float, c_att: float):
    """One pass over independent rows: x (R, n), sos (ns, 6), zi (ns, 2,
    R), ei (2, R) = (env, e2), contiguous float32 on one device -> (y
    (R, n), e2 (R, n), zf (ns, 2, R), ef (2, R)). The kernel on CUDA,
    the twin on the CPU."""
    global launches
    _check(x, sos, zi, ei)
    if x.device.type == "cpu":
        return eq_env_plain(x, sos, zi, ei, k_rel, c_att)
    if x.device.type != "cuda":
        raise ValueError(f"no eq_env kernel for device {x.device}")
    R, n = x.shape
    lib = _build.load()
    y = torch.empty_like(x)
    e2 = torch.empty_like(x)
    zf = torch.empty_like(zi)
    ef = torch.empty_like(ei)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.xm_eq_env_f32(x.data_ptr(), sos.data_ptr(), zi.data_ptr(),
                               ei.data_ptr(), y.data_ptr(), e2.data_ptr(),
                               zf.data_ptr(), ef.data_ptr(), R, n,
                               sos.shape[0], k_rel, c_att, stream)
    _build.check(rc, "eq_env")
    launches += 1
    return y, e2, zf, ef


def eq_env(sos, x: torch.Tensor, k_rel: float, c_att: float, zi=None,
           env_init=None, run=None):
    """Fused EQ + envelope of mono rows ``x`` (..., n) float32 -> (y,
    e2, zf, (env_last, e2_last)) with the JAX ``eq_env_pallas``'s
    shapes: y and e2 like x, zf (ns, ..., 2), the last states (...,).

    ``sos``: host (ns, 6) array, 1 to 8 sections. ``zi``: (ns, ..., 2)
    or None (zeros); ``env_init``: (env, e2), each (...,), or None.
    ``run``: the one-pass function, :func:`eq_env_pass` by default."""
    sos_host = np.asarray(sos, np.float64)
    if sos_host.ndim != 2 or sos_host.shape[1] != 6:
        raise ValueError(f"sos must be (ns, 6), got {sos_host.shape}")
    if not torch.is_tensor(x) or x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError("x must be a float32 tensor (..., n)")
    ns = sos_host.shape[0]
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
    sos32 = on_device(sos_host.tobytes(), dev, lambda: {
        "sos": sos_host.astype(np.float32)})["sos"]
    run = eq_env_pass if run is None else run
    y, e2, zf3, ef = run(x2d, sos32, zi3, ei, k_rel, c_att)
    return (y.reshape(*batch, n), e2.reshape(*batch, n),
            zf3.permute(0, 2, 1).reshape((ns,) + batch + (2,)),
            (ef[0].reshape(batch), ef[1].reshape(batch)))
