"""Lazy build of the port's CUDA kernels (the role ``xmtpu.native``'s
lazy g++ build plays for the JAX package's C++).

At first use, ``nvcc`` compiles every ``xmtpu_torch/csrc/*.cu`` for
Hopper (``sm_90a``), one compiler process per source, all started
together, and links the objects into one shared library with a plain C
interface, which :func:`load` binds with ``ctypes``. The library lands
in ``xmtpu_torch/_build/<key>/`` where ``key`` hashes the sources and
the flags, so a second run reuses it and an edited source rebuilds. No
PyTorch header is compiled: a plain C build takes seconds, where a
``torch.utils.cpp_extension`` build takes minutes.

Nothing here runs at import: the CPU-only install imports every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from xmtpu_torch.utils.errors import KernelBuildError

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libxmtpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# registers / shared memory / spills of every kernel into build.log
_COMPILE_FLAGS = ("-Xptxas", "-v", "-c")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C interface of csrc/*.cu: name -> (argtypes, restype)
_SIGNATURES = {
    "xm_fir_convolve_f32": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "xm_fir_convolve_long_f32": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "xm_limiter_f32": ([_P, _P, _P, _P, _I, _I] + [_F] * 11 + [_P], _I),
    "xm_envelope_f32": ([_P] * 6 + [_I, _I, _F, _F, _I, _P], _I),
    "xm_limiter_blocks_per_sm": ([], _I),
    "xm_envelope_gain_f32": ([_P] * 6 + [_I, _I] + [_F] * 11 + [_P], _I),
    "xm_envelope_blocks_per_sm": ([_I], _I),
    "xm_sosfilt_f32": ([_P] * 5 + [_I] * 3 + [_P], _I),
    "xm_sosfilt_blocks_per_sm": ([_I], _I),
    "xm_state_chain_f64": ([_P] * 3 + [_L] * 2 + [_P] * 2 + [_I] * 3 + [_P],
                           _I),
    "xm_eq_env_f32": ([_P] * 8 + [_I] * 3 + [_F] * 2 + [_P], _I),
    "xm_eq_env_finals_f32": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "xm_eq_env_blocks_per_sm": ([_I], _I),
    "xm_resample_f32": ([_P] * 4 + [_I] * 12 + [_P, _P], _I),
    "xm_resample_nan_fixup": ([_P, _P] + [_I] * 6 + [_P], _I),
    "xm_resample_blocks_per_sm": ([_I], _I),
    "xm_rsmix_i16": ([_P] * 5 + [_I] * 12 + [_F, _I, _P], _I),
    "xm_rsmix_blocks_per_sm": ([_I], _I),
    "xm_ns_wiener_f32": ([_P] * 4 + [_I] * 5 + [_F] * 4 + [_P], _I),
    "xm_ns_wiener_blocks_per_sm": ([], _I),
    "xm_lufs_blocks_f32": ([_P, _P, _I, _L] + [_I] * 3 + [_P], _I),
    "xm_cuda_error_string": ([_I], ctypes.c_char_p),
}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_key() -> str:
    """Hash of the flags and every source file (name and bytes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + _COMPILE_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_key() / LIB_NAME


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from xmtpu_torch/csrc at first use")


def build() -> Path:
    """Compile the kernels unless the library for the current sources
    exists; return its path. Every ``.cu`` compiles in its own ``nvcc``
    process, all at once; the compiler output goes to ``build.log``
    beside the library. Concurrent builds each write private files and
    rename the library into place."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    jobs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, *_COMPILE_FLAGS, "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        so, se = proc.communicate()
        log.append(" ".join(cmd) + "\n" + so + se)
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[-1]).name} ({proc.returncode}):\n"
                          f"{se[-3000:]}")
    tmp = out.with_name(f"{LIB_NAME}.{pid}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-3000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out.parent / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelBuildError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then bind the C interface (argtypes declared for
    every function, so pointers pass as 64-bit values)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError()."""
    if rc != 0:
        msg = load().xm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
