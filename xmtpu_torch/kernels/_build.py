"""Lazy build of the port's CUDA kernels (the role ``xmtpu.native``'s
lazy g++ build plays for the JAX package's C++).

At first use, ``nvcc`` compiles every ``xmtpu_torch/csrc/*.cu`` into one
shared library with a plain C interface for Hopper (``sm_90a``), which
:func:`load` binds with ``ctypes``. The library lands in
``xmtpu_torch/_build/<key>/`` where ``key`` hashes the sources and the
flags, so a second run reuses it and an edited source rebuilds. No
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into build.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C interface of csrc/*.cu: name -> (argtypes, restype)
_SIGNATURES = {
    "xm_fir_convolve_f32": ([_P] * 6 + [_I] * 4 + [_P], _I),
    "xm_limiter_f32": ([_P, _P, _P, _P, _I, _I] + [_F] * 11 + [_P], _I),
    "xm_cuda_error_string": ([_I], ctypes.c_char_p),
}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_key() -> str:
    """Hash of the flags and every source file (name and bytes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    exists; return its path. The compiler output goes to ``build.log``
    beside the library. Concurrent builds each write a private file
    and rename it into place."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
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
