"""The port's public surface against the JAX package's, by ``ast`` alone
(nothing of either package is imported for the walk): every public
module-level function of ``xmtpu/`` has a counterpart of the same name
in the same module of ``xmtpu_torch/`` (``benchmarks.py`` ->
``bench.py``; a name the port module imports from another of its
modules counts where it is defined), and every JAX parameter name exists
on it.

The only functions with no counterpart are the JAX compile-cache
plumbing (:data:`NO_COUNTERPART`). The Pallas entry points (``*_pallas``)
are paired with the card wrappers that replace them
(:data:`KERNEL_WRAPPERS`), which take the knobs that change what the
kernel computes; what they leave to the TPU's grid (tile heights, lane
counts, time chunks, the DFT-matmul form) is named there with its
reason.

The JAX constants of the segmented kernels and the lane-aligned
``pick_segments`` probe: equal, bit for bit, over a grid of (R, n).
"""

from __future__ import annotations

import ast
import itertools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "xmtpu", ROOT / "xmtpu_torch"
MODULE_RENAMES = {"benchmarks.py": "bench.py"}

# JAX functions with no counterpart, and why
NO_COUNTERPART = {
    ("_cachedir.py", "host_cache_dir"):
        "the host-fingerprinted JAX_COMPILATION_CACHE_DIR; the port "
        "compiles nothing at run time but its CUDA build, keyed by source "
        "hash under xmtpu_torch/_build (kernels._build)",
}
# private compile-cache plumbing the walk skips as non-public, named so a
# rename in the JAX package shows here: the jit cache of parallel/sp.py
# (eager torch has no traces to cache)
PRIVATE_PLUMBING = {("parallel/sp.py", "_JIT_CACHE"),
                    ("parallel/sp.py", "_cached_jit"),
                    ("parallel/sp.py", "_array_sig")}

# Pallas entry point -> (port module, card wrapper, knobs it must take,
# {JAX parameter it does not take: why})
_TILING = "a TPU grid/tile parameter; the card's launch geometry is its own"
_INTERP = ("interpret= is on the ops and steps that call this wrapper "
           "(utils.device.check_interpret); the wrapper runs its twin by "
           "the tensor's device")
KERNEL_WRAPPERS = {
    ("kernels/resample.py", "resample_pallas"): (
        "kernels/resample.py", "resample",
        {"x", "sr_in", "sr_out", "taps_per_phase", "beta", "interpret",
         "precision"},
        {"tj": _TILING}),
    ("kernels/fftconv.py", "fir_convolve_os_pallas"): (
        "kernels/fftconv.py", "fir_convolve",
        {"x", "ir", "block", "gp", "interpret", "pre_row", "pre_col",
         "trim"},
        {"wide": "the TPU kernel's N1-DFT matmul width; the card's "
                 "transform is an FFT in registers",
         "gauss": "the TPU kernel's complex-matmul form (3 products); "
                  "the card's transform is an FFT, no matmuls"}),
    ("kernels/rsmix.py", "resample_mix_pallas"): (
        "kernels/rsmix.py", "resample_mix",
        {"voice_i16", "bgm_i16", "sr_in", "sr_out", "bgm_gain", "fade",
         "taps_per_phase", "beta"},
        {"interpret": _INTERP}),
    ("kernels/iir.py", "sosfilt_pallas"): (
        "kernels/iir.py", "sosfilt", {"sos", "x", "zi", "segments"},
        {"time_chunk": _TILING, "lanes": _TILING, "interpret": _INTERP}),
    ("kernels/eq_env.py", "eq_env_pallas"): (
        "kernels/eq_env.py", "eq_env",
        {"sos", "x", "k_rel", "c_att", "zi", "env_init"},
        {"time_chunk": _TILING, "interpret": _INTERP}),
    ("kernels/envelope.py", "envelope_pallas"): (
        "kernels/envelope.py", "envelope",
        {"d", "k_rel", "c_att", "init", "segments", "n_valid"},
        {"time_chunk": _TILING, "interpret": _INTERP,
         "block": "the TPU kernel's lookahead block; the card steps per "
                  "sample, the same function in exact arithmetic"}),
    ("kernels/envelope.py", "limiter_pallas"): (
        "kernels/envelope.py", "limiter",
        {"x", "k_rel", "c_att", "init"},
        {"threshold_db": "the curve as one tuple, curve_of(threshold_db, "
                         "knee_db, ceiling_db, ratio, makeup_db)",
         "knee_db": "in curve", "ceiling_db": "in curve", "ratio": "in curve",
         "makeup_db": "in curve", "time_chunk": _TILING,
         "interpret": _INTERP,
         "n_valid": "the card's chain writes exactly n samples (K1 "
                    "trim=True), so the limiter reads no padding",
         "block": "the lookahead block; the card steps per sample"}),
    ("kernels/envelope.py", "linked_limiter_pallas"): (
        "kernels/envelope.py", "linked_limiter",
        {"x", "k_rel", "c_att", "init", "segments", "n_valid"},
        {"time_chunk": _TILING, "interpret": _INTERP,
         "block": "the lookahead block; the card steps per sample"}),
}


def _module(path: Path):
    """(functions: name -> parameter names, imports: name -> (module,
    name), assignments: names) of a module's top level."""
    tree = ast.parse(path.read_text())
    defs, imports, names = {}, {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            defs[node.name] = [x.arg for x in
                               a.posonlyargs + a.args + a.kwonlyargs]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for al in node.names:
                imports[al.asname or al.name] = (node.module, al.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return defs, imports, names


def _port_params(rel: str, name: str, depth: int = 0):
    """The parameters of the port's ``name`` as module ``rel`` sees it
    (following the port's own re-exports), or None."""
    path = PORT_PKG / rel
    if not path.exists() or depth > 3:
        return None
    defs, imports, _ = _module(path)
    if name in defs:
        return defs[name]
    mod, nm = imports.get(name, ("", ""))
    if mod.startswith("xmtpu_torch."):
        return _port_params(mod[len("xmtpu_torch."):].replace(".", "/")
                            + ".py", nm, depth + 1)
    return None


def _jax_functions():
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        defs, _, _ = _module(path)
        out += [(rel, n, p) for n, p in defs.items() if not n.startswith("_")]
    return out


JAX_FUNCTIONS = _jax_functions()


@pytest.mark.parametrize("rel,name,params", JAX_FUNCTIONS,
                         ids=[f"{r}:{n}" for r, n, _ in JAX_FUNCTIONS])
def test_every_jax_parameter_exists_on_the_port(rel, name, params):
    if (rel, name) in NO_COUNTERPART:
        assert _port_params(MODULE_RENAMES.get(rel, rel), name) is None
        return
    if (rel, name) in KERNEL_WRAPPERS:
        prel, pname, knobs, absent = KERNEL_WRAPPERS[(rel, name)]
        got = _port_params(prel, pname)
        assert got is not None, f"no card wrapper {prel}:{pname}"
        assert knobs <= set(got), sorted(knobs - set(got))
        # every JAX parameter is taken or named with its reason
        assert set(params) <= set(got) | set(absent), sorted(
            set(params) - set(got) - set(absent))
        assert not set(absent) & set(got), "named absent but taken"
        return
    got = _port_params(MODULE_RENAMES.get(rel, rel), name)
    assert got is not None, f"no counterpart of {rel}:{name} in the port"
    missing = [p for p in params if p not in got]
    assert not missing, f"{rel}:{name} lacks {missing} in the port"


def test_the_exception_lists_name_real_jax_code():
    """Every exception names something the JAX package has, so the lists
    cannot outlive what they excuse."""
    public = {(r, n) for r, n, _ in JAX_FUNCTIONS}
    assert set(NO_COUNTERPART) <= public
    assert set(KERNEL_WRAPPERS) <= public
    for rel, name in PRIVATE_PLUMBING:
        defs, _, names = _module(JAX_PKG / rel)
        assert name in defs or name in names, (rel, name)
        assert name.startswith("_")
    # no other public function of the JAX package lacks a same-named
    # counterpart
    lacking = {(r, n) for r, n, _ in JAX_FUNCTIONS
               if _port_params(MODULE_RENAMES.get(r, r), n) is None}
    assert lacking == set(NO_COUNTERPART) | set(KERNEL_WRAPPERS)


# --------------------------------------------- segment rules, constants


def test_segment_constants_are_the_jax_values():
    from xmtpu.kernels import envelope as xenv
    from xmtpu.kernels import eq_env as xeq
    from xmtpu.kernels import iir as xiir
    from xmtpu_torch.kernels import envelope, eq_env, iir

    assert iir.LANES == xiir.LANES == 128
    assert envelope.LANES == xenv.LANES
    assert eq_env.LANES == xeq.LANES
    assert envelope.DEFAULT_BLOCK == xenv.DEFAULT_BLOCK == 8


_RS = (1, 2, 3, 8, 16, 24, 64, 128, 200)
_NS = (4096, 30000, 44100, 160000, 465672, 480000, 1 << 20, 3 * 5 * 7 << 12)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("lanes", [128, 256])
def test_pick_segments_bit_for_bit(aligned, lanes):
    from xmtpu.kernels.iir import pick_segments as xpick
    from xmtpu_torch.kernels.iir import pick_segments

    for R, n, msl in itertools.product(_RS, _NS, (2048, 4096)):
        assert pick_segments(R, n, msl, lanes, aligned) == xpick(
            R, n, msl, lanes, aligned), (R, n, msl, lanes, aligned)
        assert pick_segments(R, n, min_seglen=msl, lanes=lanes,
                             aligned=aligned) == xpick(
            R, n, min_seglen=msl, lanes=lanes, aligned=aligned)


def test_pick_segments_aligned_changes_the_pick():
    """The probe picks another S where the power of two leaves segments
    off a multiple of 128 (a grid case that differs, so the test above
    compares the branch and not only the default)."""
    from xmtpu_torch.kernels.iir import pick_segments

    assert pick_segments(16, 480000, lanes=256) == 16
    assert pick_segments(16, 480000, lanes=256, aligned=True) == 15
