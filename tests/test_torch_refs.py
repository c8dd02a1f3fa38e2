"""The port tests' float64 references (``tests/torch_refs.py``): ``db``
equals ``tests/conftest.py``'s ``rms_db`` on arrays, int16 samples and
tensors; ``direct_conv`` equals ``np.convolve`` and leaves the BLAS
thread limit as it found it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from . import torch_refs as refs
from .conftest import rms_db

_RNG = np.random.default_rng(24)
_REF = 0.3 * _RNG.standard_normal((2, 500))
_GOT = _REF + 1e-4 * _RNG.standard_normal((2, 500))
_PCM = (_REF * 16384).astype(np.int16)
_H = _RNG.standard_normal(300)

DB_CASES = {  # got, ref
    "float32": (_GOT.astype(np.float32), _REF.astype(np.float32)),
    "float64": (_GOT, _REF),
    "int16": (_PCM + np.int16(3), _PCM),
    "tensor": (torch.from_numpy(_GOT).float(), torch.from_numpy(_REF)),
    "equal": (torch.from_numpy(_REF), _REF),
}


def _blas_threads():
    import threadpoolctl

    return [p["num_threads"] for p in threadpoolctl.threadpool_info()
            if p["user_api"] == "blas"]


@pytest.mark.parametrize("case", [*DB_CASES, "direct_conv",
                                  "direct_conv_1d"])
def test_refs_match_numpy(case):
    if case in DB_CASES:
        got, ref = DB_CASES[case]
        g, r = (np.asarray(a, np.float64) for a in (got, ref))
        assert refs.db(got, ref) == rms_db(g - r, r)
        return
    x = _REF if case == "direct_conv" else _REF[0]
    before = _blas_threads()
    y = refs.direct_conv(x, _H, 600)
    assert _blas_threads() == before
    want = np.stack([np.convolve(r, _H)[:600] for r in np.atleast_2d(x)])
    assert y.shape == x.shape[:-1] + (600,)
    err = np.abs(y.reshape(want.shape) - want).max()
    assert err <= 1e-12 * np.abs(want).max()
    assert refs.direct_conv(x, _H).shape[-1] == x.shape[-1] + _H.size - 1
