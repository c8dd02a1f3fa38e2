"""The comparison that decides ``correct``: every row (clip, or clip and
channel) of a compared batch against the float64 reference, as its RMS
error relative to the reference row's power, in dB. The number held to
the configuration's limit is the worst row's."""

from __future__ import annotations

import numpy as np

FLOOR_DB = -999.0  # reported for a row that matches bit for bit


def row_db(got: np.ndarray, ref: np.ndarray, time_axis: int = 1) -> np.ndarray:
    """Per-row error in dB; +inf where the shapes differ, a value is not
    finite, or a silent reference row meets a non-silent one."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        return np.array([np.inf])
    g = np.moveaxis(got.astype(np.float64), time_axis, -1)
    r = np.moveaxis(ref.astype(np.float64), time_axis, -1)
    g = g.reshape(-1, g.shape[-1])
    r = r.reshape(-1, r.shape[-1])
    err = np.sum((g - r) ** 2, axis=-1)
    pw = np.sum(r ** 2, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        db = 10.0 * np.log10(err / pw)
    db = np.where(err == 0.0, FLOOR_DB, db)
    db = np.where(np.isfinite(db) | (db == FLOOR_DB), db, np.inf)
    return np.where(np.all(np.isfinite(g), axis=-1), db, np.inf)


def worst_row_db(got, ref, time_axis: int = 1) -> float:
    return float(np.max(row_db(got, ref, time_axis)))
