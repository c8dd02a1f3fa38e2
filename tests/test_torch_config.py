"""Parity of the port's config schema (``xmtpu_torch.config``) with the
JAX package's (``xmtpu.config.schema``). A config is this system's
"weights": one JSON document loads through both packages into equal
dataclasses and dumps to equal dicts and equal JSON. Tolerance: none.
A malformed config raises the port's ``ConfigError`` wherever the JAX
package raises its own.
"""

from __future__ import annotations

import copy
import json
from dataclasses import asdict

import numpy as np
import pytest

import xmtpu_torch
from xmtpu.config import schema as xs
from xmtpu.utils.errors import ConfigError as XConfigError
from xmtpu_torch.config import schema as ts
from xmtpu_torch.utils.errors import ConfigError

DOC = {
    "sampleRate": 48000,
    "channels": 2,
    "normalize": "lufs",
    "normalizeTargetDb": -16.0,
    "blockSize": 32768,
    "bitrate": 128000,
    "tracks": [
        {"url": "voice.wav", "kind": "voice", "volume": 1.0,
         "startTimeMs": 120.0, "endTimeMs": 59000.0, "fadeInTimeMs": 250,
         "fadeOutTimeMs": 500},
        {"url": "bgm.wav", "kind": "bgm", "volume": 0.5, "loop": True,
         "sideDuck": 1, "fadeInTimeMs": 2000},
    ],
    "effects": [
        {"name": "noise_suppression"},
        {"name": "equalizer", "params": {"bands": [
            {"freq_hz": 100.0, "gain_db": 4.0, "q": 1.0}]}},
        {"name": "reverb", "ir_wav": "ir.wav", "wet": 0.2, "dry": 0.8},
    ],
    "masterEffects": [{"name": "limiter", "threshold_db": -1.0}],
}


def _same(cfg_t, cfg_j):
    """Equal dataclasses across the two packages: equal fields, and
    equal dicts and JSON through each package's dumper."""
    assert asdict(cfg_t) == asdict(cfg_j)
    assert ts.config_to_dict(cfg_t) == xs.config_to_dict(cfg_j)
    assert ts.dump_config(cfg_t) == xs.dump_config(cfg_j)


@pytest.mark.parametrize("form", ["dict", "JSON string", "file", "bytes"])
def test_one_document_loads_equal_in_both(tmp_path, form):
    if form == "dict":
        cfg_t, cfg_j = ts.config_from_dict(DOC), xs.config_from_dict(DOC)
    else:
        s = json.dumps(DOC)
        if form == "file":
            (tmp_path / "c.json").write_text(s)
            s = str(tmp_path / "c.json")
        elif form == "bytes":
            s = s.encode()
        cfg_t, cfg_j = ts.load_config(s), xs.load_config(s)
    _same(cfg_t, cfg_j)
    assert cfg_t.tracks[1].side_duck is True and cfg_t.bitrate == 128000


def test_round_trip_and_dump_file(tmp_path):
    cfg = ts.config_from_dict(DOC)
    assert ts.config_from_dict(ts.config_to_dict(cfg)) == cfg
    p = tmp_path / "out.json"
    text = ts.dump_config(cfg, p)
    assert p.read_text() == text and ts.load_config(p) == cfg
    assert xs.load_config(str(p)) == xs.config_from_dict(DOC)


def test_defaults_and_flat_effects():
    d = {"tracks": [{"url": "a.wav"}],
         "effects": [{"name": "limiter", "threshold_db": -3.0}]}
    cfg_t, cfg_j = ts.config_from_dict(d), xs.config_from_dict(d)
    _same(cfg_t, cfg_j)
    assert cfg_t.sample_rate == 16000 and cfg_t.normalize == "peak"
    assert cfg_t.effects[0].params == {"threshold_db": -3.0}
    _same(ts.PipelineConfig(), xs.PipelineConfig())


BAD = [
    "[]", '"str"', "42", "null", "not json at all", '{"tracks": ',
    '{"tracks": "notalist"}',
    '{"tracks": ["not-an-object"]}',
    '{"tracks": [{"url": 5}]}',
    '{"tracks": [{"url": "a.wav", "volume": "loud"}]}',
    '{"tracks": [{"url": "a.wav", "volume": -2}]}',
    '{"tracks": [{"url": "a.wav", "volumee": 0.5}]}',
    '{"tracks": [{"url": "a.wav", "kind": "Voice"}]}',
    '{"tracks": [{"url": "a.wav", "loop": "false"}]}',
    '{"tracks": [{"url": "a.wav", "fadeInTimeMs": "x"}]}',
    '{"tracks": [{"url": "a.wav"}], "sampleRate": 0}',
    '{"tracks": [{"url": "a.wav"}], "channels": 0}',
    '{"tracks": [{"url": "a.wav"}], "normalize": "sparkle"}',
    '{"masterEffect": []}',
    '{"effects": [{"params": {}}]}',
    '{"effects": [{"name": "volume", "params": {"gain_db": -3.0}, '
    '"backend": "scan"}]}',
    '{"normalizeTargetDb": "Infinity"}',
]


@pytest.mark.parametrize("text", BAD)
def test_malformed_config_raises_in_both(text):
    with pytest.raises(ConfigError):
        ts.load_config(text)
    with pytest.raises(XConfigError):
        xs.load_config(text)


def test_unreadable_path_and_late_effect_names(tmp_path):
    with pytest.raises(ConfigError, match="neither a JSON object"):
        ts.load_config(str(tmp_path / "missing.json"))
    (tmp_path / "bad.json").write_text("{ definitely not json")
    with pytest.raises(ConfigError, match="invalid config JSON"):
        ts.load_config(str(tmp_path / "bad.json"))
    # effect names stay late-validated (graph.fx.build_chain)
    cfg = ts.load_config('{"normalize": "loudness", '
                         '"effects": [{"name": "custom_fx"}]}')
    assert cfg.normalize == "loudness"
    with pytest.raises(ValueError, match="finite"):
        ts.TrackConfig(url="a.wav", volume=float("nan"))


def test_fuzz_both_packages_agree():
    """Randomly mutated documents: the port accepts exactly what the
    JAX package accepts, into equal configs, and raises ConfigError
    where it raises its own."""
    junk = [None, "x", -1, 0, 3.5, float("nan"), float("inf"), [], {},
            "false", True, [1, 2], {"a": 1}, -1e300, 2**63]
    rng = np.random.default_rng(71)
    for _ in range(200):
        d = copy.deepcopy(DOC)
        for _ in range(int(rng.integers(1, 3))):
            j = junk[int(rng.integers(0, len(junk)))]
            tr = d["tracks"]
            if (rng.integers(0, 2) or not isinstance(tr, list) or not tr
                    or not isinstance(tr[0], dict)):
                d[list(d)[int(rng.integers(0, len(d)))]] = j
            else:
                tr[0][list(tr[0])[int(rng.integers(0, len(tr[0])))]] = j
        try:
            cfg_j = xs.config_from_dict(d)
        except XConfigError:
            with pytest.raises(ConfigError):
                ts.config_from_dict(d)
            continue
        assert asdict(ts.config_from_dict(d)) == asdict(cfg_j)


def test_api_reexports():
    from xmtpu_torch import api

    assert api.PipelineConfig is ts.PipelineConfig is \
        xmtpu_torch.PipelineConfig
    assert api.TrackConfig is ts.TrackConfig
    assert api.EffectConfig is xmtpu_torch.config.EffectConfig
