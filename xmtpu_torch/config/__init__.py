"""JSON config layer (counterpart of ``xmtpu.config``): stdlib ``json``
and frozen dataclasses for tracks (url, start, end, volume, fades) and
effects (name + params)."""

from xmtpu_torch.config.schema import (
    EffectConfig,
    PipelineConfig,
    TrackConfig,
    config_from_dict,
    config_to_dict,
    dump_config,
    load_config,
    load_json_source,
)

__all__ = [
    "PipelineConfig", "TrackConfig", "EffectConfig", "config_from_dict",
    "config_to_dict", "load_json_source", "load_config", "dump_config",
]
