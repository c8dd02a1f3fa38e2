"""xmtpu_torch — the audio chains of ``xmtpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

A port beside the JAX package, which stays the reference: every ported
function is tested against its ``xmtpu`` counterpart on the same inputs.
This package imports ``torch``, ``numpy`` and ``scipy``, never ``jax``
or ``xmtpu``.

Entry points: ``xmtpu_torch.batch.make_flagship_step(device=...)`` (the
flagship batch chain), ``xmtpu_torch.resample(pcm, sr_in, sr_out, ...)``
(rate conversion, BASELINE config 1), ``xmtpu_torch.mix(tracks, sr,
...)`` (the multi-track mixer), ``xmtpu_torch.effects(pcm, sr, chain,
...)`` (the public effect chain, BASELINE config 3) and
``xmtpu_torch.process_file(inputs, config, out_path)`` (the one-shot
generator: decode, mix, effects, loudness, encode);
``xmtpu_torch.Session`` (streaming frame reads, BASELINE config 5),
``xmtpu_torch.SessionPool`` (K sessions in one batched step) and
``xmtpu_torch.PoolServer`` (sessions of many configs over pools);
``xmtpu_torch.run_batch`` (the file-batch runner: a manifest of clips
through the ragged step), ``xmtpu_torch.compat`` (the reference's
handle-style API) and ``python -m xmtpu_torch.cli`` (the command line).
``xmtpu_torch.entry.entry()`` returns the flagship step and its example
clips for a one-device check (``python -m xmtpu_torch.entry``).
``xmtpu_torch.io`` reads and writes WAV, and compressed formats through
the FFmpeg shim (``xmtpu_torch.native.ffmpeg``); ``xmtpu_torch.config``
loads pipeline configs; ``xmtpu_torch.native`` is the C++ host runtime;
``xmtpu_torch.parallel`` runs the chains over several devices from one
process (one long clip sharded along time; with
``batch.flagship_step_sharded`` and ``mesh=`` of the pool and server,
clips and streams sharded over devices).
"""

from xmtpu_torch import compat, config, io
from xmtpu_torch.api import (Session, SessionPool, effects, mix, process_file,
                             resample)
from xmtpu_torch.config.schema import EffectConfig, PipelineConfig, TrackConfig
from xmtpu_torch.graph.serve import PoolServer
from xmtpu_torch.ops.loudness import lufs_normalize, measure_lufs
from xmtpu_torch.ops.ns import suppress
from xmtpu_torch.runner import run_batch

__all__ = ["effects", "resample", "mix", "process_file", "measure_lufs",
           "lufs_normalize", "suppress", "Session", "SessionPool",
           "PoolServer", "PipelineConfig", "TrackConfig", "EffectConfig",
           "run_batch", "compat", "config", "io"]
__version__ = "0.1.0"
