#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``xmtpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one printed line each or more; any failure raises and the
process exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); both TF32
   flags set to False;
2. build: the CUDA kernels built from ``xmtpu_torch/csrc`` (one ``nvcc``
   per source, in parallel; seconds);
3. K1, the fftconv kernel, against its plain torch twin at the flagship
   shape (256 x 160000 bus samples, the 4093-tap combined EQ+reverb IR,
   the real normalize gains and fade ramp): gate RMS error <= -100 dB;
   both times (CUDA events, median of 7 runs after 2 warm-ups) and a
   ``conv1d`` of the gained input as the library yardstick; the
   transform's size, radix stages and shared-memory exchanges; every
   transform size the IR allows (8192 and 16384 points) timed and gated
   (also at phase 7's operands);
4. K2, the fused limiter, time-segmented by the card's rule (S), on the
   K1 output against the unsegmented plain twin: same gate; its pass A
   (the envelope core's |x| instance) against its twin on the same
   operands (max abs 0); the ``limiter()`` call's time, its pass A
   (also as a CUDA-graph replay: its time on the card, and its cycles
   per sample), carries (alone, and as a graph replay) and fused pass B
   each timed, the
   unsegmented kernel's time, the calls at S = 4, 8, 16, 32; the twin's
   time loop (median of 5); then a NaN sample in one segment of one row:
   ``limiter()`` at the rule's S and unsegmented must give NaN exactly
   where the twin does (and -100 dB elsewhere);
5. the fused flagship step on 256 clips of 10 s (the root bench.py's
   inputs), launch counters set to 0 just before: K1, K2 and its pass A
   must launch; clip 0 must read <= -80 dB against the float64 oracle;
   throughput;
6. K5, the IIR kernel, on the small-batch branch's real EQ input (32
   x 160000) cut into segment rows at the card's rule (S = 64 on an
   H100: 2,048 rows of 2,500) and at the JAX rule's S = 4: the kernel
   against the plain twin (y and zf max abs 0), its time from the host
   and as a CUDA-graph replay (its time on the card), and its cycles
   per sample on the card; at S = 4 .. 128 the pass, the ``sosfilt()``
   call from the host (three interleaved rounds) and as a graph replay;
   the float64 state-chain kernel against its torch loop (<= 1e-12
   relative), its call, its time as a CUDA-graph replay and the loop's;
   the ``sosfilt()`` call and its glue (alone, and as a graph replay);
   the segmented call against the same path on the twin (max abs 0),
   against the unsegmented kernel and, on a 1 s prefix at S = 8, the
   unsegmented twin (-100 dB); a NaN sample in one segment of one row:
   the NaN masks of the kernels' path and the twin path equal;
7. K1 at the small-batch branch's own operands (the EQ output, 32 x
   160000, the raw 4000-tap reverb IR, unit gains: what ``reverb()``
   passes it there) against its twin (gate -100 dB, both times,
   ``conv1d``); then the envelope core through the segmented
   ``envelope()`` at the small-batch shape (32 x 160000) at the card's
   S (printed; 64 on an H100: two launches over 2,048 rows of 2,500)
   against the same path on the twin (gate -100 dB), each launch
   against its twin on its own operands (max abs 0, the plain and the
   corrected instance; with phase 4's |x| one, all three); each launch
   from the host and as a graph replay (its cycles per sample), the
   ``envelope()`` call both ways, the same launches at the JAX rule's S
   (8), the S sweep (8 .. 128: the launches and the call as graph
   replays) and the instances' ptxas lines;
8. the unfused small-batch step on 32 clips of 10 s, counters set to 0
   just before: K1, K5, the state-chain kernel and the envelope-only
   kernel must launch; clip 0 <= -80 dB against the float64 oracle;
   throughput; a per-stage breakdown (CUDA events);
9. K6, the eq_env kernel, on the unfolded fused branch's real input
   (the K1 output with the raw 4000-tap IR and the normalize gain as
   ``prescale``, 256 x 160000): the one-pass kernel against its twin on
   a 256 x 16000 prefix (the twin's time loop is too slow at full
   length; y, e2 and both final states must read max abs 0), and the
   segmented path (S = 4) there against that twin (y and e2 <= -100
   dB); the state-chain kernel against its torch loop on the finals of
   K6's pass 0 at the rule's S (<= 1e-12 relative); the segmented
   ``eq_env()`` call at the card's rule (S = 32: pass 0 and pass A on
   K6, pass B on the envelope-only kernel) against
   the same path on the twins at full length (gate -100 dB, max abs
   printed); the call's time, pass 0, pass A, the carries (alone, and as
   a CUDA-graph replay), pass B (also as a graph replay, and its cycles
   per sample), the one-pass kernel, the calls at S =
   4, 8, 16, 32, and pass A with 1, 2 and 4 blocks per SM; then
   ``make_flagship_step(fused=True, lti_fold=False)`` with fresh
   counters: K1, K6, the state chain and the envelope-only kernel must
   launch; clip 0 <= -80 dB; throughput; a per-stage breakdown (CUDA
   events);
10. K7, the resample kernel, on the two-track front's real input (512 x
   441000 float32): gate -100 dB against its twin, both times (and the
   kernel's back to back, without the wrapper's host time), and the
   dense banded ``torch.matmul`` (the TPU kernel's form) as the library
   yardstick; the same rows resampled 48k -> 44.1k (M = 160, where the
   window pitch matters): gate, time, bound; each tiling's geometry (G,
   frames a tile, pitches, shared bytes, blocks per SM) and the
   kernel's ptxas line; then the ``resample_backend="pallas"`` step: K7,
   K1 and K2 must launch; clip 0 <= -80 dB; throughput;
11. K8, the fused int16 front, on the real int16 tracks (256 x 441000):
   gate -100 dB against its twin, both times (the kernel's also back to
   back); its geometry; a 48 kHz
   prefix the gate takes (256 x 440320) to 44.1k: gate, time, bound,
   geometry; the kernel's ptxas line; then the
   ``resample_backend="rsmix"`` step: K8, K1 and K2 must launch; clip 0
   <= -80 dB; throughput; the fused step's three fronts (mixfirst,
   pallas, rsmix) each timed alone on the same clips;
12. the ragged ``make_batch_step`` at 64 clips (the file runner's
   default) with lengths of 5-10 s padded to 10 s, on each of its three
   branches: the unfused one the auto rule picks at 64 rows (K5, the
   state chain, K1 and the envelope-only kernel must launch), then
   ``fused=True`` folded (K1 and the envelope-only kernel) and unfolded
   (``lti_fold=False``: K1, K6, the state chain and the envelope-only
   kernel); each: clip 0 <= -80 dB against the float64 oracle on its
   own length; every sample past each clip's length must be 0;
   throughput in audio-seconds of the true lengths;
13. K1's long-IR form (the frequency-domain delay line) at config 3's
   operands: the 24,082-tap folded EQ+reverb IR over 32 rows (16 stereo
   clips of 10 s at 48 kHz, the JAX benchmark's input) against its twin
   (gate -100 dB), both times, ``conv1d`` as the library yardstick, the
   bound and the partition count;
14. K4', the envelope core's gain form, through the channel-linked
   limiter at config 3's detector (16 x 480000 from the K1 output) at
   the card's S (printed; 64 on an H100: 1,024 segment rows of 7,500)
   against the same path on the twin (gate -100 dB on y and on both
   states); the two launches (K3 pass A, gain-form pass B) and the call
   from the host and as graph replays, the launches' cycles per sample,
   the bounds, the gain instances' ptxas lines;
15. config 3 through ``xmtpu_torch.effects`` twice, counters set to 0
   just before each: the JAX benchmark's chain (K1's long form and the
   envelope-only kernel must launch), then with ``linked_fuse`` on the
   limiter (K1's long form and the gain form); each: clip 0's first 2 s
   <= -80 dB against the float64 oracle (``sosfilt_np`` ->
   ``reverb_np`` -> ``limiter_np``; every stage is causal), throughput,
   and the chain's stages each alone (CUDA events);
16. K7's non-finite masks: 512 rows with NaN, +inf and -inf samples
   at frame interiors, frame edges and the band's reach into the
   neighbour frames, in both of the twin's branches (441000 samples,
   aligned, and 101 fewer, windowed) at 44.1k -> 16k and 48k -> 44.1k
   (441280 and 101 fewer): the kernel's ~isfinite mask must equal its
   twin's (and its isnan mask, for NaN alone), the finite outputs <=
   -100 dB; K7's time with and without non-finite samples;
17. config 1 (the JAX harness's 32 int16 clips of 10 s, 44.1k -> 16k):
   the port's config-1 function with fresh counters (K7 must launch),
   clip 0 <= -100 dB against the twin and <= -80 dB against
   ``resample_oracle_np``, throughput on K7 and on the banded FP32
   matmuls; ``xmtpu_torch.resample`` on an (n, 2) int16 clip (1 LSB)
   and an (n,) float32 clip (-100 dB) against the CPU twin;
18. config 2 (two float32 tracks of 32 x 10 s at 16 kHz, gain, fade,
   sum, peak normalize per row): row 0 <= -100 dB against
   ``mix_oracle_np``; throughput;
19. the strided-conv resample (``conv1d``, no kernel launch) on 32
   clips of 10 s: at 16k -> 48k (band wider than 2M) through the
   drop-in ``kernels.resample.resample``; at 8k -> 44.1k (band within
   2M) the drop-in (K7 must launch) and ``polyphase_resample(method=
   "conv")``; each clip 0 <= -80 dB against ``resample_oracle_np``;
   times;
20. the float64 scan engine: ``effects(backend="scan")`` on config 3's
   full input (no kernel may launch; clip 0's first 2 s <= -80 dB
   against the float64 oracle; throughput; peak memory), then
   ``make_flagship_step(iir_backend="scan")`` on 32 clips of 10 s with
   fresh counters: K1 must launch, and the IIR, state-chain, envelope
   and eq_env kernels must not; clip 0 <= -80 dB; throughput;
21. one podcast episode through ``xmtpu_torch.api.process_file``, its
   inputs written from ``default_rng(12)`` into a temporary directory: a
   600 s mono int16 voice at 44.1 kHz (amplitude-modulated noise
   phrases over a noise floor), a 60 s stereo BGM at 48 kHz (tones) and
   a 0.5 s IR at 44.1 kHz; a 48 kHz stereo bus (28.8 M samples a
   channel) with the voice (250 ms fade-in) over the BGM (looped,
   side-ducked, volume 0.5, 2 s fade-in); noise suppression, the 5-band
   EQ and the reverb from the IR file on the voice bus; LUFS
   normalization to -16; a -1 dB limiter on the master in blocks of
   65,536. Counters set to 0 just before: K7 (the voice's 44.1k ->
   48k), K5 (the K-weighting), K1, the envelope kernel and the block
   powers' kernel must launch.
   The file read back: its length, channels, finite samples, peak at
   most the limiter's ceiling. Then a
   timed run (audio-seconds per second, wall clock with WAV I/O; the
   stage times at the progress marks; peak memory), a run traced by
   ``torch.profiler`` (the card's busy share, the kernels that take the
   most time); ``api.mix`` alone
   (its rate), whose bus must read within 0.02 LU of ``measure_lufs_np``
   and 0.05 LU of -16 on the card; (``lufs_phase``) the block-power
   kernel (``csrc/lufs_blocks.cu``) alone on that bus's K-weighting,
   counters at 0 just before: one launch, its powers within 1e-11 of the
   largest against the float64 cumulative sum (float32 sums must miss
   that), a second run bit for bit, its time, the cumulative sum's and
   its bound; the voice chain and
   ``lufs_normalize`` each alone; ``suppress`` on the whole voice at 48
   kHz <= -80 dB against ``suppress_np``; the first 20 s on the card
   against the CPU, <= -80 dB; K7 (the whole voice, 1 x 26.46 M at
   44.1k -> 48k), K5 (the K-weighting of the bus, the call at the card's
   S against the same path on the twin), K1's long form (the suppressed
   voice, the folded IR) and the envelope kernel (the master limiter's
   first block: its launches timed as graph replays, the envelope()
   call from the host beside them) against their twins at the path's
   operands;
22. config 5 (``xmtpu/benchmarks.py:174-252``, nothing cut): a 4 s
   voice at 44.1 kHz (``0.3 * default_rng(0)`` noise) on a 16 kHz mono
   bus, 20 ms frames (320 samples), master EQ (300 Hz, +2 dB) then the
   limiter. Gates: 50 frames of the session on the card against the
   session on the CPU (-80 dB float32, 1 LSB int16), ``read_many(25)``
   twice against the reads (-120 dB), against ``api.mix`` and the
   master chain offline on the card (-80 dB); a ``SessionPool`` of 32
   8 s voices, every slot against its own session (-80 dB, int16), the
   kernel engine against the scan engine (-80 dB float32; -60 dB int16
   over 2 frames). A session's frame and both pools' groups dispatch
   under ``torch.cuda.set_sync_debug_mode("error")``. Then
   ``bench.config5_streaming`` (ms a frame at depth 1 and 3,
   ``read_many(25)`` and the pool's aggregate audio-seconds per second
   on both engines), each pool's device operations a frame and the
   card's busy share of a traced ``read(25)``; with the counters at 0,
   the kernel-engine pool's ``read(4)``: K5 and the envelope kernel must
   launch, and the last launch of each, on its recorded operands, must
   read max abs 0 against its twin (times as graph replays and from the
   host, bounds);
23. serving: a ``PoolServer`` (8 slots a pool) with two buckets, config
   5 (five 8 s voices) and the episode's voice chain (noise
   suppression, the 5-band EQ, the reverb from the IR file, the
   side-ducked looped BGM, the -1 dB master limiter) at 48 kHz stereo
   with ``normalize=None``, 8 sessions of 20 s voices; ``open``,
   ``read`` and ``pump`` with one session closed, one sought and one
   opened mid-run; every served stream (each part between seeks) must
   read -80 dB (int16) against a ``StreamSession`` of its source. Then
   the episode chain as ``SessionPool(effects_backend="pallas")``, the
   counters at 0: K1 (the folded EQ+reverb over its carried input
   history) and the envelope kernel must launch; K1's last launch is
   held against its twin (-100 dB, ``conv1d`` beside it) and the
   envelope's (max abs 0);
24. the native host runtime (``xmtpu_torch.native``): it must build
   and load (a hard gate: the pure-Python fallback may not stand in);
   a fresh ``g++`` build timed; the WAV reader and writer bit for bit
   against the stdlib path (441000 x 2), the int16 <-> float32
   conversions against their numpy twins (2^20 samples), a
   ``PcmChannel`` carrying frames of up to ~3 MB through a 1 MiB ring;
25. config 6 (``xmtpu/benchmarks.py:255-309``, nothing cut): 64 int16
   WAV clips of 10 s at 44.1 kHz (``default_rng(0)`` noise x 9000)
   through ``xmtpu_torch.runner.run_batch`` to 16 kHz WAVs: pipelined
   (cold; then warm with the counters at 0 and the launches' operands
   recorded: K1, K5 and its state chain, K3 must launch), serial, with
   4 decode threads and pipelined again: no failed clip, identical
   bytes; audio-seconds per second of each (wall clock with all I/O),
   ``peak_hbm_bytes``, the card's busy share in a traced warm pass, one
   chunk's host stages timed apart (decode, pack + upload + launch, the
   card finishing, fetch, writes), the step alone (CUDA events) as a
   share of the warm wall clock; clips
   0-2 against the same step on the CPU (the kernels' plain twins) and
   clip 0 against ``flagship_oracle_np``, -80 dB; K1, K5 and K3 on the
   runner's recorded operands against their twins; then
   ``bench.config6_file_batch(fmt="wav")``;
26. ``python -m xmtpu_torch.cli`` subprocesses (``batch`` on 4 of the
   clips, ``resample``, ``effects`` with config 3's chain on a 48 kHz
   stereo clip, ``generate`` with LUFS -16 and a master limiter) and the
   five ``examples/torch_*.py``, all started together, must exit 0 (the
   examples print their lines); the command line's outputs against the
   API's in this process, the compat mixer and voice-effects handles
   against a ``Session``, the async generator (``GS_COMPLETED``)
   against ``process_file``: -80 dB;
27. sequence parallelism at the clip lengths it exists for: one stereo
   clip of an hour at 48 kHz (2 x 172,800,000 float32, ``0.3 *
   default_rng(0)`` noise) through ``xmtpu_torch.parallel.
   sp_effects_chain`` on 4 virtual shards of the card (the kernel engine
   by the auto rule: 43.2 M samples a shard), config 3's chain (the
   5-band EQ, a 0.5 s IR at wet 0.3 / dry 0.7, the default limiter),
   with the counters at 0: the IIR kernel, its state chain and the
   envelope core must launch a multiple of 4 times; against the port's
   single-device chain on the card (-80 dB) and, its first 10 s,
   against the float64 oracle (scipy ``sosfilt`` and ``fftconvolve``,
   the linked float64 envelope, the soft knee; -80 dB); both calls'
   times and peak memory; the IIR kernel and the envelope core on the
   call's recorded operands (the pass timed at the shard's full shape,
   then on every row's first 2,048 samples against its twin, max abs
   0); then a 2 x 2 ``("dp", "sp")`` mesh of 4 mono clips of 10 min and
   the scan engine against the kernel engine at 2 x 262,144 samples a
   shard (-80 dB each);
28. data parallelism and serving on 4 virtual shards:
   ``batch.flagship_step_sharded`` on 256 clips of 10 s against the
   unsharded step (-120 dB, max abs printed; the fused branch from the
   global batch: K1 and K2 launch once a shard, K5 never) and clip 0
   against the float64 oracle (-80 dB), both steps' audio-s/s; config
   5's 32-slot pool over a ``dp`` mesh on both engines against the
   unsharded pool (-80 dB, max abs printed), both pools' audio-s/s, a
   slot after leave / join / seek against its ``StreamSession``; a
   ``PoolServer`` with ``mesh=`` bucketing two configs into two pools
   (every stream against its session); ``dryrun_multichip(4,
   device="cuda:0")``, all legs;
29. on a host with several cards (k = min(4, count)), the sp leg on a
   10 min stereo clip, the dp step and the pool over ``cuda:0..k-1``,
   each beside the same leg on k virtual shards, with the same gates,
   then ``dryrun_multichip(k)``; with one card it prints ``phase 29: 1
   card, not run``;
30. ``xmtpu_torch.entry.entry()`` on the card (two int16 clips of 1 s,
   the small-batch branch), counters set to 0 just before: K5, its
   state chain, K1 and the envelope core must launch; the output
   against ``entry(device="cpu")`` and each clip against
   ``flagship_oracle_np`` (-80 dB); the median of 9 calls. Then
   ``interpret=True`` must raise ``ConfigError`` on the card in
   ``make_flagship_step``, ``make_batch_step``,
   ``flagship_step_sharded`` and ``reverb``, and ``interpret=False`` and
   None must launch the kernels. Then the FFmpeg shim: ``pkg-config``
   probes libav; where it (or ``io.HAVE_FFMPEG``) finds it, the shim
   must build, a 10 s FLAC (bit for bit) and MP3 round trip must decode,
   and ``bench.config6_file_batch(fmt="flac")`` runs beside phase 25's
   WAV figure; where it does not, ``HAVE_FFMPEG`` must be False and a
   ``.flac`` must raise ``DecodeError``;
31. (``precision_phase``, also ``tools/torch_precision.py`` alone) the
   matmul precision rungs: the default step's ``mixfirst`` front at
   HIGHEST / HIGH / DEFAULT as a probe (front ms split into the mix
   passes and the matmuls; the step's clip 0 against
   ``flagship_oracle_np``, -80 dB at HIGHEST and HIGH; the rungs must
   round apart; the default step unchanged after), the resample ops'
   rungs and bf16 against the CPU (-120 dB; bf16 -80), K7 at each rung
   against its split twin on the card (-120 dB; 1, 3, 1 launches) and
   its non-finite masks, ``fir_convolve_os_mxu`` at each variant x
   gauss x rung against float64 and the CPU; K1 ``trim=False`` (short
   form at the step's operands, long form at 32 x 480000 x 24,000 taps)
   against its twin (-120 dB) with its first n samples max abs 0
   against ``trim=True``, and K1 at ``gp`` 1, 2, 4, 16 (checked and
   capped, not a parameter of the card's launch) max abs 0 against
   ``gp=None``, with times; the ``mixfirst_pad`` step against
   ``mixfirst`` (1 LSB, -120 dB);
32. (``ns_phase``) the noise suppressor's Wiener kernel
   (``csrc/ns_wiener.cu``) alone at the voice cell's spectra (32 x
   10,337 x 257) against its plain twin (the scan and the elementwise
   gain; -100 dB), with its launches, its time on fresh spectra, an S
   sweep, the twin's time, its bytes bound and ``roofline_ns``'s bound
   of the whole suppressor, and ``suppress()`` at that shape;
33. a JSON line of the kernels (times, bounds, launches; K1 once per
   branch; the state-chain kernel beside K5; the episode's K5, K1 and
   envelope entries with its launch counts; the streaming entries of
   phases 22-23; the runner's K1, K5 and K3 of phase 25; the IIR and
   envelope kernels at the hour clip's shard, phase 27; the Wiener
   kernel of phase 32, the block-power kernel of phase 21), then the
   contract line ``{"ok": true, "device": {...}}`` last.

Every step run with fresh counters sets all twelve launch counters to 0
just before it and reads them just after.

``bound_ms`` is the roofline bound: the larger of the bytes each kernel
must move (inputs read once, outputs written once) over the memory
bandwidth and its operations over the float32 peak (H100 SXM data
sheet, ``perfbench.roofline``'s yardstick; the state chain's over the
34 TFLOP/s float64 peak); K1's operations are the FIR's least FFT work
(``perfbench.roofline.fir_fft_ops``). So ``bound_ms`` follows
``perfbench.roofline``: an edit there to ``PEAKS`` or ``fir_fft_ops``
moves every bound this prints, and PERF.md's per-kernel bounds with it.
The recurrence kernels' text lines also print their chain bound: the
longest chain's steps times the loop-carried latency of a step (4
cycles per dependent float32 operation) at the card's maximum SM clock.

Without a CUDA device it fails before printing any result. It imports
neither ``jax`` nor ``xmtpu``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

from perfbench.roofline import PEAKS, fir_fft_ops

GATE_KERNEL_DB = -100.0
GATE_CHAIN_DB = -80.0
# phase 31, card against CPU: bf16 outputs (an ulp flip is -48 dB at a
# sample; -90.0 to -91.0 dB measured on an H100), and the matmul DFTs'
# bf16 rungs, whose stages re-split intermediates that the two devices
# sum in another order (HIGH -106.5 to -115.6, DEFAULT -71.1 to -85.7)
GATE_BF16_DB, GATE_MXU_HIGH_DB, GATE_MXU_DEFAULT_DB = -80.0, -100.0, -60.0
BATCH, SMALL_BATCH, RAGGED_BATCH, CLIP_SECONDS = 256, 32, 64, 10.0
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
F64_OPS_PER_S = 34e12  # H100 SXM, float64 outside the tensor cores
OP_LATENCY_CYCLES = 4  # one dependent float32 add / multiply / max
REPO = Path(__file__).resolve().parent
# the podcast episode (phase 21)
EPISODE_S, EPISODE_BGM_S, EPISODE_CPU_S = 600.0, 60.0, 20.0
# phase 21, the block-power kernel against the float64 cumulative sum:
# max abs over the largest power (float32 sums of a 400 ms block miss by
# about 1e-8 of it and more; the two float64 orders by about 1e-13)
GATE_LUFS_BLOCKS = 1e-11
VOICE_SR, BUS_SR = 44100, 48000
GATE_LU_ORACLE, GATE_LU_TARGET = 0.02, 0.05


def episode_inputs(root, seconds: float = EPISODE_S,
                   bgm_seconds: float = EPISODE_BGM_S) -> dict:
    """The episode's three int16 WAVs under ``root``, from
    ``default_rng(12)``: the voice (mono, 44.1 kHz): phrases of 1.5-4 s
    and pauses of 0.3-1.2 s of noise amplitude-modulated at a syllable
    rate, over a stationary noise floor (the first 0.5 s floor alone);
    the BGM (stereo, 48 kHz): a chord of tones with a slow tremolo; the
    IR (mono, 44.1 kHz): the port's 0.5 s ``synthetic_ir``."""
    from xmtpu_torch.io import write_wav
    from xmtpu_torch.ops.convert import f32_to_pcm16_np
    from xmtpu_torch.ops.reverb import synthetic_ir

    rng = np.random.default_rng(12)
    n = int(seconds * VOICE_SR)
    gate = np.zeros(n, np.float32)
    i, talk = int(0.5 * VOICE_SR), True
    while i < n:
        lo, hi = (1.5, 4.0) if talk else (0.3, 1.2)
        span = int(rng.uniform(lo, hi) * VOICE_SR)
        if talk:
            gate[i:i + span] = 1.0
        i, talk = i + span, not talk
    t = np.arange(n, dtype=np.float32) / np.float32(VOICE_SR)
    syllables = 0.55 + 0.45 * np.sin(2 * np.pi * 4.3 * t) ** 2
    voice = (0.12 * gate * syllables * rng.standard_normal(n, np.float32)
             + 0.01 * rng.standard_normal(n, np.float32))
    nb = int(bgm_seconds * BUS_SR)
    tb = np.arange(nb) / BUS_SR
    trem = 1.0 + 0.2 * np.sin(2 * np.pi * 0.25 * tb)
    chord = [(220.0, 329.63), (277.18, 440.0), (329.63, 554.37)]
    bgm = np.stack([sum(0.08 * trem * np.sin(2 * np.pi * f[c] * tb)
                        for f in chord) for c in (0, 1)], -1)
    ir = synthetic_ir(0.5, VOICE_SR)
    paths = {k: root / f"{k}.wav" for k in ("voice", "bgm", "ir")}
    write_wav(paths["voice"], f32_to_pcm16_np(voice), VOICE_SR)
    write_wav(paths["bgm"], f32_to_pcm16_np(bgm), BUS_SR)
    write_wav(paths["ir"], f32_to_pcm16_np(0.9 * ir / np.abs(ir).max()),
              VOICE_SR)
    return paths


def episode_config(paths):
    """The episode's pipeline: the voice (250 ms fade-in) over the BGM
    (looped, side-ducked, volume 0.5, 2 s fade-in) on a 48 kHz stereo
    bus; on the voice bus noise suppression, the bench's 5-band EQ and a
    reverb from the IR file (wet 0.2, dry 0.8); LUFS normalization to
    -16; a -1 dB limiter on the master in blocks of 65,536."""
    from xmtpu_torch.batch import DEFAULT_BANDS
    from xmtpu_torch.config import EffectConfig, PipelineConfig, TrackConfig

    return PipelineConfig(
        tracks=(TrackConfig(url=str(paths["voice"]), kind="voice",
                            fade_in_ms=250.0),
                TrackConfig(url=str(paths["bgm"]), kind="bgm", volume=0.5,
                            loop=True, side_duck=True, fade_in_ms=2000.0)),
        effects=(EffectConfig("noise_suppression", {}),
                 EffectConfig("equalizer", {"bands": list(DEFAULT_BANDS)}),
                 EffectConfig("reverb", {"ir_wav": str(paths["ir"]),
                                         "wet": 0.2, "dry": 0.8})),
        master_effects=(EffectConfig("limiter", {"threshold_db": -1.0,
                                                 "ceiling_db": -1.0}),),
        sample_rate=BUS_SR, channels=2, normalize="lufs",
        normalize_target_db=-16.0)


def roofline_ms(n_bytes: float, n_ops: float,
                ops_per_s: float = H100["f32_ops_per_s"]
                ) -> tuple[float, str]:
    t_bytes = n_bytes / H100["bytes_per_s"] * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# helpers of the phases from 22 on; ``h`` holds main()'s: card, dev,
# compare, bound, reset_counts, counts, check_k1


def pcm_db(got, ref):
    """RMS error of int16 or float32 PCM against ``ref`` in dB."""
    from xmtpu_torch.bench import rms_db

    g, r = (np.asarray(a, np.float64) / (32768.0 if a.dtype == np.int16
                                         else 1.0) for a in (got, ref))
    return rms_db(g - r, r)


def lsb(got, ref):
    return int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max())


def gate(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def recording(mod, name):
    """Wrap ``mod.name`` (a kernel's one-pass function) so that each
    call's operands are kept; -> (calls, restore)."""
    import torch

    real, calls = getattr(mod, name), []

    def rec(*a, **kw):
        calls.append((tuple(x.clone() if torch.is_tensor(x) else x
                            for x in a), kw))
        return real(*a, **kw)

    setattr(mod, name, rec)
    return calls, lambda: setattr(mod, name, real)


def traced(fn, frames_run):
    """(device operations a frame, kernels a frame, busy share, wall
    ms) of one traced call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and not e.is_user_annotation]
    ops = sum(e.count for e in ev)
    kern = sum(e.count for e in ev if not e.key.startswith("Mem"))
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    return ops / frames_run, kern / frames_run, busy / wall, wall


def plain_time(fn) -> float:
    """A plain twin's time in ms: one run (CUDA events) when it takes a
    second or more, the median of three after a warm-up otherwise."""
    import torch

    from xmtpu_torch.bench import median_ms

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    once = a.elapsed_time(b)
    return once if once >= 1000.0 else median_ms(fn, warmup=0, runs=3)


def check_k5(h, name, calls, launches):
    """K5 on a recorded launch's operands against its twin: y and zf
    max abs 0; its time as a graph replay (on the card) and from the
    host; the twin's time; the roofline bound."""
    from xmtpu_torch.bench import median_ms, replay_ms
    from xmtpu_torch.kernels import iir

    (x, sos, zi), _ = calls[-1]
    yk, zfk = iir.sosfilt_pass(x, sos, zi)
    yp, zfp = iir.sosfilt_plain(x, sos, zi)
    k = h.compare(name, "cuda", "xmtpu_torch/csrc/iir.cu",
                  "xmtpu/kernels/iir.py:37", yk, yp)
    k["max_abs_err"] = max(float((yk - yp).abs().max()),
                           float((zfk - zfp).abs().max()))
    gate(k["max_abs_err"] == 0.0, f"K5 {name} differs from its twin "
         f"by {k['max_abs_err']}")
    k["ms"] = replay_ms(lambda: iir.sosfilt_pass(x, sos, zi))
    host = median_ms(lambda: iir.sosfilt_pass(x, sos, zi))
    k["plain_ms"] = plain_time(lambda: iir.sosfilt_plain(x, sos, zi))
    k["launches"] = launches
    R, n = x.shape
    ns = sos.shape[0]
    h.bound(k, 4 * (2 * R * n + 6 * ns + 4 * ns * R), 9 * ns * R * n)
    print(f"K5 {name} ({R} x {n}, {ns} section{'s' * (ns > 1)}, S = 1): "
          f"max abs {k['max_abs_err']:.3g} vs the twin (y and zf); "
          f"{k['ms']:.4f} ms on the card (graph replay), {host:.4f} ms "
          f"from the host, twin {k['plain_ms']:.2f} ms, bound "
          f"{k['bound_ms']:.6f} ms ({k['bound_by']}); {launches} "
          f"launches [{h.card}]")


def check_k3(h, name, calls, launches):
    """The envelope kernel (envelope-only form) on a recorded launch's
    operands against its twin: e2 and the finals max abs 0."""
    from xmtpu_torch.bench import median_ms, replay_ms
    from xmtpu_torch.kernels import envelope

    a, kw = calls[-1]
    ek, zfk = envelope.envelope_pass(*a, **kw)
    ep, zfp = envelope.envelope_plain(*a, **kw)
    k = h.compare(name, "cuda", "xmtpu_torch/csrc/envelope.cu",
                  "xmtpu/kernels/envelope.py:108", ek, ep)
    k["max_abs_err"] = max(float((ek - ep).abs().max()),
                           float((zfk - zfp).abs().max()))
    gate(k["max_abs_err"] == 0.0, f"K3 {name} differs from its twin "
         f"by {k['max_abs_err']}")
    k["ms"] = replay_ms(lambda: envelope.envelope_pass(*a, **kw))
    host = median_ms(lambda: envelope.envelope_pass(*a, **kw))
    k["plain_ms"] = plain_time(lambda: envelope.envelope_plain(*a, **kw))
    k["launches"] = launches
    R, n = a[0].shape
    h.bound(k, 4 * (2 * R * n + 4 * R), 5 * R * n)
    print(f"K3 {name} ({R} x {n}, S = 1): max abs {k['max_abs_err']:.3g} "
          f"vs the twin (e2 and finals); {k['ms']:.4f} ms on the card "
          f"(graph replay), {host:.4f} ms from the host, twin "
          f"{k['plain_ms']:.2f} ms, bound {k['bound_ms']:.6f} ms "
          f"({k['bound_by']}); {launches} launches [{h.card}]")


def streaming_phases(h) -> None:
    """Phases 22 and 23: config 5 and serving on the card. ``h`` holds
    main()'s helpers: card, dev, compare, bound, reset_counts, counts,
    check_k1."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import torch

    from xmtpu_torch import bench as tbench
    from xmtpu_torch.graph import fx as tfx
    from xmtpu_torch.graph import mixer as tmix
    from xmtpu_torch.graph.pool import SessionPool
    from xmtpu_torch.graph.serve import PoolServer
    from xmtpu_torch.graph.streaming import StreamSession
    from xmtpu_torch.io import read_wav
    from xmtpu_torch.kernels import envelope, iir
    from xmtpu_torch.ops import reverb as treverb

    card = h.card

    def frames(sess, n):
        return np.concatenate([sess.read() for _ in range(n)], axis=0)

    # 22. config 5 at full size (xmtpu/benchmarks.py:174-252): a 4 s
    # voice at 44.1 kHz on a 16 kHz mono bus, 20 ms frames, master EQ
    # then limiter; the 32-slot pool of 8 s voices on both engines
    t22 = time.perf_counter()
    cfg5 = tbench.config5_config()
    src5, pool_srcs = tbench.config5_sources()
    n_gate = 50
    f32 = {d: frames(StreamSession(cfg5, sources=src5, device=d,
                                   output_dtype=np.float32), n_gate)
           for d in ("cuda", "cpu")}
    i16 = {d: frames(StreamSession(cfg5, sources=src5, device=d), n_gate)
           for d in ("cuda", "cpu")}
    db_cc, lsb_cc = pcm_db(f32["cuda"], f32["cpu"]), lsb(i16["cuda"],
                                                        i16["cpu"])
    s_many = StreamSession(cfg5, sources=src5, output_dtype=np.float32)
    many = np.concatenate([s_many.read_many(25), s_many.read_many(25)])
    db_many = pcm_db(many, f32["cuda"])
    mixed = tmix.mix([tmix.MixTrack(pcm=src5["v"][0], sr=src5["v"][1])],
                     16000, normalize=None)
    offline = tfx.apply_chain(mixed, 16000, list(cfg5.master_effects))
    db_off = pcm_db(f32["cuda"][:, 0], offline[:n_gate * 320])
    print(f"config 5: {n_gate} frames of 320; the card against the CPU "
          f"{db_cc:.1f} dB (float32, gate {GATE_CHAIN_DB}), {lsb_cc} LSB "
          f"(int16, gate 1); read_many(25) x 2 against the reads "
          f"{db_many:.1f} dB (gate -120); against the offline mixer and "
          f"chain on the card {db_off:.1f} dB (gate {GATE_CHAIN_DB}) "
          f"[{card}]")
    gate(db_cc <= GATE_CHAIN_DB and lsb_cc <= 1 and db_many <= -120.0
         and db_off <= GATE_CHAIN_DB, "config 5's session gates failed")
    K = len(pool_srcs)
    got = SessionPool(cfg5, K, sources=pool_srcs).read(4)
    worst = max(pcm_db(got[i], StreamSession(
        cfg5, sources=s).read_many(4)) for i, s in enumerate(pool_srcs))
    engines = {be: SessionPool(cfg5, K, sources=pool_srcs,
                               effects_backend=be, output_dtype=np.float32)
               for be in ("scan", "pallas")}
    db_eng = pcm_db(engines["pallas"].read(8), engines["scan"].read(8))
    db_eng16 = pcm_db(*(SessionPool(cfg5, K, sources=pool_srcs,
                                    effects_backend=be).read(2)
                        for be in ("pallas", "scan")))
    print(f"config 5 pool of {K}: the worst slot against its own session "
          f"{worst:.1f} dB (int16, gate {GATE_CHAIN_DB}); the kernels "
          f"against the scan engine {db_eng:.1f} dB (float32, gate "
          f"{GATE_CHAIN_DB}), {db_eng16:.1f} dB (int16, 2 frames, gate "
          f"-60) [{card}]")
    gate(worst <= GATE_CHAIN_DB and db_eng <= GATE_CHAIN_DB
         and db_eng16 <= -60.0, "config 5's pool gates failed")
    # no operation of a dispatch waits for the device (tables are copied
    # at the first frame: each path runs once before the check)
    sess_sync = StreamSession(cfg5, sources=src5, prefetch_depth=3)
    sess_sync.read()
    for p in engines.values():
        p.read(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess_sync._dispatch(sess_sync.frame_idx + 5, sess_sync.fx_state)
        for p in engines.values():
            p._dispatch(2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("config 5: a session's frame and both pools' groups dispatch "
          "without a synchronisation (torch.cuda.set_sync_debug_mode "
          "'error')")
    t0 = time.perf_counter()
    res5 = tbench.config5_streaming()
    print(f"config 5 bench ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(res5))
    for be, p in engines.items():
        p.read(25)
        ops, kern, busy, wall = traced(lambda p=p: p.read(25), 25)
        print(f"config 5 pool of {K} ({be}): {ops:.0f} device operations "
              f"a frame ({kern:.0f} kernels); a traced read(25) "
              f"{wall:.1f} ms, the card busy {100 * busy:.1f}% of it "
              f"[{card}]")
    # the kernel engine's launches, counters at 0 just before
    pk = SessionPool(cfg5, K, sources=pool_srcs, effects_backend="pallas")
    k5_calls, undo5 = recording(iir, "sosfilt_pass")
    k3_calls, undo3 = recording(envelope, "envelope_pass")
    try:
        h.reset_counts()
        pk.read(4)
        torch.cuda.synchronize()
        got5 = h.counts()
    finally:
        undo5()
        undo3()
    print(f"config 5 pool ({K} slots, kernels): launches {got5}")
    gate(got5["iir"] and got5["envelope_seg"],
         f"the config-5 pool did not launch K5 and the envelope kernel: "
         f"{got5}")
    check_k5(h, "iir_stream", k5_calls, got5["iir"])
    check_k3(h, "envelope_seg_stream", k3_calls, got5["envelope_seg"])
    del engines, pk, k5_calls, k3_calls
    print(f"phase 22: {time.perf_counter() - t22:.1f} s")

    # 23. serving: a PoolServer with two buckets (config 5; the
    # episode's voice chain at 48 kHz stereo, normalize off, 8 sessions
    # of 20 s), churned by open, read, pump, a close and a seek; every
    # served stream against a StreamSession of its source
    t23 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_:
        paths = episode_inputs(Path(tmp_), seconds=20.0, bgm_seconds=10.0)
        cfg_ep = dataclasses.replace(episode_config(paths), normalize=None)
        voice_ep = read_wav(paths["voice"])[0][:, 0]
        bgm_ep = read_wav(paths["bgm"])[0]
        n_ep = 8
        src_ep = [{str(paths["voice"]): (np.roll(voice_ep, i * 2 * VOICE_SR),
                                         VOICE_SR),
                   str(paths["bgm"]): (bgm_ep, BUS_SR)}
                  for i in range(n_ep)]
        srv = PoolServer(n_slots=n_ep, max_seconds=20.0)
        # a segment: (config, sources, first frame, frames served); a
        # seek or a close ends one
        live, done = {}, []

        def opened(cfg, src):
            sid = srv.open(cfg, src)
            live[sid] = (cfg, src, 0, [])
            return sid

        def take(out):
            for sid, a in out.items():
                live[sid][3].append(a)

        def verify(seg):
            cfg, src, first, chunks = seg
            ref_s = StreamSession(cfg, sources=src)
            ref_s.seek(first * ref_s.frame_out * 1000.0 / cfg.sample_rate)
            g = np.concatenate(chunks)
            n = g.shape[0] // ref_s.frame_out
            return n, pcm_db(g, ref_s.read_many(n))

        eps = [opened(cfg_ep, s) for s in src_ep]
        c5 = [opened(cfg5, s) for s in pool_srcs[:4]]
        take({eps[0]: srv.read(eps[0], 10)})
        take({c5[0]: srv.read(c5[0], 6)})
        take(srv.pump(4))
        srv.close(eps[-1])
        done.append(live.pop(eps[-1]))
        srv.seek(eps[1], 200.0)
        done.append(live[eps[1]])
        live[eps[1]] = (cfg_ep, src_ep[1], 10, [])
        opened(cfg5, pool_srcs[4])
        take(srv.pump(4))
        take({eps[2]: srv.read(eps[2], 5)})
        take(srv.pump(4))
        st = srv.stats()
        results = [verify(seg) for seg in done + list(live.values())]
        worst23 = max(db for _, db in results)
        print(f"serving: {st['buckets']} buckets, {st['pools']} pools, "
              f"{st['sessions']} sessions open (one closed, one sought, "
              f"one opened mid-run); {len(results)} served streams "
              f"({sum(n for n, _ in results)} frames) against their own "
              f"sessions: worst {worst23:.1f} dB (int16, gate "
              f"{GATE_CHAIN_DB}) [{card}]")
        gate(st["buckets"] == 2 and worst23 <= GATE_CHAIN_DB
             and all(n > 0 for n, _ in results),
             f"the serving gates failed: {results}")
        del srv

        # the episode chain on the kernels: the folded EQ+reverb on K1
        # (its input history carried), the master limiter's envelope
        pe = SessionPool(cfg_ep, n_ep, sources=src_ep, effects_backend="pallas")
        k1_calls, undo1 = recording(treverb, "fir_convolve")
        k3e_calls, undo3 = recording(envelope, "envelope_pass")
        try:
            h.reset_counts()
            t0 = time.perf_counter()
            pe.read(4)
            torch.cuda.synchronize()
            pe_ms = (time.perf_counter() - t0) * 1e3
            got1 = h.counts()
        finally:
            undo1()
            undo3()
        k1_key = "fftconv_long" if got1["fftconv_long"] else "fftconv"
        print(f"episode chain pool ({n_ep} slots, kernels): launches {got1}; "
              f"read(4) {pe_ms:.1f} ms [{card}]")
        gate(got1[k1_key] and got1["envelope_seg"],
             f"the episode pool did not launch K1 and the envelope "
             f"kernel: {got1}")
        (x1, ir1, row1, col1), _ = k1_calls[-1]
        k1s = h.check_k1("fftconv_stream_episode", x1, ir1, row1, col1)
        k1s["launches"] = got1[k1_key]
        check_k3(h, "envelope_seg_stream_episode", k3e_calls,
                 got1["envelope_seg"])
        del pe, k1_calls, k3e_calls
    print(f"phase 23: {time.perf_counter() - t23:.1f} s")


def _spawn(args, cwd):
    """A ``python`` subprocess of the repo (stdout and stderr piped)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def runner_phases(h, n_clips: int = 64, seconds: float = 10.0) -> None:
    """Phases 24-26: the native host runtime, config 6 (the file-batch
    runner) at full size, then the command line, the compat handles and
    the five examples. ``h`` holds main()'s helpers; ``n_clips`` and
    ``seconds`` cut config 6 for a rehearsal on the CPU."""
    import os
    import tempfile
    import threading
    import wave

    import torch

    from xmtpu_torch import batch as tbatch
    from xmtpu_torch import bench as tbench
    from xmtpu_torch import compat, native
    from xmtpu_torch import runner as trunner
    from xmtpu_torch.api import Session, effects, process_file, resample
    from xmtpu_torch.bench import median_ms
    from xmtpu_torch.config import load_config
    from xmtpu_torch.io import read_wav, write_wav
    from xmtpu_torch.io import wav as twav
    from xmtpu_torch.kernels import envelope, iir
    from xmtpu_torch.ops import convert
    from xmtpu_torch.ops import reverb as treverb

    card, dev = h.card, h.dev
    on_card = dev.type == "cuda"
    dev_args = [] if on_card else ["--device", str(dev)]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # 24. the native host runtime: a hard gate (the pure-Python fallback
    # must not stand in here), a fresh build timed, every entry point
    # bit for bit against its stdlib or numpy twin
    t24 = time.perf_counter()
    gate(native.available(), "the native library did not build or load")
    root = native.BUILD_ROOT
    with tempfile.TemporaryDirectory() as d:
        native.BUILD_ROOT = Path(d)
        t0 = time.perf_counter()
        try:
            native.build()
        finally:
            native.BUILD_ROOT = root
        build_s = time.perf_counter() - t0
        rng = np.random.default_rng(24)
        x = (rng.standard_normal((441000, 2)) * 12000).astype(np.int16)
        p_std, p_nat = os.path.join(d, "std.wav"), os.path.join(d, "n.wav")
        with wave.open(p_std, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(44100)
            w.writeframes(x.astype("<i2").tobytes())
        got, sr = native.read_wav_native(p_std)
        ok_read = (sr == 44100 and np.array_equal(got, x)
                   and np.array_equal(got, twav._read_wav_stdlib(p_std)[0]))
        native.write_wav_native(p_nat, x, 44100)
        ok_write = Path(p_nat).read_bytes() == Path(p_std).read_bytes()
    f32 = (rng.standard_normal(1 << 20) * 0.6).astype(np.float32)
    i16 = rng.integers(-32768, 32768, 1 << 20).astype(np.int16)
    ok_conv = (np.array_equal(native.f32_to_i16_native(f32),
                              convert.f32_to_pcm16_np(f32))
               and np.array_equal(native.i16_to_f32_native(i16),
                                  convert.pcm16_to_f32_np(i16)))
    chan = native.PcmChannel(capacity=1 << 20)
    gate(chan._fifo is not None, "PcmChannel fell back to the deque")
    sent = [(rng.standard_normal(int(k)) * 9000).astype(np.int16)
            for k in rng.integers(1, 1_500_000, 8)]

    def produce():
        try:
            for i, a in enumerate(sent):
                chan.put([a, None], i)
        finally:
            chan.close()

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    recv = []
    while (item := chan.get()) is not None:
        recv.append(item)
    th.join(30)
    ok_chan = (len(recv) == len(sent) and all(
        m == i and b is None and np.array_equal(a, sent[i])
        for i, ((a, b), m) in enumerate(recv)))
    print(f"native: g++ build {build_s:.2f} s; WAV read and write bit-exact "
          f"against the stdlib path (441000 x 2): {ok_read}, {ok_write}; "
          f"int16 <-> float32 on 2^20 samples: {ok_conv}; PcmChannel, 8 "
          f"frames of up to {max(a.nbytes for a in sent) / 2**20:.1f} MiB "
          f"through a 1 MiB ring: {ok_chan}")
    gate(ok_read and ok_write and ok_conv and ok_chan,
         "the native runtime differs from its twins")
    print(f"phase 24: {time.perf_counter() - t24:.1f} s")

    # 25. config 6 at full size (xmtpu/benchmarks.py:255-309): 64 WAV
    # clips of 10 s at 44.1 kHz -> 16 kHz WAVs through run_batch;
    # pipelined (cold, then warm with fresh counters and the kernels'
    # operands recorded), serial and with 4 decode threads: identical
    # bytes; a traced warm pass; the step alone
    t25 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        jobs = tbench.config6_jobs(d, n_clips, seconds)
        audio_s = n_clips * seconds
        runs = {}

        def run(tag, **kw):
            js = [dict(j, out=j["out"].replace("out_", f"{tag}_"))
                  for j in jobs]
            rep = trunner.run_batch(js, resume=False,
                                    write_done_markers=False, device=dev,
                                    **kw)
            gate(rep.done == n_clips and not rep.failed,
                 f"config 6 ({tag}) failed: {rep.failed}")
            runs[tag] = (js, rep)
            return rep

        cold = run("cold")
        k1_calls, undo1 = recording(treverb, "fir_convolve")
        k5_calls, undo5 = recording(iir, "sosfilt_pass")
        k3_calls, undo3 = recording(envelope, "envelope_pass")
        try:
            h.reset_counts()
            warm = run("pipelined")
            sync()
            got = h.counts()
        finally:
            undo1()
            undo5()
            undo3()
        serial = run("serial", pipeline=False)
        thr4 = run("threads4", decode_threads=4)
        warm2 = run("pipelined2")
        chunks = -(-n_clips // 64)
        print(f"config 6 ({n_clips} WAV clips x {seconds:g} s, {chunks} "
              f"chunk(s) of 64): launches {got}; audio-s/s wall clock: cold "
              f"{audio_s / cold.wall_sec:.1f}, warm pipelined "
              f"{audio_s / warm.wall_sec:.1f} and "
              f"{audio_s / warm2.wall_sec:.1f}, serial "
              f"{audio_s / serial.wall_sec:.1f}, decode_threads=4 "
              f"{audio_s / thr4.wall_sec:.1f}; peak_hbm_bytes "
              f"{warm.peak_hbm_bytes} [{card}]")
        gate(not on_card or all(got[k] for k in ("fftconv", "iir",
                                                 "state_chain",
                                                 "envelope_seg")),
             f"config 6 did not launch K1, K5, its chain and K3: {got}")
        gate(not on_card or (warm.peak_hbm_bytes or 0) > 0,
             "config 6 reported no peak memory on the card")
        same = all(
            Path(runs[t][0][i]["out"]).read_bytes()
            == Path(runs["pipelined"][0][i]["out"]).read_bytes()
            for t in ("cold", "serial", "threads4", "pipelined2")
            for i in range(n_clips))
        print(f"config 6: cold, pipelined, serial, decode_threads=4 and a "
              f"second pipelined run wrote identical bytes: {same}")
        gate(same, "config 6's modes wrote different bytes")
        if on_card:
            _, kern, busy, wall = traced(lambda: run("traced"), 1)
            print(f"config 6 traced warm pass: {wall:.1f} ms wall, "
                  f"{kern:.0f} kernels, the card busy {100 * busy:.2f}% "
                  f"[{card}]")
        # the host stages of one chunk, in the serial mode's order
        edge = trunner._bucket_edge(int(tbench.SR_IN * seconds))
        disp = trunner._Dispatcher(16000, {}, dev)
        stage_jobs = [trunner.ClipJob(voice=j["voice"], out=j["out"].replace(
            "out_", "stage_")) for j in jobs[:64]]
        sync()
        t0 = time.perf_counter()
        chunk = [(j,) + trunner._decode_job(j, tbench.SR_IN, 16000)[:2]
                 for j in stage_jobs]
        t1 = time.perf_counter()
        lens_c, out_dev = disp.dispatch(tbench.SR_IN, edge, chunk)
        t2 = time.perf_counter()
        sync()
        t3 = time.perf_counter()
        out_c = out_dev.cpu().numpy()
        t4 = time.perf_counter()
        rep_c = trunner.BatchReport()
        trunner._write_chunk(rep_c, chunk, lens_c, out_c, tbench.SR_IN,
                             16000, True)
        t5 = time.perf_counter()
        gate(rep_c.done == len(chunk), f"the stage run failed: {rep_c}")
        print(f"config 6 host stages of one chunk ({len(chunk)} clips, "
              f"serial order): decode {(t1 - t0) * 1e3:.1f} ms, pack + "
              f"upload + launch {(t2 - t1) * 1e3:.1f} ms, the card "
              f"finishing {(t3 - t2) * 1e3:.1f} ms, fetch "
              f"{(t4 - t3) * 1e3:.1f} ms, WAV writes and markers "
              f"{(t5 - t4) * 1e3:.1f} ms; {(t5 - t0) * 1e3:.1f} ms in all "
              f"[{card}]")
        del out_dev, out_c, chunk
        # the step alone on the chunk's device inputs (no upload)
        pcm = np.zeros((min(n_clips, 64), edge), np.int16)
        for i in range(pcm.shape[0]):
            pcm[i, :int(tbench.SR_IN * seconds)] = read_wav(
                jobs[i]["voice"])[0][:, 0]
        lens = np.full(pcm.shape[0], int(tbench.SR_IN * seconds), np.int32)
        step = tbatch.make_batch_step(device=dev)
        args = (torch.from_numpy(pcm).to(dev),
                torch.from_numpy(np.zeros_like(pcm)).to(dev),
                torch.from_numpy(lens).to(dev))
        if on_card:
            step_ms = median_ms(lambda: step(*args), warmup=1, runs=5)
            print(f"config 6 step alone ({pcm.shape[0]} x {edge}): "
                  f"{step_ms:.3f} ms = {100 * step_ms / 1e3 / warm.wall_sec:.2f}"
                  f"% of the warm pipelined wall clock "
                  f"({warm.wall_sec * 1e3:.1f} ms) [{card}]")
        # clips 0-2 against the same step on the CPU (the kernels' plain
        # twins), clip 0 against the float64 oracle
        y3 = tbatch.make_batch_step(device="cpu")(
            torch.from_numpy(pcm[:3]), torch.from_numpy(np.zeros_like(pcm[:3])),
            torch.from_numpy(lens[:3])).numpy()
        worst = -np.inf
        for i in range(3):
            out = read_wav(runs["pipelined"][0][i]["out"])[0][:, 0]
            worst = max(worst, pcm_db(out, y3[i, :out.shape[0]]))
        out0 = read_wav(runs["pipelined"][0][0]["out"])[0][:, 0]
        ref0 = tbatch.flagship_oracle_np(pcm[0, :lens[0]],
                                         np.zeros(lens[0], np.int16))
        db0 = pcm_db(out0, ref0)
        print(f"config 6 outputs: clips 0-2 against the CPU twin step worst "
              f"{worst:.1f} dB, clip 0 against flagship_oracle_np "
              f"{db0:.1f} dB (gates {GATE_CHAIN_DB}) [{card}]")
        gate(worst <= GATE_CHAIN_DB and db0 <= GATE_CHAIN_DB,
             "config 6's outputs failed their gates")
        del args, step, y3
        if on_card:
            k1 = h.check_k1("fftconv_runner", *k1_calls[-1][0])
            k1["launches"] = got["fftconv"]
            check_k5(h, "iir_runner", k5_calls, got["iir"])
            check_k3(h, "envelope_seg_runner", k3_calls, got["envelope_seg"])
        del k1_calls, k5_calls, k3_calls
        res6 = tbench.config6_file_batch(n_clips, seconds, fmt="wav",
                                         device=dev)
        h.wav6 = res6
        print(f"bench config 6: {json.dumps(res6)}")
    print(f"phase 25: {time.perf_counter() - t25:.1f} s")

    # 26. the command line, the compat handles and the five examples:
    # subprocesses started together, outputs against the API's in this
    # process
    t26 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dd = Path(d)
        jobs = tbench.config6_jobs(d, 4, seconds)
        voice = jobs[0]["voice"]
        (dd / "manifest.json").write_text(json.dumps(
            [dict(j, out=j["out"].replace("out_", "cli_")) for j in jobs]))
        x3, _ = tbench.config3_inputs(1, seconds)
        write_wav(dd / "st48.wav", convert.f32_to_pcm16_np(x3[0]), 48000)
        chain = [{"name": "equalizer",
                  "params": {"bands": list(tbatch.DEFAULT_BANDS)}},
                 {"name": "reverb", "params": {"ir_seconds": 0.5,
                                               "wet": 0.3, "dry": 0.7}},
                 {"name": "limiter"}]
        cfg = {"sampleRate": 48000, "normalize": "lufs",
               "normalizeTargetDb": -16.0, "tracks": [{"url": voice}],
               "effects": [chain[0]],
               "masterEffects": [{"name": "limiter",
                                  "params": {"threshold_db": -1.0}}]}
        (dd / "gen.json").write_text(json.dumps(cfg))
        cli = {
            "batch": ["batch", str(dd / "manifest.json"), "--no-resume"],
            "resample": ["resample", voice, str(dd / "rs.wav"), "--rate",
                         "16000"],
            "effects": ["effects", str(dd / "st48.wav"), str(dd / "fx.wav"),
                        "--chain", json.dumps(chain)],
            "generate": ["generate", str(dd / "gen.json"),
                         str(dd / "gen.wav")],
        }
        examples = {
            "batch_pipeline": ([str(dd / "ex_batch")], '"failed": []'),
            "compat_handles": ([str(dd)], "generator: status 2"),
            "lufs_mastering": ([], "-16.00 LUFS"),
            "serving_pool": ([], "checkpoint/resume bit-exact: True"),
            "streaming_session": ([], "group (8000, 1)"),
        }
        procs = {k: _spawn(["-m", "xmtpu_torch.cli", *a, *dev_args], d)
                 for k, a in cli.items()}
        procs.update({f"example {k}": _spawn(
            [str(REPO / "examples" / f"torch_{k}.py"), *a, *dev_args], d)
            for k, (a, _) in examples.items()})
        # meanwhile, in this process: the API's outputs and the handles
        rep = trunner.run_batch(
            [dict(j, out=j["out"].replace("out_", "api_")) for j in jobs],
            resume=False, device=dev)
        gate(rep.done == 4 and not rep.failed, "the API batch failed")
        pcm_v, sr_v = read_wav(voice)
        rs_api = resample(pcm_v, sr_v, 16000, device=dev)
        st, _ = read_wav(dd / "st48.wav")
        fx_api = effects(st, 48000, chain, block_size=131072, device=dev)
        process_file(None, load_config(str(dd / "gen.json")),
                     str(dd / "gen_api.wav"), device=dev)
        sess_cfg = json.dumps({"sampleRate": 16000, "tracks": [
            {"url": voice, "fadeInTimeMs": 50}],
            "effects": [{"name": "limiter"}]})
        hd = compat.XmAudioUtils(device=dev)
        hd.mixer_init(sess_cfg)
        def handle_frames(get, limit):
            out = []
            while len(out) < limit and (f := get()) is not None:
                out.append(f)
            return out

        mixer_frames = handle_frames(hd.mixer_get_frame, 50)
        ref_sess = Session(json.loads(sess_cfg), device=dev)
        sess_frames = np.concatenate([ref_sess.read()
                                      for _ in mixer_frames])
        mixer_frames = np.concatenate(mixer_frames)
        hd.effects_init({"effects": chain[:1], "sampleRate": 16000}, voice)
        hd.effects_seek(250.0)
        fx_frames = handle_frames(hd.effects_get_frame, 25)
        ref_fx = Session({"sampleRate": 16000, "effects": chain[:1],
                          "tracks": [{"url": voice}]}, device=dev)
        ref_fx.seek(250.0)
        fx_ref = np.concatenate([ref_fx.read() for _ in fx_frames])
        fx_frames = np.concatenate(fx_frames)
        hd.freep()
        gen = compat.XmAudioGenerator(device=dev)
        gen.start(str(dd / "gen.json"), str(dd / "gen_compat.wav"))
        gen_status = gen.wait(300)
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        rcs = {k: p.returncode for k, p in procs.items()}
        bad = {k: outs[k][1][-1500:] for k, rc in rcs.items() if rc != 0}
        gate(not bad, f"subprocesses failed: {bad}")
        for k, (_, want) in examples.items():
            gate(want in outs[f"example {k}"][0],
                 f"example {k} printed no {want!r}: {outs[f'example {k}']}")
        worst_b = max(pcm_db(read_wav(j["out"].replace("out_", "cli_"))[0],
                             read_wav(j["out"].replace("out_", "api_"))[0])
                      for j in jobs)
        same_b = all(Path(j["out"].replace("out_", "cli_")).read_bytes()
                     == Path(j["out"].replace("out_", "api_")).read_bytes()
                     for j in jobs)
        dbs = {"batch": worst_b,
               "resample": pcm_db(read_wav(dd / "rs.wav")[0], rs_api),
               "effects": pcm_db(read_wav(dd / "fx.wav")[0], fx_api),
               "generate": pcm_db(read_wav(dd / "gen.wav")[0],
                                  read_wav(dd / "gen_api.wav")[0]),
               "compat mixer": pcm_db(mixer_frames, sess_frames),
               "compat effects": pcm_db(fx_frames, fx_ref),
               "compat generator": pcm_db(
                   read_wav(dd / "gen_compat.wav")[0],
                   read_wav(dd / "gen_api.wav")[0])}
        print("command line and compat against the API: "
              + ", ".join(f"{k} {v:.1f} dB" for k, v in dbs.items())
              + f" (gate {GATE_CHAIN_DB}); batch bytes identical: {same_b}; "
              f"generator status {gen_status}; subprocesses "
              f"{sorted(rcs)} exit 0 [{card}]")
        gate(all(v <= GATE_CHAIN_DB for v in dbs.values())
             and gen_status == compat.GS_COMPLETED,
             "the command line or the compat handles differ from the API")
    print(f"phase 26: {time.perf_counter() - t26:.1f} s")


def parallel_phases(h, clip_s: float = 3600.0, clip_2d_s: float = 600.0,
                    scan_shard: int = 262144, n_clips: int = BATCH,
                    real_clip_s: float = 600.0, engine: str = "auto",
                    prefix: int = 2048, phases=(27, 28, 29)) -> None:
    """Phases 27-29: sequence and data parallelism
    (``xmtpu_torch.parallel``) on 4 virtual shards of the card, then on
    the host's real cards where it has several. ``h`` holds main()'s
    helpers; the sizes cut the phases for a rehearsal on the CPU
    (``engine="kernel"`` there, where the auto rule would take the
    scans at a short shard). ``phases``: which of 27-29 to run (a call
    on a host of several cards may run 29 alone)."""
    import torch
    from scipy import signal as sps

    from xmtpu_torch import batch as tbatch
    from xmtpu_torch import bench as tbench
    from xmtpu_torch.bench import median_ms, replay_ms, step_seconds
    from xmtpu_torch.graph.pool import SessionPool
    from xmtpu_torch.graph.serve import PoolServer
    from xmtpu_torch.graph.streaming import StreamSession
    from xmtpu_torch.kernels import envelope, iir
    from xmtpu_torch.ops import biquad, limiter
    from xmtpu_torch.ops import reverb as treverb
    from xmtpu_torch.parallel import Mesh, sp_effects_chain
    from xmtpu_torch.parallel import sp as tsp
    from xmtpu_torch.parallel.dryrun import dryrun_multichip

    card, dev = h.card, h.dev
    on_card = dev.type == "cuda"
    n_sh = 4
    sr = 48000
    sos = biquad.eq_sos(list(tbatch.DEFAULT_BANDS), sr)
    ir = treverb.synthetic_ir(0.5, sr).astype(np.float32)
    virt = [str(dev)] * n_sh

    def sync():
        for i in range(torch.cuda.device_count() if on_card else 0):
            torch.cuda.synchronize(i)

    def wall(fn):
        """(seconds, result) of ``fn()`` by the host clock, synchronised."""
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    def db_max(got, ref):
        """(RMS error in dB, max abs) of ``got`` against ``ref``, in
        float64 on their device."""
        err = got.double() - ref.double()
        p_err = float(err.pow(2).sum())
        p_ref = float(ref.double().pow(2).sum())
        db = -math.inf if p_err == 0 else 10.0 * math.log10(p_err / p_ref)
        return db, float(err.abs().max())

    def single(x):
        """The port's one-device chain, as tests/test_sp.py builds it:
        the IIR kernel, the reverb (K1), the limiter (envelope kernel)."""
        y, _ = iir.sosfilt(sos, x)
        y = treverb.reverb(y, ir, wet=0.3, dry=0.7)
        return limiter.limiter(y, sr)[0]

    def sharded(x, mesh, **kw):
        return sp_effects_chain(x, sr, mesh, bands=sos, ir=ir,
                                engine=kw.pop("engine", engine), **kw)

    def sp_leg(label, x, mesh, ref_s=None, **kw):
        """Sharded against single-device: gate -80 dB; both times (the
        second call of each)."""
        sharded(x, mesh, **kw)
        t_sp, y = wall(lambda: sharded(x, mesh, **kw))
        single(x)
        t_one, ref = wall(lambda: single(x))
        db, mx = db_max(y, ref)
        audio = x.shape[-1] / sr * (x.shape[0] if x.dim() == 3 else 1)
        print(f"{label} {tuple(x.shape)} over {mesh}: {db:.1f} dB vs the "
              f"single-device chain (gate {GATE_CHAIN_DB}), max abs {mx:.3g};"
              f" sharded {t_sp * 1e3:.1f} ms = {audio / t_sp:.0f} audio-s/s,"
              f" single device {t_one * 1e3:.1f} ms = {audio / t_one:.0f} "
              f"audio-s/s" + (f"; on virtual shards {ref_s * 1e3:.1f} ms"
                              if ref_s is not None else "") + f" [{card}]")
        gate(db <= GATE_CHAIN_DB and bool(torch.isfinite(y).all()),
             f"{label}: {db:.1f} dB against the single-device chain")
        return t_sp

    if 27 in phases:
        # 27. SP at the clip lengths it exists for: one stereo clip of an
        # hour at 48 kHz, time-sharded over 4 virtual shards of the card,
        # config 3's chain (the 5-band EQ, a 0.5 s IR at wet 0.3 / dry 0.7,
        # the default limiter)
        t27 = time.perf_counter()
        n = int(clip_s * sr)
        rng = np.random.default_rng(0)
        x_host = rng.standard_normal((2, n), dtype=np.float32)
        x_host *= np.float32(0.3)
        x = torch.from_numpy(x_host).to(dev)
        mesh_sp = Mesh(virt, ("sp",))
        k5_calls, k5_restore = recording(iir, "sosfilt_pass")
        k3_calls, k3_restore = recording(envelope, "envelope_pass")
        h.reset_counts()
        try:
            sync()
            y_sp = sharded(x, mesh_sp)
            sync()
        finally:
            k5_restore()
            k3_restore()
        got = h.counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t_sp, y_sp = wall(lambda: sharded(x, mesh_sp))
        peak_sp = torch.cuda.max_memory_allocated() if on_card else 0
        del y_sp
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t_one, ref = wall(lambda: single(x))
        peak_one = torch.cuda.max_memory_allocated() if on_card else 0
        y_sp = sharded(x, mesh_sp)
        db, mx = db_max(y_sp, ref)
        del ref
        # the first 10 s against the float64 oracle (every stage is causal)
        n10 = min(n, 10 * sr)
        y64 = sps.sosfilt(sos, x_host[:, :n10].astype(np.float64), axis=-1)
        w64 = sps.fftconvolve(y64, ir.astype(np.float64)[None],
                              axes=-1)[:, :n10]
        y64 = 0.7 * y64 + 0.3 * w64
        d64 = torch.from_numpy(np.abs(y64).max(axis=0))
        env64, _ = limiter.decaying_max_scan(
            d64, limiter._release_coeff(100.0, sr), 0.0)
        e2_64, _ = limiter.onepole_scan(env64, limiter._attack_coeff(1.0, sr),
                                        0.0)
        level64 = 20.0 * torch.log10(torch.clamp_min(e2_64, 1e-12))
        g64 = torch.pow(10.0, limiter.soft_knee_gain_db(level64, -3.0, 6.0)
                        / 20.0)
        oracle = np.clip(y64 * g64.numpy()[None], -1.0, 1.0)
        db10, _ = db_max(y_sp[:, :n10].cpu(), torch.from_numpy(oracle))
        audio = n / sr
        print(f"phase 27: one {clip_s:g} s stereo clip at 48 kHz "
              f"{tuple(x.shape)} ({x.numel() * 4 / 1e9:.2f} GB) through "
              f"sp_effects_chain over {mesh_sp} ({n // n_sh} samples a "
              f"shard, engine {engine}): {db:.1f} dB vs the single-device "
              f"chain, max abs {mx:.3g}; first {n10 / sr:g} s {db10:.1f} dB "
              f"vs the float64 oracle (gates {GATE_CHAIN_DB}); sharded "
              f"{t_sp * 1e3:.1f} ms = {audio / t_sp:.0f} audio-s/s, single "
              f"device {t_one * 1e3:.1f} ms = {audio / t_one:.0f} audio-s/s; "
              f"peak memory {peak_sp / 2**30:.2f} GiB sharded, "
              f"{peak_one / 2**30:.2f} GiB single [{card}]")
        print(f"phase 27 launches in the sharded call: {got}")
        gate(db <= GATE_CHAIN_DB and db10 <= GATE_CHAIN_DB
             and bool(torch.isfinite(y_sp).all()),
             f"the hour clip: {db:.1f} dB vs the single device, {db10:.1f} dB "
             "vs the oracle")
        if on_card:
            for key in ("iir", "state_chain", "envelope_seg"):
                gate(got[key] >= n_sh and got[key] % n_sh == 0,
                     f"the sharded chain's {key} launches {got[key]} are not "
                     f"a positive multiple of its {n_sh} shards")
        del y_sp

        # K5 and the envelope core at the shard's operands: each at its full
        # shape (a graph replay), and on the first ``prefix`` samples of
        # every row of the same operands against its twin (max abs 0; a
        # row's prefix depends only on itself: the twins' time loops take
        # ~30 s at a shard's full length)
        (xk, sk, zk), _ = k5_calls[-1]
        t_full = replay_ms(lambda: iir.sosfilt_pass(xk, sk, zk)) if on_card \
            else math.nan
        shard = x[:, :n // n_sh].contiguous()
        t_call = median_ms(lambda: iir.sosfilt(sos, shard)) if on_card \
            else math.nan
        xp = xk[:, :prefix].contiguous()
        yk, zfk = iir.sosfilt_pass(xp, sk, zk)
        yp, zfp = iir.sosfilt_plain(xp, sk, zk)
        k5 = h.compare("iir_sp_shard", "cuda", "xmtpu_torch/csrc/iir.cu",
                       "xmtpu/kernels/iir.py:37", yk, yp)
        k5["max_abs_err"] = max(float((yk - yp).abs().max()),
                                float((zfk - zfp).abs().max()))
        gate(k5["max_abs_err"] == 0.0, "K5 at the shard differs from its twin")
        k5["ms"] = replay_ms(lambda: iir.sosfilt_pass(xp, sk, zk)) if on_card \
            else math.nan
        k5["plain_ms"] = plain_time(lambda: iir.sosfilt_plain(xp, sk, zk)) \
            if on_card else math.nan
        k5["launches"] = got["iir"]
        R5, ns = xk.shape[0], sk.shape[0]
        h.bound(k5, 4 * (2 * R5 * prefix + 6 * ns + 4 * ns * R5),
                9 * ns * R5 * prefix)
        print(f"K5 at the hour clip's shard: the pass at {tuple(xk.shape)} "
              f"{t_full:.3f} ms on the card (graph replay; {len(k5_calls)} "
              f"passes in the call), the sosfilt() call on the shard "
              f"{tuple(shard.shape)} {t_call:.3f} ms from the host; on its "
              f"first {prefix} samples (R = {R5}): max abs "
              f"{k5['max_abs_err']:.3g} vs the twin, {k5['ms']:.4f} ms, twin "
              f"{k5['plain_ms']:.1f} ms, bound {k5['bound_ms']:.5f} ms "
              f"({k5['bound_by']}) [{card}]")
        del shard
        k3_ms = []
        # the last shard's one-pole call (envelope(env, 0, c_att)): 2 launches
        for a, kw in k3_calls[-2:]:
            k3_ms.append(replay_ms(lambda a=a, kw=kw: envelope.envelope_pass(
                *a, **kw)) if on_card else math.nan)
        a, kw = k3_calls[-1]
        ap = (a[0][:, :prefix].contiguous(),) + a[1:4] + tuple(
            t[:prefix] if i == 0 else t for i, t in enumerate(a[4:]))
        ek, zk3 = envelope.envelope_pass(*ap, **kw)
        ep, zp3 = envelope.envelope_plain(*ap, **kw)
        k3 = h.compare("envelope_sp_shard", "cuda",
                       "xmtpu_torch/csrc/envelope.cu",
                       "xmtpu/kernels/envelope.py:108", ek, ep)
        k3["max_abs_err"] = max(float((ek - ep).abs().max()),
                                float((zk3 - zp3).abs().max()))
        gate(k3["max_abs_err"] == 0.0, "the envelope core at the shard "
             "differs from its twin")
        k3["ms"] = replay_ms(lambda: envelope.envelope_pass(*ap, **kw)) \
            if on_card else math.nan
        k3["plain_ms"] = plain_time(
            lambda: envelope.envelope_plain(*ap, **kw)) if on_card \
            else math.nan
        k3["launches"] = got["envelope_seg"]
        R3 = ap[0].shape[0]
        h.bound(k3, 4 * (2 * R3 * prefix + 4 * R3 + prefix), 5 * R3 * prefix)
        print(f"K3 at the hour clip's shard (1 x {n // n_sh}, the detector): "
              f"{len(k3_calls)} launches in the call, the last shard's "
              f"one-pole call {' + '.join(f'{t:.3f}' for t in k3_ms)} ms on "
              f"the card (graph replays, {tuple(a[0].shape)} each); on its "
              f"first {prefix} samples (R = {R3}): max abs "
              f"{k3['max_abs_err']:.3g} vs the twin, {k3['ms']:.4f} ms, twin "
              f"{k3['plain_ms']:.1f} ms, bound {k3['bound_ms']:.5f} ms "
              f"({k3['bound_by']}) [{card}]")
        # a shard's FIR, its halo prepended: torch.fft overlap-save (the
        # sharded chain's, as XLA's FFT is the JAX package's) against K1's
        # long form on the same operands
        if on_card:
            xw = x[:, :n // n_sh + len(ir) - 1].contiguous()
            ir_d = torch.from_numpy(ir).to(dev)
            blk = tsp._fir_block_auto(n // n_sh, len(ir))
            t_os = median_ms(lambda: treverb.fir_convolve_os(xw, ir_d, blk))
            t_k1 = median_ms(lambda: treverb.reverb(xw, ir_d, wet=1.0,
                                                    dry=0.0))
            db_f, _ = db_max(treverb.fir_convolve_os(xw, ir_d, blk),
                             treverb.reverb(xw, ir_d, wet=1.0, dry=0.0))
            print(f"phase 27: a shard's FIR {tuple(xw.shape)} x {len(ir)} "
                  f"taps: torch.fft overlap-save ({blk}-point blocks) "
                  f"{t_os:.2f} ms, K1's long form {t_k1:.2f} ms, "
                  f"{db_f:.1f} dB apart [{card}]")
            del xw
        del k5_calls, k3_calls, x, x_host
        # the 2-D leg: 4 mono clips x 10 min over a 2 x 2 virtual mesh
        mesh_2d = Mesh(np.array(virt, dtype=object).reshape(2, 2),
                       ("dp", "sp"))
        xb = torch.from_numpy((0.3 * np.random.default_rng(4).standard_normal(
            (4, 1, int(clip_2d_s * sr)), dtype=np.float32))).to(dev)
        sp_leg("phase 27 dp x sp", xb, mesh_2d, dp_axis="dp")
        del xb
        # the scan engine against the kernel engine, 2 x 262,144 a shard
        xs = torch.from_numpy((0.3 * np.random.default_rng(5).standard_normal(
            (2, n_sh * scan_shard), dtype=np.float32))).to(dev)
        t_scan, ys = wall(lambda: sharded(xs, mesh_sp, engine="scan"))
        t_kern, yk = wall(lambda: sharded(xs, mesh_sp, engine="kernel"))
        db, mx = db_max(yk, ys)
        print(f"phase 27 engines {tuple(xs.shape)} over {mesh_sp}: the kernel "
              f"engine {db:.1f} dB vs the scan engine (gate {GATE_CHAIN_DB}), "
              f"max abs {mx:.3g}; scan {t_scan * 1e3:.1f} ms, kernel "
              f"{t_kern * 1e3:.1f} ms (first calls) [{card}]")
        gate(db <= GATE_CHAIN_DB, f"kernel vs scan engine {db:.1f} dB")
        del xs, ys, yk
        print(f"phase 27: {time.perf_counter() - t27:.1f} s")

    if 28 in phases:
        # 28. data parallelism and serving on 4 virtual shards: the sharded
        # flagship step on the root bench's clips, config 5's pool, a server,
        # the dryrun twin
        t28 = time.perf_counter()
        mesh_dp = Mesh(virt, ("dp",))
        voice, bgm = tbench.make_inputs(n_clips, CLIP_SECONDS)
        v = torch.from_numpy(voice).to(dev)
        b = torch.from_numpy(bgm).to(dev)
        step_dp = tbatch.flagship_step_sharded(mesh_dp)
        step_one = tbatch.make_flagship_step(device=dev)
        h.reset_counts()
        y_dp = step_dp(v, b)
        sync()
        got = h.counts()
        y_one = step_one(v, b)
        db, mx = db_max(y_dp.float() / 32768.0, y_one.float() / 32768.0)
        ref0 = tbatch.flagship_oracle_np(voice[:1], bgm[:1])
        db0 = pcm_db(y_dp[:1].cpu().numpy(), ref0)
        iters = 5 if on_card else 1
        s_dp, _ = step_seconds(step_dp, v, b, iters=iters) if on_card \
            else (math.nan, None)
        s_one, _ = step_seconds(step_one, v, b, iters=iters) if on_card \
            else (math.nan, None)
        audio = n_clips * CLIP_SECONDS
        print(f"phase 28: flagship_step_sharded over {mesh_dp} on {n_clips} "
              f"clips of {CLIP_SECONDS:g} s (the fused branch: "
              f"{step_dp.fused_for(n_clips)}, {n_clips // n_sh} rows a "
              f"shard): {db:.1f} dB vs the unsharded step (gate -120), max abs"
              f" {mx * 32768:.0f} LSB; clip 0 {db0:.1f} dB vs the float64 "
              f"oracle (gate {GATE_CHAIN_DB}); {audio / s_dp:.0f} audio-s/s "
              f"sharded, "
              f"{audio / s_one:.0f} unsharded; launches {got} [{card}]")
        # on the CPU (a rehearsal) the twins' segment rules and torch.fft
        # round by batch shape: the chain's gate there
        gate(db <= (-120.0 if on_card else GATE_CHAIN_DB)
             and db0 <= GATE_CHAIN_DB,
             f"the sharded step: {db:.1f} dB vs unsharded, {db0:.1f} vs "
             "oracle")
        if on_card:
            gate(got["fftconv"] == n_sh and got["envelope"] == n_sh
                 and got["iir"] == 0, f"the sharded step's launches {got}: "
                 f"K1 and K2 once a shard, K5 never")
        del v, b, y_dp, y_one
        # config 5's 32-slot pool over the dp mesh, both engines
        cfg5 = tbench.config5_config()
        _, pool_srcs = tbench.config5_sources()
        rates = {}
        for be in ("scan", "pallas"):
            pools = {name: SessionPool(cfg5, len(pool_srcs), frame_ms=20.0,
                                       sources=pool_srcs, effects_backend=be,
                                       **kw)
                     for name, kw in (("sharded", {"mesh": mesh_dp}),
                                      ("unsharded", {"device": dev}))}
            outs = {name: np.concatenate([p.read(25), p.read(25)], axis=1)
                    for name, p in pools.items()}
            db, mx = (pcm_db(outs["sharded"], outs["unsharded"]),
                      lsb(outs["sharded"], outs["unsharded"]))
            for name, p in pools.items():
                t0 = time.perf_counter()
                done = sum(o.shape[0] * o.shape[1] / p.sr
                           for o in (p.read(50) for _ in range(3)))
                rates[(be, name)] = done / (time.perf_counter() - t0)
            print(f"phase 28: {len(pool_srcs)}-slot pool ({be}) over "
                  f"{mesh_dp}: {db:.1f} dB vs the unsharded pool (gate "
                  f"{GATE_CHAIN_DB}), max abs {mx} LSB; "
                  f"{rates[(be, 'sharded')]:.1f} audio-s/s sharded, "
                  f"{rates[(be, 'unsharded')]:.1f} unsharded [{card}]")
            gate(db <= GATE_CHAIN_DB, f"the sharded pool ({be}): {db:.1f} dB")
        pool = pools["sharded"]  # the kernels' engine
        pool.leave(1)
        gate(not pool.read(4)[1].any(), "a departed slot of the sharded pool "
             "is not silent")
        pool.join(1, pool_srcs[1])
        pool.seek(0, 100.0)
        sess = StreamSession(cfg5, frame_ms=20.0, sources=pool_srcs[1],
                             device=dev)
        db = pcm_db(pool.read(4)[1], sess.read_many(4))
        print(f"phase 28: the sharded pool's slot 1 after leave / join / "
              f"seek {db:.1f} dB vs its StreamSession (gate "
              f"{GATE_CHAIN_DB}) [{card}]")
        gate(db <= GATE_CHAIN_DB,
             f"the sharded pool's rejoined slot: {db:.1f} dB")
        del pools, pool
        # the server: two configs bucketed into two sharded pools
        rng = np.random.default_rng(3)
        pcm = (0.3 * rng.standard_normal(16000)).astype(np.float32)
        srv = PoolServer(n_slots=n_sh, frame_ms=20.0, mesh=mesh_dp)
        cfgs = {"a": {"tracks": [{"url": "a"}], "sampleRate": 16000,
                      "normalize": None,
                      "masterEffects": [{"name": "limiter"}]},
                "b": {"tracks": [{"url": "b", "volume": 0.5}],
                      "sampleRate": 16000, "normalize": None}}
        sids = {srv.open(c, sources={k: (pcm, 16000)}): (c, k)
                for k, c in cfgs.items()}
        for sid, (c, k) in sids.items():
            got_s = srv.read(sid, 10)
            ref_s = StreamSession(c, frame_ms=20.0, sources={k: (pcm, 16000)},
                                  device=dev).read_many(10)
            db = pcm_db(got_s, ref_s)
            gate(db <= GATE_CHAIN_DB, f"served stream {k}: {db:.1f} dB")
        print(f"phase 28: a PoolServer over {mesh_dp}: "
              f"{srv.stats()['pools']} pools for 2 configs, every stream "
              f"within {GATE_CHAIN_DB} dB of its session [{card}]")
        dryrun_multichip(n_sh, device=str(dev))
        print(f"phase 28: {time.perf_counter() - t28:.1f} s")

    if 29 in phases:
        # 29. real cards, where the host has them
        n_cards = torch.cuda.device_count() if on_card else 0
        if n_cards < 2:
            print(f"phase 29: {max(n_cards, 1)} card, not run")
            return
        t29 = time.perf_counter()
        k = min(4, n_cards)
        cards = [f"cuda:{i}" for i in range(k)]
        mesh_k = Mesh(cards, ("sp",))
        xr = torch.from_numpy((0.3 * np.random.default_rng(6).standard_normal(
            (2, int(real_clip_s * sr)), dtype=np.float32))).to(dev)
        t_virt = sp_leg("phase 29 sp, virtual", xr, Mesh([str(dev)] * k,
                                                         ("sp",)))
        sp_leg("phase 29 sp, real cards", xr, mesh_k, ref_s=t_virt)
        # what the real cards add: moving the clip's shards out of cuda:0
        # and the result back (peer to peer where the cards allow it)
        spec = (None, "sp")
        mesh_k.concat(mesh_k.split(xr, spec), spec, dev)
        t_move, _ = wall(lambda: mesh_k.concat(mesh_k.split(xr, spec), spec,
                                               dev))
        peer = [[i != j and torch.cuda.can_device_access_peer(i, j)
                 for j in range(k)] for i in range(k)]
        print(f"phase 29: peer access between the cards {peer}; the 10 min "
              f"clip split over them and gathered back {t_move * 1e3:.1f} ms "
              f"[{card}]")
        del xr
        mesh_kd = Mesh(cards, ("dp",))
        voice, bgm = tbench.make_inputs(n_clips, CLIP_SECONDS)
        v = torch.from_numpy(voice).to(dev)
        b = torch.from_numpy(bgm).to(dev)
        ref = tbatch.make_flagship_step(device=dev)(v, b)
        for label, m in (("virtual", Mesh([str(dev)] * k, ("dp",))),
                         ("real cards", mesh_kd)):
            st = tbatch.flagship_step_sharded(m)
            y = st(v, b)
            db, mx = db_max(y.float() / 32768.0, ref.float() / 32768.0)
            s, _ = step_seconds(st, v, b, iters=5)
            print(f"phase 29 dp, {label}, over {m}: {db:.1f} dB vs the "
                  f"unsharded step (gate -120), max abs {mx * 32768:.0f} LSB; "
                  f"{n_clips * CLIP_SECONDS / s:.0f} audio-s/s [{card}]")
            gate(db <= -120.0, f"phase 29 dp ({label}): {db:.1f} dB")
        cfg5 = tbench.config5_config()
        _, pool_srcs = tbench.config5_sources()
        for label, m in (("virtual", Mesh([str(dev)] * k, ("dp",))),
                         ("real cards", mesh_kd)):
            p = SessionPool(cfg5, len(pool_srcs), frame_ms=20.0,
                            sources=pool_srcs, mesh=m)
            p1 = SessionPool(cfg5, len(pool_srcs), frame_ms=20.0,
                             sources=pool_srcs, device=dev)
            db = pcm_db(p.read(25), p1.read(25))
            t0 = time.perf_counter()
            done = sum(o.shape[0] * o.shape[1] / p.sr
                       for o in (p.read(50) for _ in range(3)))
            rate = done / (time.perf_counter() - t0)
            print(f"phase 29 pool, {label}, over {m}: {db:.1f} dB vs the "
                  f"unsharded pool (gate {GATE_CHAIN_DB}); {rate:.1f} "
                  f"audio-s/s [{card}]")
            gate(db <= GATE_CHAIN_DB, f"phase 29 pool ({label}): {db:.1f} dB")
        dryrun_multichip(k)
        print(f"phase 29: {k} cards, {time.perf_counter() - t29:.1f} s")


def entry_phase(h, n_clips: int = 64, seconds: float = 10.0) -> None:
    """Phase 30: ``xmtpu_torch.entry.entry()`` on the card, the
    ``interpret=`` rule of the step factories and ``reverb``, and the
    FFmpeg shim on this machine. ``h`` holds main()'s helpers (and
    ``wav6``, phase 25's config-6 result); ``n_clips`` and ``seconds``
    cut the FLAC config 6 for a rehearsal on the CPU, where the refusals
    of ``interpret=True`` are not checked (the CPU takes it)."""
    import shutil
    import tempfile

    import torch

    from xmtpu_torch import batch as tbatch
    from xmtpu_torch import bench as tbench
    from xmtpu_torch import entry as tentry
    from xmtpu_torch import io as tio
    from xmtpu_torch.native import ffmpeg
    from xmtpu_torch.ops import reverb as treverb
    from xmtpu_torch.parallel import Mesh
    from xmtpu_torch.utils.errors import ConfigError, DecodeError

    card, dev = h.card, h.dev
    on_card = dev.type == "cuda"
    t30 = time.perf_counter()

    # (a) entry() on the card: the small-batch branch
    fn, args = tentry.entry(device=dev)
    h.reset_counts()
    y = fn(*args)
    if on_card:
        torch.cuda.synchronize()
    got = h.counts()
    path = ("iir", "state_chain", "fftconv", "envelope_seg")
    print("phase 30: entry() on 2 x 1 s, launches "
          + ", ".join(f"{k} {got[k]}" for k in path))
    if on_card:
        gate(all(got[k] > 0 for k in path),
             f"entry(): a kernel of its path did not launch: {got}")
    fn_c, args_c = tentry.entry(device="cpu")
    y = y.cpu().numpy()
    db_cpu = pcm_db(y, fn_c(*args_c).numpy())
    voice, bgm = (a.numpy() for a in args_c)
    db_or = max(pcm_db(y[i], tbatch.flagship_oracle_np(voice[i], bgm[i]))
                for i in range(2))
    ms = (tbench.median_ms(lambda: fn(*args), warmup=2, runs=9) if on_card
          else float("nan"))
    print(f"phase 30: entry() {y.shape} {y.dtype}: {db_cpu:.1f} dB against "
          f"entry(device='cpu'), worst clip {db_or:.1f} dB against "
          f"flagship_oracle_np (gates {GATE_CHAIN_DB}); a call {ms:.3f} ms "
          f"(median of 9, CUDA events) [{card}]")
    gate(db_cpu <= GATE_CHAIN_DB and db_or <= GATE_CHAIN_DB,
         "entry() failed its gates")

    # (b) interpret=: True refused off the CPU before anything is built,
    # False and None launch the kernels
    x = torch.from_numpy(np.random.default_rng(30).standard_normal(
        (2, 16000), dtype=np.float32)).to(dev)
    ir = treverb.synthetic_ir(0.05, 16000)
    if on_card:
        mesh = Mesh([str(dev)] * 2, ("dp",))
        refused = []
        for name, f in (
                ("make_flagship_step", lambda: tbatch.make_flagship_step(
                    interpret=True, device=dev)),
                ("make_batch_step", lambda: tbatch.make_batch_step(
                    interpret=True)),
                ("flagship_step_sharded", lambda: tbatch.flagship_step_sharded(
                    mesh, interpret=True)),
                ("reverb", lambda: treverb.reverb(x, ir, interpret=True))):
            try:
                f()
            except ConfigError:
                refused.append(name)
        print(f"phase 30: interpret=True refused on {dev}: {refused}")
        gate(len(refused) == 4, "interpret=True was not refused on the card")
    for it in (False, None):
        h.reset_counts()
        treverb.reverb(x, ir, interpret=it)
        tbatch.make_flagship_step(interpret=it, device=dev)(*args)
        if on_card:
            torch.cuda.synchronize()
        got = h.counts()
        print(f"phase 30: interpret={it}: launches "
              + ", ".join(f"{k} {got[k]}" for k in path))
        if on_card:
            gate(got["fftconv"] == 2 and all(got[k] > 0 for k in path),
                 f"interpret={it} did not launch the kernels: {got}")

    # (c) the FFmpeg shim on this machine
    libs = ("libavcodec", "libavformat", "libavutil", "libswresample")
    try:
        pc = subprocess.run(["pkg-config", "--modversion", *libs],
                            capture_output=True, text=True)
        found = pc.stdout.split() if pc.returncode == 0 else []
    except FileNotFoundError:
        found = []
    print(f"phase 30: pkg-config {' '.join(libs)}: "
          + (", ".join(f"{n} {v}" for n, v in zip(libs, found)) if found
             else "not found")
          + f"; io.HAVE_FFMPEG {tio.HAVE_FFMPEG}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ff_"))
    try:
        if found or tio.HAVE_FFMPEG:
            t0 = time.perf_counter()
            ok = ffmpeg.available()
            t_build = time.perf_counter() - t0
            log = ffmpeg.library_path().parent / "build.log"
            gate(ok, "the FFmpeg shim did not build where libav is: "
                 + (log.read_text()[-2000:] if log.exists() else "no log"))
            tone = (np.sin(2 * np.pi * 440.0 * np.arange(441000) / 44100.0)
                    * 12000).astype(np.int16)
            for ext in ("flac", "mp3"):
                p = str(tmp / f"tone.{ext}")
                tio.encode_audio(p, tone, 44100)
                with tio.open_audio(p) as d:
                    back = d.read_all()[:, 0]
                spec = np.abs(np.fft.rfft(back.astype(np.float64)))
                f0 = np.fft.rfftfreq(len(back), 1 / 44100.0)[np.argmax(spec)]
                exact = (len(back) == len(tone)
                         and np.array_equal(back, tone))
                print(f"phase 30: {ext} round trip of 10 s: {len(back)} "
                      f"samples, dominant {f0:.1f} Hz, bit-exact {exact}")
                gate(abs(len(back) - len(tone)) < 0.06 * 44100
                     and abs(f0 - 440.0) < 2.0
                     and (exact or ext != "flac"),
                     f"the {ext} round trip failed")
            res = tbench.config6_file_batch(n_clips, seconds, fmt="flac",
                                            device=dev)
            wav = getattr(h, "wav6", None)
            print(f"phase 30: the shim built in {t_build:.1f} s; bench config "
                  f"6 on FLAC: {res['audio_sec_per_sec']:.1f} audio-s/s warm "
                  f"({res['cold_audio_sec_per_sec']:.1f} cold), on WAV "
                  + (f"{wav['audio_sec_per_sec']:.1f}" if wav else "not run")
                  + f" (phase 25) [{card}]")
            gate("flac" in res["desc"], f"config 6 did not read FLAC: {res}")
        else:
            p = tmp / "x.flac"
            p.write_bytes(b"fLaC" + bytes(60))
            try:
                tio.open_audio(p)
                raised = False
            except DecodeError:
                raised = True
            print(f"phase 30: no libav here; HAVE_FFMPEG {tio.HAVE_FFMPEG}, "
                  f"a .flac raises DecodeError: {raised}")
            gate(not tio.HAVE_FFMPEG and raised,
                 "without libav a .flac must raise DecodeError")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 30: {time.perf_counter() - t30:.1f} s")


def precision_phase(h, n_clips: int = BATCH, seconds: float = CLIP_SECONDS,
                    long_rows: int = 32, long_n: int = 480000,
                    ops_rows: int = 8, ops_n: int = 88200) -> None:
    """Phase 31: the JAX package's last surface on the card. The
    matmul precision rungs (``ops.precision``): the ``mixfirst`` front
    of the default step at HIGHEST / HIGH / DEFAULT as a probe (the
    front's ``apply_aligned`` wrapped for the run, the default step
    checked unchanged after it), the resample ops' rungs and
    ``dtype=bfloat16`` against their CPU plain versions, K7 at each rung
    against its split twin (also on non-finite input),
    ``fir_convolve_os_mxu`` at each variant x gauss x rung; K1's
    ``trim=False`` (short and long form) against its twin with its first
    n samples against ``trim=True``, and K1 at ``gp`` 1, 2, 4, 16
    against ``gp=None``; the ``mixfirst_pad`` step against ``mixfirst``.
    ``h`` holds main()'s helpers. The sizes cut it for a rehearsal on
    the CPU (``h.dev = torch.device("cpu")``), where times read nan."""
    import functools

    import torch

    from xmtpu_torch import batch as tbatch
    from xmtpu_torch.bench import make_inputs, median_ms, rms_db, step_seconds
    from xmtpu_torch.kernels import fftconv
    from xmtpu_torch.kernels import resample as kresample
    from xmtpu_torch.ops import convert, fftmm
    from xmtpu_torch.ops import precision as tprec
    from xmtpu_torch.ops import resample as tresample
    from xmtpu_torch.ops import reverb as treverb

    card, dev = h.card, h.dev
    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    rungs = tprec.RUNGS
    t31 = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def ms(fn):
        return median_ms(fn) if on_card else float("nan")

    def db(got, ref):
        g, r = (t.double().cpu().numpy() for t in (got, ref))
        return rms_db(g - r, r)

    def maxabs(a, b):
        return float((a.double() - b.double()).abs().max())

    # (a) the mixfirst front at each rung, as a probe
    voice, bgm = make_inputs(n_clips, seconds)
    v = torch.from_numpy(voice).to(dev)
    b = torch.from_numpy(bgm).to(dev)
    step = tbatch.make_flagship_step(fused=True, device=dev)
    y_ref = step(v, b)
    ref0 = tbatch.flagship_oracle_np(voice[0], bgm[0])
    B, M = v.shape[0], step.M
    tabs = (step.H1, step.H0, step.H2, step.lo, step.hi, step.r0, step.r2)
    m3 = (b.reshape(B, -1, M) * step.gain).add_(v.reshape(B, -1, M))
    m3p = torch.nn.functional.pad(m3, (0, -(-M // tbatch.LANE_PAD)
                                       * tbatch.LANE_PAD - M))
    t_mix = ms(lambda: (b.reshape(B, -1, M) * step.gain).add_(
        v.reshape(B, -1, M)))
    real = tresample.apply_aligned
    fronts, front_db, step_db = {}, {}, {}
    try:
        for rung in rungs:
            tresample.apply_aligned = functools.partial(real, precision=rung)
            fronts[rung], _, _ = step.front(v, b)
            front_db[rung] = db(fronts[rung], fronts[rungs[0]])
            t_front = ms(lambda: step.front(v, b))
            t_mm = ms(lambda: real(m3, *tabs, precision=rung))
            # the same matmuls on the lane-padded (mixfirst_pad) operand:
            # K = 512, aligned for the bf16 tensor-core kernels
            t_mm_pad = ms(lambda: real(m3p, *tabs, precision=rung))
            split_line = ""
            if rung != "highest":  # the main product: split, then passes
                a_hi, a_lo = tprec.split(m3)
                h_hi, h_lo = tprec.split(step.H1)

                def passes(r=rung):
                    out = tprec.bf16_pass(a_hi, h_hi)
                    if r == "high":
                        out += tprec.bf16_pass(a_hi, h_lo)
                        out += tprec.bf16_pass(a_lo, h_hi)
                    return out

                split_line = (f"; of the main product, the bf16 split of "
                              f"the operand {ms(lambda: tprec.split(m3)):.3f}"
                              f" ms and its tensor-core passes "
                              f"{ms(passes):.3f} ms")
                del a_hi, a_lo
            y = step(v, b)
            sync()
            step_db[rung] = pcm_db(y[0].cpu().numpy(), ref0)
            sec = (step_seconds(step, v, b, iters=5)[0] * 1e3 if on_card
                   else float("nan"))
            print(f"phase 31: mixfirst front at {rung}: front "
                  f"{t_front:.3f} ms = mix passes {t_mix:.3f} + the "
                  f"aligned resample's matmuls {t_mm:.3f} (+ ramp and "
                  f"normalize; the matmuls on the {m3p.shape[-1]}-lane "
                  f"operand {t_mm_pad:.3f}{split_line}); front "
                  f"{front_db[rung]:.1f} dB "
                  f"against the "
                  f"FP32 front; the default step with this front "
                  f"{sec:.3f} ms, clip 0 {step_db[rung]:.1f} dB against "
                  f"flagship_oracle_np ({B} x {seconds:g} s) [{card}]")
    finally:
        tresample.apply_aligned = real
    gate(all(step_db[r] <= GATE_CHAIN_DB for r in ("highest", "high")),
         f"the step's HIGHEST/HIGH fronts failed the chain gate: {step_db}")
    gate(front_db["highest"] == -np.inf
         and -np.inf < front_db["high"] < front_db["default"],
         f"the front's rungs do not round apart: {front_db}")
    gate(torch.equal(step(v, b), y_ref),
         "the default step changed after the precision probe")
    del fronts, m3, m3p

    # (b) the resample ops at each rung and in bf16, card against CPU
    xr = torch.from_numpy((0.5 * np.random.default_rng(31).standard_normal(
        (ops_rows, ops_n))).astype(np.float32))
    for method, n in (("banded", ops_n), ("banded", ops_n - 200),
                      ("conv", ops_n - 200), ("window", ops_n - 200)):
        x64 = tresample.resample_oracle_np(xr[:, :n].double().numpy(),
                                           44100, 16000)
        out = []
        for rung in rungs + ("bf16",):
            kw = ({"dtype": torch.bfloat16} if rung == "bf16"
                  else {"precision": rung})
            yc = tresample.polyphase_resample(xr[:, :n].to(dev), 44100,
                                              16000, method=method, **kw)
            yp = tresample.polyphase_resample(xr[:, :n], 44100, 16000,
                                              method=method, **kw)
            d = db(yc.float(), yp.float())
            d64 = rms_db(yc.double().cpu().numpy() - x64, x64)
            out.append(f"{rung} {d:.1f} ({d64:.1f})")
            gate(yc.dtype == (torch.bfloat16 if rung == "bf16"
                              else torch.float32)
                 and d <= (GATE_BF16_DB if rung == "bf16" else -120.0),
                 f"polyphase_resample({method}, {rung}) on {dev} vs the "
                 f"CPU: {d:.1f} dB")
        print(f"phase 31: polyphase_resample(method={method!r}) "
              f"{ops_rows} x {n} 44.1k -> 16k, {dev} against the CPU, dB "
              "(against float64): " + ", ".join(out))

    # (c) K7 at each rung against its split twin, on the pallas front's
    # operand (both tracks as 2B rows), and on non-finite rows
    x7 = convert.pcm16_to_f32(torch.cat([v, b], 0))
    k7_db = {}
    for rung in rungs:
        kresample.launches = 0
        yk = kresample.resample(x7, 44100, 16000, precision=rung)
        sync()
        got = kresample.launches
        yp = tresample.polyphase_resample(x7, 44100, 16000, precision=rung)
        d, e = db(yk, yp), maxabs(yk, yp)
        k7_db[rung] = db(yk, kresample.resample(x7, 44100, 16000))
        t_k = ms(lambda: kresample.resample(x7, 44100, 16000,
                                            precision=rung))
        t_p = ms(lambda: tresample.polyphase_resample(x7, 44100, 16000,
                                                      precision=rung))
        print(f"phase 31: K7 {tuple(x7.shape)} at {rung}: {got} launches, "
              f"{d:.1f} dB against its twin (gate -120), max abs {e:.3g}; "
              f"{k7_db[rung]:.1f} dB against K7 at highest; kernel "
              f"{t_k:.3f} ms, twin {t_p:.3f} ms [{card}]")
        gate(got == (3 if rung == "high" else 1) if on_card else True,
             f"K7 at {rung} launched {got} times")
        gate(d <= -120.0, f"K7 at {rung} against its twin: {d:.1f} dB")
    gate(-np.inf < k7_db["high"] < k7_db["default"],
         f"K7's rungs do not round apart: {k7_db}")
    del yk, yp
    n_al = min(x7.shape[1], 2 * 44100) // 441 * 441
    for n in (n_al, n_al - 100):  # the twin's aligned / windowed branch
        xn = x7[:2, :n].repeat(4, 1)  # 8 rows
        xn[1, n // 7], xn[3, n // 2] = float("nan"), float("inf")
        xn[5, n // 3], xn[5, n // 3 + 100] = float("-inf"), float("nan")
        nan_rows = [1]  # NaN and no inf: isnan masks must agree too
        for rung in rungs:
            yk = kresample.resample(xn, 44100, 16000, precision=rung)
            yp = tresample.polyphase_resample(xn, 44100, 16000,
                                              precision=rung)
            fin = torch.isfinite(yk) & torch.isfinite(yp)
            same = (torch.equal(~torch.isfinite(yk), ~torch.isfinite(yp))
                    and torch.equal(yk[nan_rows].isnan(),
                                    yp[nan_rows].isnan()))
            d = db(yk[fin], yp[fin])
            print(f"phase 31: K7 non-finite {tuple(xn.shape)} at {rung}: "
                  f"masks equal {same}, {int((~fin).sum())} non-finite "
                  f"outputs, finite ones {d:.1f} dB against the twin")
            gate(same and d <= -120.0, f"K7's non-finite masks at {rung}")
    del x7, xn

    # (d) the matmul DFTs at each variant x gauss x rung
    xm = torch.from_numpy((0.3 * np.random.default_rng(32).standard_normal(
        (4, 16000 * max(1, int(seconds)))).astype(np.float32)))
    irm = treverb.synthetic_ir(0.05, 16000).astype(np.float32)
    ref_m = treverb.reverb_np(xm.numpy(), irm, wet=1.0, dry=0.0)
    for variant in ("fused", "four_step"):
        for gauss in (False, True):
            cells = {}
            for rung in rungs:
                def run(x, r=rung):
                    return fftmm.fir_convolve_os_mxu(
                        x, irm, precision=r, variant=variant, gauss=gauss)
                yc = run(xm.to(dev))
                d_cpu = db(yc, run(xm))
                d64 = rms_db(yc.double().cpu().numpy() - ref_m, ref_m)
                cells[rung] = (d64, d_cpu, ms(lambda: run(xm.to(dev))))
            print(f"phase 31: fir_convolve_os_mxu {tuple(xm.shape)} x "
                  f"{len(irm)} taps, {variant}, gauss={gauss}: "
                  + ", ".join(f"{r} {c[0]:.1f} dB vs float64, {c[1]:.1f} "
                              f"vs the CPU, {c[2]:.3f} ms"
                              for r, c in cells.items()) + f" [{card}]")
            d64s = [cells[r][0] for r in rungs]
            gate(d64s[0] <= -120.0 and d64s[0] < d64s[1] < d64s[2]
                 and cells["highest"][1] <= -120.0
                 and cells["high"][1] <= GATE_MXU_HIGH_DB
                 and cells["default"][1] <= GATE_MXU_DEFAULT_DB,
                 f"fir_convolve_os_mxu {variant} gauss={gauss}: {cells}")

    # (e) K1: trim=False against its twin, its first n samples against
    # trim=True, and gp against None; the default step's operands (short
    # form) and a 0.5 s 48 kHz IR (long form)
    m, scale, ramp = step.front(v, b)
    rng = np.random.default_rng(33)
    x_l = torch.from_numpy((0.3 * rng.standard_normal(
        (long_rows, long_n))).astype(np.float32)).to(dev)
    ir_l = torch.from_numpy(treverb.synthetic_ir(0.5, 48000).astype(
        np.float32)).to(dev)
    for form, ops, block in (
            ("short", (m.contiguous(), step.ir, scale.contiguous(),
                       ramp.contiguous()), 32768),
            ("long", (x_l, ir_l, torch.ones(long_rows, device=dev),
                      torch.ones(long_n, device=dev)), 65536)):
        R, n = ops[0].shape
        taps = ops[1].shape[0]
        n_pad = fftconv.padded_length(n, taps, block)
        y_trim = fftconv.fir_convolve(*ops)
        y_pad = fftconv.fir_convolve(*ops, trim=False, block=block)
        twin = fftconv.fir_convolve_plain(*ops, n_out=n_pad)
        d = db(y_pad, twin)
        e0 = maxabs(y_pad[:, :n], y_trim)
        t_trim = ms(lambda: fftconv.fir_convolve(*ops))
        t_pad = ms(lambda: fftconv.fir_convolve(*ops, trim=False,
                                                block=block))
        print(f"phase 31: K1 {form} form ({R}, {n}) x {taps} taps, "
              f"trim=False (block {block}) -> ({R}, {n_pad}): {d:.1f} dB "
              f"against its twin (gate -120), its first {n} samples max "
              f"abs {e0:.3g} against trim=True (gate 0); {t_pad:.3f} ms, "
              f"trim=True {t_trim:.3f} ms [{card}]")
        gate(tuple(y_pad.shape) == (R, n_pad) and d <= -120.0 and e0 == 0.0,
             f"K1 {form} trim=False")
        gp_line = []
        for gp in (1, 2, 4, 16):
            e = maxabs(fftconv.fir_convolve(*ops, gp=gp), y_trim)
            t_gp = ms(lambda g=gp: fftconv.fir_convolve(*ops, gp=g))
            gp_line.append(f"gp {gp}: max abs {e:.3g}, {t_gp:.3f} ms")
            gate(e == 0.0, f"K1 {form} at gp={gp} differs from gp=None")
        print(f"phase 31: K1 {form} form against gp=None "
              f"({t_trim:.3f} ms): " + "; ".join(gp_line) + f" [{card}]")
    del y_trim, y_pad, twin, x_l, ir_l, m, scale, ramp

    # (f) the mixfirst_pad step against mixfirst
    pad = tbatch.make_flagship_step(fused=True, device=dev,
                                    resample_backend="mixfirst_pad")
    y_pad = pad(v, b)
    sync()
    d = pcm_db(y_pad.cpu().numpy(), y_ref.cpu().numpy())
    e = lsb(y_pad.cpu().numpy(), y_ref.cpu().numpy())
    em = maxabs(pad.front(v, b)[0], step.front(v, b)[0])
    t_pad = (step_seconds(pad, v, b, iters=5)[0] * 1e3 if on_card
             else float("nan"))
    t_ref = (step_seconds(step, v, b, iters=5)[0] * 1e3 if on_card
             else float("nan"))
    print(f"phase 31: the mixfirst_pad step {tuple(y_pad.shape)} against "
          f"mixfirst: {e} LSB, {d:.1f} dB (gates 1 LSB, -120 dB); the "
          f"fronts' max abs {em:.3g}; step {t_pad:.3f} ms, mixfirst "
          f"{t_ref:.3f} ms [{card}]")
    # the dB gate at the card's full size (one LSB of a short rehearsal's
    # output already reads about -105 dB)
    gate(e <= 1 and (d <= -120.0 or not on_card),
         "the mixfirst_pad step against mixfirst")
    print(f"phase 31: {time.perf_counter() - t31:.1f} s")


def lufs_phase(h, bus, sr: int) -> None:
    """Phase 21's block-power kernel (``csrc/lufs_blocks.cu``) alone on
    the K-weighting of the episode bus ``bus`` (2 x 28.8 M float32 at
    48 kHz: 5,997 blocks of 19,200 every 4,800) with fresh counters: one
    launch; its powers against ``block_powers_plain``'s (the float64
    cumulative sum and gather) of the same tensor, max abs within
    ``GATE_LUFS_BLOCKS`` of the largest power, a gate that float32 sums of
    the same blocks must fail (their error printed beside it); a second
    run bit for bit; the kernel's time (CUDA events, median of 7 after
    2) and the twin's; the bound: the bus read once and the powers
    written once, the squares and sums over the float64 peak."""
    import torch

    from xmtpu_torch.bench import median_ms
    from xmtpu_torch.kernels import iir, lufs
    from xmtpu_torch.ops import loudness

    xw = iir.sosfilt(loudness.k_weighting_sos(sr), bus.contiguous())[0]
    ch, n = xw.shape
    block, hop, nblk = geo = loudness._block_geometry(n, sr)
    want = lufs.block_powers_plain(xw, *geo)
    h.reset_counts()
    got = lufs.block_powers(xw, *geo)
    launches = h.counts()["lufs"]
    k = h.compare("lufs_blocks", "cuda", "xmtpu_torch/csrc/lufs_blocks.cu",
                  None, got, want)
    k["launches"] = launches
    top = float(want.abs().max())
    rel = k["max_abs_err"] / top
    f32 = torch.sum(torch.square(xw.unfold(-1, block, hop)), dim=-1)
    rel32 = float((torch.sum(f32, dim=0) / block - want).abs().max()) / top
    del f32
    same = torch.equal(lufs.block_powers(xw, *geo), got)
    k["ms"] = median_ms(lambda: lufs.block_powers(xw, *geo))
    k["plain_ms"] = median_ms(lambda: lufs.block_powers_plain(xw, *geo),
                              warmup=1, runs=3)
    # a multiply and an add a sample a block
    k["bound_ms"], k["bound_by"] = roofline_ms(
        4 * ch * n + 8 * nblk, 2 * ch * block * nblk, F64_OPS_PER_S)
    print(f"phase 21: the block-power kernel (csrc/lufs_blocks.cu) on the "
          f"bus's K-weighting ({ch}, {n}), {nblk} blocks of {block} every "
          f"{hop}: {launches} launch(es); max abs {k['max_abs_err']:.3g} = "
          f"{rel:.3g} of the largest power against the float64 cumulative "
          f"sum (gate {GATE_LUFS_BLOCKS:g}; float32 sums of the same blocks "
          f"{rel32:.3g}); a second run bit for bit: {same}; kernel "
          f"{k['ms']:.4f} ms (CUDA events, median of 7), the twin (cast, "
          f"square, cumsum, cat, gather) {k['plain_ms']:.3f} ms; bound "
          f"{k['bound_ms']:.4f} ms ({k['bound_by']}: the bus read once), "
          f"{k['bound_ms'] / k['ms']:.1%} of it [{h.card}]")
    gate(launches == 1 and same and rel <= GATE_LUFS_BLOCKS < rel32,
         "the block-power kernel against the float64 cumulative sum")
    del xw, want, got


def ns_phase(h, rows: int = 32, n: int = 2646000, nfft: int = 512,
             smooth: float = 0.7, floor: float = 0.1) -> None:
    """Phase 32: the noise suppressor's Wiener kernel alone at the voice
    cell's spectra (``rows`` tracks of ``n`` samples, 0.3 x Gaussian with
    a 0.2 x 440 Hz tone past the lead-in at 44.1 kHz, through
    ``ops.ns.stft``: 32 x 10,337 x 257 complex64) and the frozen
    estimate, against its plain twin (the scan and the elementwise gain;
    gate -100 dB); its time on fresh copies of the spectra (it writes
    over them) at the card's S and across an S sweep; the twin's time;
    the kernel's bytes bound (the spectra read and written once) and
    ``roofline_ns``'s bound of the whole suppressor; ``suppress()`` at
    that shape. ``h`` holds main()'s helpers; on the CPU (``h.dev =
    torch.device("cpu")``, small sizes) both sides are the twin and the
    times read nan."""
    import torch

    from perfbench.roofline_ns import ns_stage
    from xmtpu_torch.bench import median_ms
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.ops import ns as tns

    t32 = time.perf_counter()
    dev, on_card = h.dev, h.dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(32)
    x = 0.3 * torch.randn((rows, n), generator=gen, device=dev)
    t = torch.arange(n, device=dev, dtype=torch.float32) / 44100.0
    x[:, 8000:] += 0.2 * torch.sin(2 * np.pi * 440.0 * t[8000:])
    X0 = tns.stft(x, nfft)
    del x, t
    R, T, F = X0.shape
    noise = tns.median(torch.square(torch.abs(X0[:, :8])), dim=-2)
    S = kns.wiener_segments(R, T, F, dev)
    S, L = kns.seg_plan(T, S)
    want = kns.wiener_plain(X0, noise, smooth, floor)
    Xw = X0.clone()
    h.reset_counts()
    got = kns.wiener(Xw, noise, smooth, floor)
    launches = h.counts()["ns_wiener"]
    k = h.compare("ns_wiener", "cuda" if on_card else "cpu",
                  "xmtpu_torch/csrc/ns_wiener.cu", None,
                  torch.view_as_real(got), torch.view_as_real(want))
    del got, want
    k["launches"] = launches
    if on_card and launches != (2 if S > 1 else 1):
        raise SystemExit(f"chip_smoke: the Wiener kernel launched "
                         f"{launches} passes at S = {S}")

    def kernel_ms(segments, runs: int = 7) -> float:
        """Median CUDA-event time of the kernel on a fresh copy of X0
        (the copy just before it, as the STFT writes X just before it on
        the suppressor's path)."""
        if not on_card:
            return float("nan")
        out = []
        for _ in range(runs + 2):
            Xw.copy_(X0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            kns.wiener(Xw, noise, smooth, floor, segments=segments)
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return float(np.median(out[2:]))

    k["ms"] = kernel_ms(S)
    k["plain_ms"] = (median_ms(lambda: kns.wiener_plain(X0, noise, smooth,
                                                        floor))
                     if on_card else float("nan"))
    # the spectra read once and written once, the estimate read; 14
    # float32 operations a bin (|X|^2 3, the smoothing 3, snr 3, G 3,
    # X*G 2: roofline_ns's count for these steps)
    h.bound(k, 2 * 8 * R * T * F + 4 * R * F, 14 * R * T * F)
    stage_ms, stage_by = roofline_ms(*ns_stage(R, n, nfft))
    sweep = sorted({1, 4, 8, 16, S, 2 * S, 4 * S, 8 * S} & set(range(1, T + 1)))
    swept = {kns.seg_plan(T, s_)[0]: kernel_ms(s_, runs=3) for s_ in sweep}
    x_in = tns.istft(X0, n, nfft)  # a signal whose suppress() runs here
    call_ms = (median_ms(lambda: tns.suppress(x_in, nfft, device=dev),
                         warmup=1, runs=3) if on_card else float("nan"))
    print(f"phase 32: the Wiener kernel (csrc/ns_wiener.cu) at ({R}, {T}, "
          f"{F}), S = {S} segments of {L} frames (the last "
          f"{T - (S - 1) * L}), {launches} launches: {k['rms_db']:.1f} dB "
          f"vs the twin (gate {GATE_KERNEL_DB:g}), max abs "
          f"{k['max_abs_err']:.3g}; {k['ms']:.3f} ms on fresh spectra; "
          f"bound {k['bound_ms']:.3f} ms ({k['bound_by']}: the spectra "
          f"read and written once), {k['bound_ms'] / k['ms']:.1%} of it; "
          f"the twin (scan + elementwise gain) {k['plain_ms']:.3f} ms; "
          f"roofline_ns's bound of the whole suppressor {stage_ms:.3f} ms "
          f"({stage_by}); suppress() at ({R}, {n}) {call_ms:.3f} ms; "
          "S sweep (kernel ms): "
          + ", ".join(f"{s_} {v:.3f}" for s_, v in swept.items())
          + f" [{h.card}]")
    del X0, Xw, x_in
    print(f"phase 32: {time.perf_counter() - t32:.1f} s")


def card_helpers() -> types.SimpleNamespace:
    """Phases 1 and 2 (the card, TF32 off, the kernels built) and the
    helpers every later phase takes: ``card`` (name and power limit),
    ``dev``, ``clock_hz``, ``kernels`` (the JSON line's entries),
    ``compare`` (a kernel's output against its twin's, -100 dB, appended
    to ``kernels``), ``bound``, ``reset_counts`` and ``counts`` (the twelve
    launch counters)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from xmtpu_torch.bench import rms_db
    from xmtpu_torch.kernels import _build, envelope, eq_env, fftconv, iir
    from xmtpu_torch.kernels import lufs as klufs
    from xmtpu_torch.kernels import ns as kns
    from xmtpu_torch.kernels import resample as kresample
    from xmtpu_torch.kernels import rsmix

    # 1. device
    def smi(query: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.splitlines()[0]

    card = smi("name,power.limit").strip()
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {card}; max SM clock {clock_hz / 1e6:.0f} MHz")
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    def reset_counts() -> None:
        fftconv.launches = envelope.launches = 0
        iir.launches = envelope.envelope_launches = iir.chain_launches = 0
        eq_env.launches = kresample.launches = rsmix.launches = 0
        fftconv.long_launches = envelope.gain_launches = kns.launches = 0
        klufs.launches = 0

    def counts() -> dict:
        return {"fftconv": fftconv.launches, "envelope": envelope.launches,
                "iir": iir.launches, "state_chain": iir.chain_launches,
                "envelope_seg": envelope.envelope_launches,
                "eq_env": eq_env.launches, "resample": kresample.launches,
                "rsmix": rsmix.launches,
                "fftconv_long": fftconv.long_launches,
                "gain": envelope.gain_launches, "ns_wiener": kns.launches,
                "lufs": klufs.launches}

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    lib = _build.library_path().relative_to(_build.BUILD_DIR.parent.parent)
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib})")

    kernels = []

    def compare(name, route, source, replaces, yk, yp):
        torch.cuda.synchronize()
        err = (yk - yp).double()
        db = rms_db(err.cpu().numpy(), yp.double().cpu().numpy())
        ok = bool(torch.isfinite(yk).all()) and db <= GATE_KERNEL_DB
        k = dict(name=name, route=route, source=source, replaces=replaces,
                 max_abs_err=float(err.abs().max()), rms_db=db, ok=ok,
                 library_ms=None)
        kernels.append(k)
        if not ok:
            raise SystemExit(f"chip_smoke: kernel {name} failed its check: "
                             f"{k}")
        return k

    def bound(k, n_bytes, n_ops):
        k["bound_ms"], k["bound_by"] = roofline_ms(n_bytes, n_ops)

    return types.SimpleNamespace(
        card=card, dev=torch.device("cuda"), clock_hz=clock_hz,
        kernels=kernels, compare=compare, bound=bound,
        reset_counts=reset_counts, counts=counts)


def kernels_line(kernels) -> str:
    """The JSON line of the kernels' entries, the contract's keys."""
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return json.dumps({"kernels": [{k: kk[k] for k in keys}
                                   for kk in kernels]})


def main() -> None:
    import torch

    h = card_helpers()
    card, dev, clock_hz, kernels = h.card, h.dev, h.clock_hz, h.kernels
    compare, bound = h.compare, h.bound
    reset_counts, counts = h.reset_counts, h.counts
    from xmtpu_torch import batch as tbatch
    from xmtpu_torch.bench import (back_to_back_ms, make_inputs, median_ms,
                                   replay_ms, rms_db, step_seconds)
    from xmtpu_torch.kernels import _build, _seg, envelope, eq_env, fftconv
    from xmtpu_torch.kernels import iir
    from xmtpu_torch.kernels import resample as kresample
    from xmtpu_torch.kernels import rsmix
    from xmtpu_torch.ops import convert, limiter
    from xmtpu_torch.ops import resample as tresample
    from xmtpu_torch.ops import reverb as treverb
    from xmtpu_torch.ops.resample import resample_output_len

    def chain_ms(steps: int, ops_per_step: int) -> float:
        return steps * ops_per_step * OP_LATENCY_CYCLES / clock_hz * 1e3

    def cycles_at(ms: float, steps: int) -> float:
        """Cycles per sample of a row chain that took ``ms`` for
        ``steps`` samples (every row runs at once), at the max clock."""
        return ms * 1e-3 * clock_hz / steps

    def poly_geometry_line(label, plan, n_out, query, tracks):
        """K7's / K8's tiling of this plan on this card."""
        geo = kresample.poly_geometry(plan, -(-n_out // plan.L), tracks)
        sms, per_sm = _seg.card_slots(query, dev.index or 0, geo.smem)
        print(f"{label} geometry: G = {geo.G} phases x {geo.groups} "
              f"groups, {geo.frames} frames a tile x {geo.tiles} tiles, "
              f"window pitch {geo.pitch} words, tile pitch "
              f"{geo.tile_pitch}, {geo.smem} shared bytes a block, "
              f"{per_sm} blocks per SM x {sms} SMs")

    def ptxas_line(entry):
        """The ptxas summary (stack, spills, registers) of the kernels
        whose mangled name contains ``entry``, from the build's log."""
        log = (_build.library_path().parent / "build.log").read_text()
        out, lines = [], log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and entry in ln:
                out.append(" ".join(x.strip() for x in lines[i + 2:i + 4]))
        if not out:
            raise SystemExit(f"chip_smoke: no ptxas line for {entry}")
        return " | ".join(out)

    def check_k1(name, x, h, pre_row, pre_col):
        """K1 against its twin on these operands; times; conv1d of the
        gained input as the library yardstick; roofline bound of the
        function (``fir_fft_ops``), beside the transform work the kernel
        itself does."""
        R, n = x.shape
        taps = h.shape[0]
        k_plain = fftconv.fir_convolve_plain(x, h, pre_row, pre_col)
        k = compare(name, "cuda", "xmtpu_torch/csrc/fftconv.cu",
                    "xmtpu/kernels/fftconv.py:164",
                    fftconv.fir_convolve(x, h, pre_row, pre_col), k_plain)
        k["ms"] = median_ms(
            lambda: fftconv.fir_convolve(x, h, pre_row, pre_col))
        k["plain_ms"] = median_ms(
            lambda: fftconv.fir_convolve_plain(x, h, pre_row, pre_col))
        xin = (x * pre_row[:, None] * pre_col)[:, None, :]
        w = h.flip(0)[None, None, :].contiguous()
        with tresample._cudnn_fp32():  # the same function: FP32, not TF32
            k["library_ms"] = median_ms(lambda: torch.nn.functional.conv1d(
                xin, w, padding=taps - 1), warmup=1, runs=3)
        del xin
        if taps <= fftconv.MAX_SHORT_TAPS:
            log_n = fftconv.fft_log_size(taps)
            n_fft = 1 << log_n
            hop, parts = n_fft - (taps - 1), 1
        else:  # the long form: one transform pair a frame, P products
            log_n = fftconv.LONG_LOG_N
            n_fft = 1 << log_n
            hop, parts = fftconv.LONG_HOP, fftconv.long_parts(taps)
        radices = "x".join(str(r) for r, _, _ in fftconv.fft_plan(log_n)[2])
        frames = -(-n // hop) * -(-R // 2)
        own_ops = frames * (2 * 5 * n_fft * math.log2(n_fft)
                            + (6 if parts == 1 else 8 * parts) * n_fft)
        bound(k, 4 * (2 * R * n + taps + R + n), fir_fft_ops(R, n, taps))
        print(f"K1 {name} {tuple(x.shape)} x {taps} taps ({parts} "
              f"partition{'s' if parts > 1 else ''} of {n_fft} points, "
              f"radix {radices}, {fftconv.exchanges(log_n)} shared-memory "
              f"exchanges per transform): "
              f"{k['rms_db']:.1f} dB vs plain (gate {GATE_KERNEL_DB}), "
              f"max abs {k['max_abs_err']:.3g}; kernel {k['ms']:.3f} ms, "
              f"plain {k['plain_ms']:.3f} ms, conv1d {k['library_ms']:.3f} "
              f"ms, bound {k['bound_ms']:.3f} ms ({k['bound_by']}; the "
              f"function's {fir_fft_ops(R, n, taps) / 1e9:.2f} GFLOP, the "
              f"kernel's own transforms {own_ops / 1e9:.2f} GFLOP) [{card}]")
        if taps <= fftconv.MAX_SHORT_TAPS:
            frame_sizes(x, h, pre_row, pre_col, k_plain)
        return k

    def frame_sizes(x, h, pre_row, pre_col, y_plain):
        """The short form at every transform size the IR allows, each
        gated against the twin and timed."""
        taps = h.shape[0]
        got = {}
        for log_n in range(fftconv.fft_log_size(taps),
                           fftconv.LONG_LOG_N + 1):
            def run_n(log_n=log_n):
                return fftconv._launch(x, h, pre_row, pre_col, log_n)
            db = rms_db((run_n() - y_plain).double().cpu().numpy(),
                        y_plain.double().cpu().numpy())
            if not db <= GATE_KERNEL_DB:
                raise SystemExit(f"chip_smoke: K1 at N = {1 << log_n} "
                                 f"failed its check: {db:.1f} dB")
            got[1 << log_n] = (median_ms(run_n), db)
        print(f"K1 frame size at {tuple(x.shape)} x {taps} taps: "
              + ", ".join(f"N = {k}: {t:.3f} ms ({d:.1f} dB)"
                          for k, (t, d) in got.items())
              + f"; the rule picks {1 << fftconv.fft_log_size(taps)} "
              f"[{card}]")

    step = tbatch.make_flagship_step(fused=True, device=dev)
    voice, bgm = make_inputs(BATCH, CLIP_SECONDS)
    v = torch.from_numpy(voice).to(dev)
    b = torch.from_numpy(bgm).to(dev)
    m, scale, ramp = step.front(v, b)

    # 3. K1: fftconv kernel vs its plain twin
    ir = step.ir
    R, n = m.shape
    k1 = check_k1("fftconv", m, ir, scale, ramp)
    y_plain = fftconv.fir_convolve_plain(m, ir, scale, ramp)

    # 4. K2: the fused limiter, segmented by the card's rule, vs the
    # unsegmented plain twin, on the K1 output
    x = y_plain
    init = torch.zeros((2, R), dtype=torch.float32, device=dev)
    consts = envelope.curve_consts(step.curve)
    k_rel, c_att, curve = step.k_rel, step.c_att, step.curve

    def k2_kern(segments=None):
        return envelope.limiter(x, k_rel, c_att, curve,
                                segments=segments)[0]

    def k2_plain():
        return envelope.limiter_plain(x, k_rel, c_att, consts, init)[0]

    k2 = compare("envelope", "cuda", "xmtpu_torch/csrc/envelope.cu",
                 "xmtpu/kernels/envelope.py:188", k2_kern(), k2_plain())
    k2["ms"] = median_ms(k2_kern)
    k2["plain_ms"] = median_ms(k2_plain, warmup=1, runs=5)
    # per sample: abs, mul, max, mul, fma and about a dozen curve ops
    bound(k2, 4 * (2 * R * n + 4 * R), 18 * R * n)
    # the call's parts at the rule's S, each alone on its real operands
    S2 = envelope.limiter_segments(R, n, c_att, dev)
    xs = x.reshape(R * S2, n // S2)
    zeros_a = torch.zeros((2, R * S2), device=dev)
    env0, zf_a = envelope.envelope_pass(xs, k_rel, 1.0, zeros_a,
                                        abs_detector=True)
    # pass A runs the envelope core's |x| instance: max abs 0 against its
    # twin on these operands
    abs_err = max(float((a_ - b_).abs().max()) for a_, b_ in zip(
        (env0, zf_a), envelope.envelope_plain(xs, k_rel, 1.0, zeros_a,
                                              abs_detector=True)))
    if abs_err != 0.0:
        raise SystemExit(f"chip_smoke: K3's |x| instance differs from its "
                         f"twin on K2's pass A by {abs_err}")

    def carries():
        e = envelope._chain(init[0], zf_a[0].reshape(R, S2),
                            envelope._decay(k_rel, n // S2), "max")
        e_in = e[:, :S2].reshape(R * S2)
        ktab = envelope._seg_table("ktab", envelope.seg_ktab, k_rel,
                                   n // S2, dev)
        s_in, _ = envelope._seg_e2_carries(env0, e_in, ktab, c_att,
                                           init[1], S2)
        return torch.stack([e_in, s_in])

    init_b = carries()
    # the carries' ~20 small launches are host-bound alone; their time on
    # the card is that of one CUDA-graph replay of them
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        carries()
    carries_card_ms = median_ms(graph.replay)
    def pass_a():
        return envelope.envelope_pass(xs, k_rel, 1.0, zeros_a,
                                      abs_detector=True)

    pass_a_card = replay_ms(pass_a)
    part_ms = {
        "pass A": median_ms(pass_a),
        "carries": median_ms(carries),
        "pass B": median_ms(lambda: envelope.limiter_pass(
            xs, k_rel, c_att, curve, init_b)),
    }
    unseg_ms = median_ms(lambda: k2_kern(1))
    sweep = {S: median_ms(lambda S=S: k2_kern(S)) for S in (4, 8, 16, 32)}
    print(f"K2 envelope (fused limiter) {tuple(x.shape)}, S = {S2} (the "
          f"card's rule): {k2['rms_db']:.1f} dB vs the unsegmented plain "
          f"twin (gate {GATE_KERNEL_DB}), max abs {k2['max_abs_err']:.3g}; "
          f"limiter() call {k2['ms']:.3f} ms = "
          + " + ".join(f"{k} {t:.3f}" for k, t in part_ms.items())
          + f" ms each alone (on the card as graph replays: pass A "
          f"{pass_a_card:.4f} ms, {cycles_at(pass_a_card, n // S2):.1f} "
          f"cycles per sample, max abs {abs_err:.3g} against its twin; the "
          f"carries {carries_card_ms:.3f} ms); unsegmented kernel "
          f"{unseg_ms:.3f} ms; calls at "
          + ", ".join(f"S = {S}: {t:.3f}" for S, t in sweep.items())
          + f" ms; plain {k2['plain_ms']:.1f} ms, bound "
          f"{k2['bound_ms']:.3f} ms ({k2['bound_by']}), chain "
          f"{chain_ms(n // S2, 2):.3f} ms per pass (unsegmented "
          f"{chain_ms(n, 2):.3f}) [{card}]")
    # a NaN sample in segment S2/2 of row 5: limiter() at the rule's S
    # and unsegmented must give NaN exactly where the twin does (rows
    # are independent, so the twin runs on the first 8 rows)
    t_nan = (S2 // 2) * (n // S2) + 1234
    x_nan = x.clone()
    x_nan[5, t_nan] = float("nan")
    y_nan = envelope.limiter(x_nan, k_rel, c_att, curve)[0]
    y_nan1 = envelope.limiter(x_nan[:8].contiguous(), k_rel, c_att, curve,
                              segments=1)[0]
    y_nan_p = envelope.limiter_plain(x_nan[:8].contiguous(), k_rel, c_att,
                                     consts, init[:, :8].contiguous())[0]
    torch.cuda.synchronize()
    nan_p = y_nan_p.isnan()
    ok_p = ~nan_p
    nan_ok = (bool(nan_p[5, t_nan:].all()) and int(nan_p.sum()) == n - t_nan
              and torch.equal(y_nan[:8].isnan(), nan_p)
              and torch.equal(y_nan1.isnan(), nan_p)
              and not bool(y_nan[8:].isnan().any()))
    db_nan = [rms_db((yk[ok_p] - y_nan_p[ok_p]).double().cpu().numpy(),
                     y_nan_p[ok_p].double().cpu().numpy())
              for yk in (y_nan[:8], y_nan1)]
    print(f"K2 with a NaN sample in row 5, segment {S2 // 2}: NaN in "
          f"{int(y_nan[:8].isnan().sum())} samples at S = {S2} and "
          f"{int(y_nan1.isnan().sum())} unsegmented, the twin "
          f"{int(nan_p.sum())} (masks equal: {nan_ok}); elsewhere "
          f"{db_nan[0]:.1f} / {db_nan[1]:.1f} dB vs the twin")
    if not (nan_ok and max(db_nan) <= GATE_KERNEL_DB):
        raise SystemExit("chip_smoke: K2 does not propagate NaN as its twin")
    del m, scale, ramp, x, y_plain, xs, env0, zf_a, zeros_a, init_b, graph
    del x_nan, y_nan, y_nan1, y_nan_p

    # 5. the fused flagship step, driven once with fresh launch counters
    reset_counts()
    y = step(v, b)
    torch.cuda.synchronize()
    fused_launches = counts()
    if min(fused_launches[k] for k in ("fftconv", "envelope",
                                       "envelope_seg")) < 1:
        raise SystemExit(f"chip_smoke: a kernel did not launch in the "
                         f"fused step: {fused_launches}")
    k1["launches"], k2["launches"] = (fused_launches["fftconv"],
                                      fused_launches["envelope"])
    g = math.gcd(step.sr_in, step.sr_bus)
    n_bus = resample_output_len(voice.shape[1], step.sr_bus // g, step.M)
    if tuple(y.shape) != (BATCH, n_bus) or y.dtype != torch.int16:
        raise SystemExit(f"chip_smoke: step output {tuple(y.shape)} "
                         f"{y.dtype}, expected ({BATCH}, {n_bus}) int16")
    ref = tbatch.flagship_oracle_np(voice[0], bgm[0])
    acc = rms_db(y[0].cpu().numpy().astype(np.float64) - ref, ref)
    print(f"fused step: launches {fused_launches}; clip 0 {acc:.1f} dB vs "
          f"float64 oracle (gate {GATE_CHAIN_DB})")
    if not acc <= GATE_CHAIN_DB:
        raise SystemExit("chip_smoke: fused chain accuracy gate failed")
    sec, _ = step_seconds(step, v, b, iters=10)
    print(f"fused step: {BATCH}x{CLIP_SECONDS:g} s in {sec * 1e3:.2f} ms = "
          f"{BATCH * CLIP_SECONDS / sec:.1f} audio-sec/sec [{card}]; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del step, v, b, y

    # the small-batch branch's real inputs: 32 clips, the fused=None rule
    small = tbatch.make_flagship_step(device=dev)
    voice, bgm = voice[:SMALL_BATCH], bgm[:SMALL_BATCH]
    v = torch.from_numpy(voice).to(dev)
    b = torch.from_numpy(bgm).to(dev)
    m, scale, ramp = small.front(v, b)
    x_eq = m * ramp * scale[:, None]
    R, n = x_eq.shape

    # 6. K5: the IIR kernel at the card's rule and at the JAX rule's S
    # against its plain twin; the S sweep; the state-chain kernel against
    # its torch loop; the sosfilt() call and its glue; a NaN-bearing row
    sos32 = torch.as_tensor(small.sos, dtype=torch.float32, device=dev)
    ns = sos32.shape[0]
    S = iir.sosfilt_segments(R, n, dev, ns)

    def seg_rows(S_):
        return (x_eq.reshape(R * S_, n // S_),
                torch.zeros((ns, 2, R * S_), dtype=torch.float32,
                            device=dev))

    k5 = None
    pass5 = {}  # S -> (ms, ms on the card, cycles per sample on the card)
    for S_ in (S, iir.pick_segments(R, n)):
        xs, zi0 = seg_rows(S_)
        yk, zk = iir.sosfilt_pass(xs, sos32, zi0)
        t0 = time.perf_counter()
        yp, zp = iir.sosfilt_plain(xs, sos32, zi0)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        errs5 = [float((a_ - b_).abs().max()) for a_, b_ in ((yk, yp),
                                                             (zk, zp))]
        if max(errs5) != 0.0:
            raise SystemExit(f"chip_smoke: K5 differs from its twin at S = "
                             f"{S_} (max abs y, zf: {errs5})")
        t = median_ms(lambda: iir.sosfilt_pass(xs, sos32, zi0))
        t_card = replay_ms(lambda: iir.sosfilt_pass(xs, sos32, zi0))
        pass5[S_] = (t, t_card, cycles_at(t_card, n // S_))
        if k5 is None:  # the rule's S: the kernel line's numbers
            k5 = compare("iir", "cuda", "xmtpu_torch/csrc/iir.cu",
                         "xmtpu/kernels/iir.py:37", yk, yp)
            k5["plain_ms"] = plain_s * 1e3
        k5["max_abs_err"] = max(k5["max_abs_err"], *errs5)
        del xs, yk, zk, yp, zp
    k5["ms"] = pass5[S][0]
    # the function's own bound: x in, y out, sos, zi and zf
    bound(k5, 4 * (2 * R * n + 6 * ns + 4 * ns * R), 9 * ns * R * n)
    # the S sweep: the pass; the sosfilt() call timed from the host in
    # three interleaved rounds (host-bound: its launches take longer than
    # its work on the card) and as a CUDA-graph replay (the call's time
    # on the card)
    sweep_s = (4, 8, 16, 32, 64, 128)
    call_rounds = {S_: [] for S_ in sweep_s}
    for _ in range(3):
        for S_ in sweep_s:
            call_rounds[S_].append(median_ms(
                lambda S_=S_: iir.sosfilt(small.sos, x_eq, segments=S_)))
    sweep5 = {}  # S -> (pass ms, call ms per round, call ms on the card)
    for S_ in sweep_s:
        xs, zi0 = seg_rows(S_)
        sweep5[S_] = (median_ms(lambda: iir.sosfilt_pass(xs, sos32, zi0)),
                      call_rounds[S_], replay_ms(
                          lambda S_=S_: iir.sosfilt(small.sos, x_eq,
                                                    segments=S_)))
    # the state chain at the rule's S: the kernel against its torch loop
    xs, zi0 = seg_rows(S)
    y0, zf0 = iir.sosfilt_pass(xs, sos32, zi0)
    zi3 = torch.from_numpy((0.1 * np.random.default_rng(5).standard_normal(
        (ns, 2, R))).astype(np.float32)).to(dev)
    a_t = torch.as_tensor(iir._seg_consts(small.sos, n // S)["A_seg"],
                          device=dev).T
    zin_k, z_k = iir._state_chain(zf0, zi3, a_t, S)
    zin_p, z_p = iir.state_chain_plain(zf0, zi3, a_t, S)
    torch.cuda.synchronize()
    kc = dict(name="state_chain", route="cuda",
              source="xmtpu_torch/csrc/seg_chain.cu",
              replaces="xmtpu/kernels/iir.py:304", library_ms=None,
              max_abs_err=max(float((zin_k - zin_p).abs().max()),
                              float((z_k - z_p).abs().max())))
    rel_c = kc["max_abs_err"] / max(float(zin_p.abs().max()),
                                    float(z_p.abs().max()))
    if not (rel_c <= 1e-12 and bool(torch.isfinite(zin_k).all())):
        raise SystemExit(f"chip_smoke: the state-chain kernel differs from "
                         f"its loop by {rel_c:.3g} relative")
    kernels.append(kc)
    kc["ms"] = median_ms(lambda: iir._state_chain(zf0, zi3, a_t, S))
    kc["plain_ms"] = median_ms(lambda: iir.state_chain_plain(zf0, zi3, a_t,
                                                             S))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        iir._state_chain(zf0, zi3, a_t, S)
    chain_card_ms = median_ms(graph.replay)
    D = 2 * ns
    # zf0 and zi in, A_seg, zin and the last states out; 2 D^2 float64
    # operations per segment
    kc["bound_ms"], kc["bound_by"] = roofline_ms(
        4 * D * R * (S + 1) + 8 * (D * D + D * R * (S + 1)),
        2 * D * D * R * S, F64_OPS_PER_S)
    # sosfilt() alone at the rule's S, its glue (everything but the pass:
    # the pass returns the y0 and zf0 above), alone and as a graph replay
    call_ms = median_ms(lambda: iir.sosfilt(small.sos, x_eq))

    def cached(xs_, s_, z_):
        return y0, zf0

    glue_ms = median_ms(lambda: iir.sosfilt(small.sos, x_eq, run=cached))
    iir.sosfilt(small.sos, x_eq, run=cached)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        iir.sosfilt(small.sos, x_eq, run=cached)
    glue_card_ms = median_ms(graph.replay)
    del graph, y0, zf0, zin_k, zin_p, xs
    # segmented on the kernels against the same path on the twin (full
    # length) and against the unsegmented kernel; on a 1 s prefix at S =
    # 8 against the unsegmented twin
    y_seg, zf_seg = iir.sosfilt(small.sos, x_eq)
    y_seg_p, zf_seg_p = iir.sosfilt(small.sos, x_eq, run=iir.sosfilt_plain)
    y_one = iir.sosfilt(small.sos, x_eq, segments=1)[0]
    pre = x_eq[:, :16000].contiguous()
    y_pre = iir.sosfilt(small.sos, pre, segments=8)[0]
    y_pre_p = iir.sosfilt(small.sos, pre, segments=1,
                          run=iir.sosfilt_plain)[0]
    torch.cuda.synchronize()
    twin_path_err = max(float((y_seg - y_seg_p).abs().max()),
                        float((zf_seg - zf_seg_p).abs().max()))
    db_one = rms_db((y_seg - y_one).double().cpu().numpy(),
                    y_one.double().cpu().numpy())
    db_pre = rms_db((y_pre - y_pre_p).double().cpu().numpy(),
                    y_pre_p.double().cpu().numpy())
    if not (twin_path_err == 0.0 and max(db_one, db_pre) <= GATE_KERNEL_DB):
        raise SystemExit(f"chip_smoke: segmented sosfilt failed its check "
                         f"(vs its twin path max abs {twin_path_err}; vs "
                         f"one pass {db_one:.1f} dB, on the prefix "
                         f"{db_pre:.1f} dB)")
    del y_seg, y_seg_p, y_one, pre, y_pre, y_pre_p
    # a NaN sample in segment S/2 of row 5: the kernels' path and the twin
    # path (rows are independent: the first 8 rows) give the same masks
    S_nan = iir.sosfilt_segments(8, n, dev, ns)
    t_nan = (S_nan // 2) * (n // S_nan) + 1234
    x_nan = x_eq[:8].clone()
    x_nan[5, t_nan] = float("nan")
    y_nan, zf_nan = iir.sosfilt(small.sos, x_nan)
    y_nan_p, zf_nan_p = iir.sosfilt(small.sos, x_nan, run=iir.sosfilt_plain)
    torch.cuda.synchronize()
    nan_p = y_nan_p.isnan()
    nan_ok = (torch.equal(y_nan.isnan(), nan_p)
              and torch.equal(zf_nan.isnan(), zf_nan_p.isnan())
              and bool(nan_p[5, t_nan:].all())
              and int(nan_p.sum()) == n - t_nan)
    db_nan = rms_db((y_nan[~nan_p] - y_nan_p[~nan_p]).double().cpu().numpy(),
                    y_nan_p[~nan_p].double().cpu().numpy())
    if not (nan_ok and db_nan <= GATE_KERNEL_DB):
        raise SystemExit("chip_smoke: segmented sosfilt does not propagate "
                         "NaN as its twin path")
    del x_nan, y_nan, y_nan_p, nan_p
    S_jax = iir.pick_segments(R, n)
    per_sm5 = _seg.card_slots("xm_sosfilt_blocks_per_sm", dev.index or 0,
                              ns)[1]
    print(f"K5 iir {tuple(x_eq.shape)}, {ns} sections, S = {S} (the card's "
          f"rule: {per_sm5} resident blocks per SM, "
          f"{iir.rows_per_block(ns)} rows per block): kernel vs plain max "
          f"abs {k5['max_abs_err']:.3g} (y and zf, at S = {S} and "
          f"{S_jax}); pass at S = {S} {pass5[S][0]:.4f} ms "
          f"({pass5[S][1]:.4f} ms on the card as a graph replay, "
          f"{pass5[S][2]:.1f} cycles per sample), at S = {S_jax} "
          f"{pass5[S_jax][0]:.4f} ms ({pass5[S_jax][1]:.4f} ms, "
          f"{pass5[S_jax][2]:.1f} cycles per sample); plain "
          f"{k5['plain_ms']:.1f} ms at S = {S} (one run); bound "
          f"{k5['bound_ms']:.4f} ms ({k5['bound_by']}), chain "
          f"{chain_ms(n // S, 4):.4f} ms (S = {S_jax}: "
          f"{chain_ms(n // S_jax, 4):.4f}) [{card}]")
    print("K5 S sweep (pass / sosfilt() call from the host, 3 rounds / "
          "the call as a graph replay, ms): "
          + ", ".join(f"S = {S_}: {p_:.4f} / "
                      + " ".join(f"{c_:.4f}" for c_ in cs_)
                      + f" / {g_:.4f}"
                      for S_, (p_, cs_, g_) in sweep5.items()) + f" [{card}]")
    print(f"K5 state chain ({R} rows x {S} segments, D = {D}): kernel vs "
          f"its torch loop {rel_c:.3g} relative (gate 1e-12); kernel call "
          f"{kc['ms']:.4f} ms ({chain_card_ms:.4f} ms on the card as a graph "
          f"replay), loop {kc['plain_ms']:.4f} ms ({S} steps), bound "
          f"{kc['bound_ms']:.5f} ms ({kc['bound_by']}) [{card}]")
    print(f"K5 sosfilt() call at S = {S}: {call_ms:.4f} ms; its glue "
          f"{glue_ms:.4f} ms alone, {glue_card_ms:.4f} ms on the card as a "
          f"graph replay; segmented vs its twin path max abs "
          f"{twin_path_err:.3g} (y and zf), vs one pass {db_one:.1f} dB, on "
          f"the (32, 16000) prefix at S = 8 vs the unsegmented twin "
          f"{db_pre:.1f} dB (gate {GATE_KERNEL_DB}); a NaN in row 5, segment "
          f"{S_nan // 2} of {S_nan}: masks equal {nan_ok}, elsewhere "
          f"{db_nan:.1f} dB [{card}]")

    # 7. K1 on the operands reverb() gives it on this branch, then the
    # envelope-only kernel through the segmented envelope()
    y_eq = iir.sosfilt(small.sos, x_eq)[0]
    k1s = check_k1("fftconv_unfused", y_eq, small.reverb_ir,
                   torch.ones(R, device=dev), torch.ones(n, device=dev))
    y_rev = treverb.reverb(y_eq, small.reverb_ir, wet=small.wet,
                           dry=small.dry)
    d = y_rev.abs()

    def recorded(S_=None):
        """envelope() at S_ (None: the card's rule), recording the arguments
        of its one-pass launches."""
        got = []

        def recording(*args):
            got.append(args)
            return envelope.envelope_pass(*args)

        out = envelope.envelope(d, small.k_rel, small.c_att, segments=S_,
                                run=recording)[0]
        return out, got

    S_env = envelope.envelope_segments(R, n, dev)
    e2k, passes = recorded()
    e2p, _ = envelope.envelope(d, small.k_rel, small.c_att,
                               run=envelope.envelope_plain)
    ke = compare("envelope_seg", "cuda", "xmtpu_torch/csrc/envelope.cu",
                 "xmtpu/kernels/envelope.py:108", e2k, e2p)
    rows_e, seg_e = passes[0][0].shape
    if rows_e != R * S_env:
        raise SystemExit(f"chip_smoke: envelope() ran {rows_e} rows, not "
                         f"{R} x the card's S = {S_env}")
    # each launch against its twin on its own operands (the plain and the
    # corrected instance; the |x| one on phase 4's): max abs 0
    pass_err = [max(float((a_ - b_).abs().max()) for a_, b_ in zip(
        envelope.envelope_pass(*a), envelope.envelope_plain(*a)))
        for a in passes]
    ke["max_abs_err"] = max(ke["max_abs_err"], abs_err, *pass_err)
    if ke["max_abs_err"] != 0.0:
        raise SystemExit(f"chip_smoke: the envelope core differs from its "
                         f"twin: max abs {ke['max_abs_err']} (passes "
                         f"{pass_err}, |x| {abs_err})")

    def pass_times(args_list):
        """Each launch from the host and on the card (graph replay)."""
        return ([median_ms(lambda a=a: envelope.envelope_pass(*a))
                 for a in args_list],
                [replay_ms(lambda a=a: envelope.envelope_pass(*a))
                 for a in args_list])

    pass_ms, pass_card = pass_times(passes)
    ke["ms"] = sum(pass_ms)
    ke["plain_ms"] = sum(median_ms(lambda a=a: envelope.envelope_plain(*a),
                                   warmup=0, runs=3) for a in passes)

    def env_call(S_=None):
        return envelope.envelope(d, small.k_rel, small.c_att, segments=S_)

    call_ms, call_card = median_ms(env_call), replay_ms(env_call)
    # the same launches at the JAX rule's S, and the S sweep on the card
    S_jax = envelope.pick_segments(R, n, lanes=256)
    jax_ms, jax_card = pass_times(recorded(S_jax)[1])
    sweep_e = {}
    for S_ in (8, 16, 32, 64, 128):
        sweep_e[S_] = (sum(pass_times(recorded(S_)[1])[1]),
                       replay_ms(lambda S_=S_: env_call(S_)))
    # per pass: d (or env0) in, e2 out, the correction's ktab and E
    bound(ke, 4 * (len(passes) * 2 * rows_e * seg_e + seg_e + rows_e),
          len(passes) * 5 * rows_e * seg_e)
    per_sm_e = _seg.card_slots("xm_envelope_blocks_per_sm", dev.index or 0,
                               0)[1]
    print(f"envelope_seg {tuple(d.shape)} at S = {S_env} (the card's rule: "
          f"{per_sm_e} resident blocks per SM, 32 rows per block; the JAX "
          f"rule's S = {S_jax}) as {rows_e} x {seg_e}, {len(passes)} "
          f"launches: {ke['rms_db']:.1f} dB vs the twin path (gate "
          f"{GATE_KERNEL_DB}), max abs {ke['max_abs_err']:.3g} (each "
          f"launch and the |x| instance against its twin: must be 0); "
          "launches "
          + " + ".join(f"{t:.4f}" for t in pass_ms)
          + f" = {ke['ms']:.4f} ms from the host, "
          + " + ".join(f"{t:.4f}" for t in pass_card)
          + f" = {sum(pass_card):.4f} ms on the card as graph replays ("
          + ", ".join(f"{cycles_at(t, seg_e):.1f}" for t in pass_card)
          + f" cycles per sample); envelope() call {call_ms:.3f} ms "
          f"({call_card:.4f} ms on the card); at the JAX rule's S = "
          f"{S_jax} ({R * S_jax} x {n // S_jax}): "
          + " + ".join(f"{t:.4f}" for t in jax_ms)
          + " ms from the host, "
          + " + ".join(f"{t:.4f}" for t in jax_card)
          + " ms on the card ("
          + ", ".join(f"{cycles_at(t, n // S_jax):.1f}" for t in jax_card)
          + f" cycles per sample); plain {ke['plain_ms']:.1f} ms, bound "
          f"{ke['bound_ms']:.4f} ms ({ke['bound_by']}), chain "
          f"{chain_ms(seg_e, 2) * len(passes):.4f} ms [{card}]")
    print("envelope() S sweep on the card (the two launches / the call, "
          "graph replays, ms): "
          + ", ".join(f"S = {S_}: {p_:.4f} / {c_:.4f}"
                      for S_, (p_, c_) in sweep_e.items()) + f" [{card}]")
    print("K3 ptxas (plain | corrected | |x|): " + " | ".join(
        ptxas_line(f"row_envelope_kernelILb0EL{k}") for k in
        ("b0ELb0E", "b1ELb0E", "b0ELb1E")))
    del d, e2p, passes

    # 8. the unfused small-batch step, driven once with fresh counters
    reset_counts()
    y = small(v, b)
    torch.cuda.synchronize()
    small_launches = counts()
    if min(small_launches[k] for k in ("fftconv", "iir", "state_chain",
                                       "envelope_seg")) < 1:
        raise SystemExit(f"chip_smoke: a kernel did not launch in the "
                         f"small-batch step: {small_launches}")
    k1s["launches"] = small_launches["fftconv"]
    k5["launches"] = small_launches["iir"]
    kc["launches"] = small_launches["state_chain"]
    ke["launches"] = small_launches["envelope_seg"]
    if tuple(y.shape) != (SMALL_BATCH, n_bus) or y.dtype != torch.int16:
        raise SystemExit(f"chip_smoke: small step output {tuple(y.shape)}")
    acc = rms_db(y[0].cpu().numpy().astype(np.float64) - ref, ref)
    print(f"small-batch step: launches {small_launches}; clip 0 {acc:.1f} "
          f"dB vs float64 oracle (gate {GATE_CHAIN_DB})")
    if not acc <= GATE_CHAIN_DB:
        raise SystemExit("chip_smoke: small-batch accuracy gate failed")
    sec, _ = step_seconds(small, v, b, iters=10)
    stages = {  # the unfused forward's stages, on their real inputs
        "front": median_ms(lambda: small.front(v, b)),
        "fade+gain": median_ms(lambda: m * ramp * scale[:, None]),
        "eq": median_ms(lambda: iir.sosfilt(small.sos, x_eq)),
        "reverb": median_ms(lambda: treverb.reverb(
            y_eq, small.reverb_ir, wet=small.wet, dry=small.dry)),
        "envelope": median_ms(lambda: envelope.envelope(
            y_rev.abs(), small.k_rel, small.c_att)),
        "curve": median_ms(lambda: limiter.apply_gain_curve(
            y_rev[:, None, :], e2k, small.curve[0])),
        "convert": median_ms(lambda: convert.f32_to_pcm16(y_rev)),
    }
    print(f"small-batch step: {SMALL_BATCH}x{CLIP_SECONDS:g} s in "
          f"{sec * 1e3:.2f} ms = {SMALL_BATCH * CLIP_SECONDS / sec:.1f} "
          f"audio-sec/sec [{card}]; stages (ms, each alone): "
          + ", ".join(f"{k} {t:.3f}" for k, t in stages.items()))

    del small, m, scale, ramp, x_eq, y_eq, y_rev, e2k, v, b, y

    def drive(label, run, args, need, clip0_ref, audio_s):
        """One run of a step with fresh counters: the kernels in
        ``need`` must launch; clip 0's first len(clip0_ref) samples
        against the oracle; then throughput."""
        reset_counts()
        out = run(*args)
        torch.cuda.synchronize()
        got = counts()
        if any(got[k] < 1 for k in need):
            raise SystemExit(f"chip_smoke: a kernel did not launch in the "
                             f"{label}: {got}")
        y0 = out[0, :len(clip0_ref)].cpu().numpy().astype(np.float64)
        db = rms_db(y0 - clip0_ref, clip0_ref)
        print(f"{label}: launches {got}; clip 0 {db:.1f} dB vs float64 "
              f"oracle (gate {GATE_CHAIN_DB})")
        if not db <= GATE_CHAIN_DB:
            raise SystemExit(f"chip_smoke: {label} accuracy gate failed")
        sec, _ = step_seconds(run, *args, iters=10)
        print(f"{label}: {tuple(out.shape)} in {sec * 1e3:.2f} ms = "
              f"{audio_s / sec:.1f} audio-sec/sec [{card}]")
        return out, got

    voice, bgm = make_inputs(BATCH, CLIP_SECONDS)
    v = torch.from_numpy(voice).to(dev)
    b = torch.from_numpy(bgm).to(dev)
    audio_s = BATCH * CLIP_SECONDS

    # 9. K6 on the unfolded fused branch's real input: the one-pass
    # kernel against its twin on a prefix, the segmented eq_env() call at
    # the card's rule against the same path on the twins, then that step
    nf = tbatch.make_flagship_step(fused=True, lti_fold=False, device=dev)
    m, scale, ramp = nf.front(v, b)
    x6 = treverb.reverb(m * ramp, nf.reverb_ir, wet=nf.wet, dry=nf.dry,
                        prescale=scale[:, None])
    R, n = x6.shape
    k_rel, c_att = nf.k_rel, nf.c_att
    sos32 = torch.as_tensor(nf.sos, dtype=torch.float32, device=dev)
    ns = sos32.shape[0]
    zi0 = torch.zeros((ns, 2, R), dtype=torch.float32, device=dev)
    ei0 = torch.zeros((2, R), dtype=torch.float32, device=dev)
    pre = x6[:, :16000].contiguous()
    out_k = eq_env.eq_env_pass(pre, sos32, zi0, ei0, k_rel, c_att)
    t0 = time.perf_counter()
    out_p = eq_env.eq_env_plain(pre, sos32, zi0, ei0, k_rel, c_att)
    torch.cuda.synchronize()
    plain_pre_s = time.perf_counter() - t0
    errs = [float((a - c).abs().max()) for a, c in zip(out_k, out_p)]
    if max(errs) != 0.0:
        raise SystemExit(f"chip_smoke: eq_env kernel differs from its twin "
                         f"(max abs y, e2, zf, ef: {errs})")
    # segmented (S = 4) on the prefix against the one-pass twin
    seg_pre = eq_env.eq_env(nf.sos, pre, k_rel, c_att, segments=4)
    db_pre = [rms_db((seg_pre[k] - out_p[k]).double().cpu().numpy(),
                     out_p[k].double().cpu().numpy()) for k in (0, 1)]
    if not max(db_pre) <= GATE_KERNEL_DB:
        raise SystemExit(f"chip_smoke: segmented eq_env vs the one-pass "
                         f"twin {db_pre} dB")
    del pre, out_k, out_p, seg_pre

    S6 = eq_env.eq_env_segments(R, n, c_att, dev, ns)

    def k6_kern(segments=None):
        return eq_env.eq_env(nf.sos, x6, k_rel, c_att, segments=segments)

    out6 = k6_kern()
    t0 = time.perf_counter()
    out6_p = eq_env.eq_env(nf.sos, x6, k_rel, c_att, run=eq_env.TWINS)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    k6 = compare("eq_env", "cuda", "xmtpu_torch/csrc/eq_env.cu",
                 "xmtpu/kernels/eq_env.py:48", out6[0], out6_p[0])
    flat, flat_p = ([o[0], o[1], o[2], *o[3]] for o in (out6, out6_p))
    errs6 = [float((a - c).abs().max()) for a, c in zip(flat, flat_p)]
    db_e2 = rms_db((out6[1] - out6_p[1]).double().cpu().numpy(),
                   out6_p[1].double().cpu().numpy())
    k6["max_abs_err"] = max(errs6 + errs)
    if not (db_e2 <= GATE_KERNEL_DB and bool(torch.isfinite(out6[1]).all())):
        raise SystemExit(f"chip_smoke: segmented eq_env's e2 vs its twin "
                         f"path {db_e2:.1f} dB")
    del out6_p, flat_p
    k6["ms"] = median_ms(k6_kern)
    k6["plain_ms"] = twin_s * 1e3
    # the function's own bound: x in, y and e2 out; per sample 9
    # operations per section and 4 of the envelope
    bound(k6, 4 * (3 * R * n + 6 * ns + 2 * (2 * ns + 2) * R),
          (9 * ns + 4) * R * n)
    # the call's parts at the rule's S, each alone on its real operands
    seglen = n // S6
    xs6 = x6.reshape(R * S6, seglen)
    z0 = torch.zeros((ns, 2, R * S6), dtype=torch.float32, device=dev)
    e0 = torch.zeros((2, R * S6), dtype=torch.float32, device=dev)
    zf0 = eq_env.eq_env_pass(xs6, sos32, z0, e0, k_rel, c_att,
                             finals_only=True)[2]
    a_t = torch.as_tensor(iir._seg_consts(nf.sos, seglen)["A_seg"],
                          device=dev).T

    # the state-chain kernel against its torch loop on K6's own finals
    # (R x S6 segments): the twin path's comparison above runs the kernel
    # on both sides
    chain6 = [iir._state_chain(zf0, zi0, a_t, S6),
              iir.state_chain_plain(zf0, zi0, a_t, S6)]
    torch.cuda.synchronize()
    rel6 = max(float((a - c).abs().max()) / float(c.abs().max())
               for a, c in zip(*chain6))
    if not (rel6 <= 1e-12 and bool(torch.isfinite(chain6[0][0]).all())):
        raise SystemExit(f"chip_smoke: the state-chain kernel differs from "
                         f"its loop on K6's finals by {rel6:.3g} relative")
    kc["max_abs_err"] = max(kc["max_abs_err"], *(
        float((a - c).abs().max()) for a, c in zip(*chain6)))
    del chain6

    def state_chain():
        zin, _ = iir._state_chain(zf0, zi0, a_t, S6)
        return zin.reshape(R * S6, ns, 2).permute(1, 2, 0).float(
            ).contiguous()

    zin32 = state_chain()
    _, env0, _, ef_a = eq_env.eq_env_pass(xs6, sos32, zin32, e0, k_rel, 1.0)
    _, e_in, ktab = envelope._seg_max_carries(
        ei0[0], ef_a[0].reshape(R, S6), k_rel, seglen)
    e2b, zf_b = envelope.envelope_pass(env0, 0.0, c_att, e0, ktab, e_in)

    def carries():  # the state chain, the max chain, the e2 sum chain
        state_chain()
        envelope._seg_max_carries(ei0[0], ef_a[0].reshape(R, S6), k_rel,
                                  seglen)
        s6 = envelope._chain(ei0[1], zf_b[1].reshape(R, S6),
                             envelope._decay(1.0 - np.float32(c_att),
                                             seglen), "sum")
        atab = envelope._seg_table("atab", envelope.seg_atab, c_att, seglen,
                                   dev)
        e2b[:, :atab.shape[0]] += s6[:, :S6].reshape(R * S6, 1) * atab

    carries()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        carries()
    carries6_card_ms = median_ms(graph.replay)
    part6_ms = {
        "pass 0": median_ms(lambda: eq_env.eq_env_pass(
            xs6, sos32, z0, e0, k_rel, c_att, finals_only=True)),
        "pass A": median_ms(lambda: eq_env.eq_env_pass(
            xs6, sos32, zin32, e0, k_rel, 1.0)),
        "carries": median_ms(carries),
        "pass B": median_ms(lambda: envelope.envelope_pass(
            env0, 0.0, c_att, e0, ktab, e_in)),
    }
    # pass B, the envelope core's corrected instance, on the card
    pass_b6_card = replay_ms(lambda: envelope.envelope_pass(
        env0, 0.0, c_att, e0, ktab, e_in))
    del env0, e2b, zf_b, graph
    unseg6_ms = median_ms(lambda: k6_kern(1))
    sweep6 = {S: median_ms(lambda S=S: k6_kern(S)) for S in (4, 8, 16, 32)}
    # pass A with 1, 2 and 4 blocks of 32 segment rows per SM: does a
    # chain warp slow down when others share its SM?
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_sm = {k: k * sms * 32 for k in (1, 2, 4)}
    big = xs6.repeat(-(-rows_sm[4] // xs6.shape[0]), 1)[:rows_sm[4]]
    per_sm_ms = {
        k: median_ms(lambda r=r: eq_env.eq_env_pass(
            big[:r], sos32,
            torch.zeros((ns, 2, r), dtype=torch.float32, device=dev),
            torch.zeros((2, r), dtype=torch.float32, device=dev), k_rel,
            1.0))
        for k, r in rows_sm.items()}
    del big
    per_sm6 = _seg.card_slots("xm_eq_env_blocks_per_sm", dev.index or 0,
                              ns)[1]
    print(f"K6 eq_env {tuple(x6.shape)}, {ns} sections, S = {S6} (the "
          f"card's rule, {per_sm6} resident blocks per SM): segmented vs "
          f"its twin path max abs (y, e2, zf, env, e2 last) {errs6}, y "
          f"{k6['rms_db']:.1f} dB, e2 {db_e2:.1f} dB (gate "
          f"{GATE_KERNEL_DB}); the state-chain kernel vs its loop on K6's "
          f"finals ({R} x {S6}) {rel6:.3g} relative (gate 1e-12); on the "
          f"(256, 16000) "
          f"prefix the one-pass kernel vs its twin max abs (y, e2, zf, ef) "
          f"{errs}, segmented (S = 4) vs the one-pass twin y "
          f"{db_pre[0]:.1f}, e2 {db_pre[1]:.1f} dB; eq_env() call "
          f"{k6['ms']:.3f} ms = "
          + " + ".join(f"{k} {t:.3f}" for k, t in part6_ms.items())
          + f" ms each alone (on the card as graph replays: pass B "
          f"{pass_b6_card:.4f} ms, {cycles_at(pass_b6_card, seglen):.1f} "
          f"cycles per sample; the carries {carries6_card_ms:.3f} ms); "
          f"one-pass kernel {unseg6_ms:.3f} ms; "
          "calls at "
          + ", ".join(f"S = {S}: {t:.3f}" for S, t in sweep6.items())
          + " ms; pass A at 1, 2, 4 blocks per SM ("
          + ", ".join(str(r) for r in rows_sm.values()) + " rows): "
          + ", ".join(f"{t:.3f}" for t in per_sm_ms.values())
          + f" ms; the twin path {k6['plain_ms']:.1f} ms (one run; the "
          f"one-pass twin {plain_pre_s * 1e3:.1f} ms on the prefix), bound "
          f"{k6['bound_ms']:.4f} ms ({k6['bound_by']}), chain "
          f"{chain_ms(seglen, 4):.3f} ms per pass (unsegmented "
          f"{chain_ms(n, 4):.3f}) [{card}]")
    y6, e26 = out6[0], out6[1]
    del out6, flat, xs6, z0, e0, zf0, zin32, ef_a, e_in
    y, got = drive("unfolded fused step (lti_fold=False)", nf, (v, b),
                   ("fftconv", "eq_env", "state_chain", "envelope_seg"), ref,
                   audio_s)
    k6["launches"] = got["eq_env"]
    stages = {  # the unfolded branch's stages, on their real inputs
        "front": median_ms(lambda: nf.front(v, b)),
        "fade": median_ms(lambda: m * ramp),
        "reverb": median_ms(lambda: treverb.reverb(
            m * ramp, nf.reverb_ir, wet=nf.wet, dry=nf.dry,
            prescale=scale[:, None])),
        "eq_env": k6["ms"],
        "curve": median_ms(lambda: limiter.apply_gain_curve(
            y6[:, None, :], e26, nf.curve[0])),
        "convert": median_ms(lambda: convert.f32_to_pcm16(y6)),
    }
    print("unfolded fused step: stages (ms, each alone): "
          + ", ".join(f"{k} {t:.3f}" for k, t in stages.items()))
    del nf, y, x6, y6, e26, m, scale, ramp

    # 10. K7 on the two-track front's real input, then the "pallas" step
    pal = tbatch.make_flagship_step(fused=True, resample_backend="pallas",
                                    device=dev)
    x7 = convert.pcm16_to_f32(torch.cat([v, b], 0))
    R, n = x7.shape
    plan = tresample.make_plan(pal.L, pal.M, 24, 9.0)
    n_out = resample_output_len(n, plan.L, plan.M)
    k7 = compare("resample", "cuda", "xmtpu_torch/csrc/resample.cu",
                 "xmtpu/kernels/resample.py:37",
                 kresample.resample(x7, pal.sr_in, pal.sr_bus),
                 tresample.polyphase_resample(x7, pal.sr_in, pal.sr_bus))
    k7["ms"] = median_ms(lambda: kresample.resample(x7, pal.sr_in,
                                                    pal.sr_bus))
    k7_b2b = back_to_back_ms(lambda: kresample.resample(x7, pal.sr_in,
                                                        pal.sr_bus))
    k7["plain_ms"] = median_ms(lambda: tresample.polyphase_resample(
        x7, pal.sr_in, pal.sr_bus))
    # the library yardstick: frames (R, nj, width) as a strided view of
    # the padded input times the dense band (width, L), one matmul
    nj = -(-n_out // plan.L)
    need = (nj + 2) * plan.M + plan.width
    xs = torch.nn.functional.pad(x7, (plan.pad_left, need))[
        :, plan.base:plan.base + need].contiguous()
    frames = xs.as_strided((R, nj, plan.width), (xs.stride(0), plan.M, 1))
    hbank = torch.as_tensor(plan.hbank, dtype=torch.float32, device=dev)
    k7["library_ms"] = median_ms(lambda: torch.matmul(frames, hbank),
                                 warmup=1, runs=3)
    bound(k7, 4 * (R * n + R * n_out + plan.L * plan.K2),
          2 * plan.K2 * R * n_out)
    print(f"K7 resample {tuple(x7.shape)} -> ({R}, {n_out}): "
          f"{k7['rms_db']:.1f} dB vs plain (gate {GATE_KERNEL_DB}), max abs "
          f"{k7['max_abs_err']:.3g}; kernel {k7['ms']:.3f} ms "
          f"({k7_b2b:.3f} ms a call back to back), plain "
          f"{k7['plain_ms']:.3f} ms, dense banded matmul "
          f"{k7['library_ms']:.3f} ms, bound {k7['bound_ms']:.4f} ms "
          f"({k7['bound_by']}) [{card}]")
    # the same rows read as 48 kHz audio, to 44.1 kHz (M = 160)
    k7m = compare("resample_m160", "cuda", "xmtpu_torch/csrc/resample.cu",
                  "xmtpu/kernels/resample.py:37",
                  kresample.resample(x7, 48000, 44100),
                  tresample.polyphase_resample(x7, 48000, 44100))
    kernels.remove(k7m)  # K7 again, off the main path: its text line only
    plan_m = tresample.make_plan(147, 160, 24, 9.0)
    n_out_m = resample_output_len(n, 147, 160)
    k7m_ms = median_ms(lambda: kresample.resample(x7, 48000, 44100))
    k7m_b2b = back_to_back_ms(lambda: kresample.resample(x7, 48000, 44100))
    bound(k7m, 4 * (R * n + R * n_out_m + plan_m.L * plan_m.K2),
          2 * plan_m.K2 * R * n_out_m)
    print(f"K7 resample {tuple(x7.shape)} 48k -> 44.1k (L = 147, M = 160) "
          f"-> ({R}, {n_out_m}): {k7m['rms_db']:.1f} dB vs plain (gate "
          f"{GATE_KERNEL_DB}), max abs {k7m['max_abs_err']:.3g}; kernel "
          f"{k7m_ms:.3f} ms ({k7m_b2b:.3f} back to back), bound "
          f"{k7m['bound_ms']:.4f} ms "
          f"({k7m['bound_by']}) [{card}]")
    poly_geometry_line("K7", plan, n_out, "xm_resample_blocks_per_sm", 1)
    poly_geometry_line("K7 at M = 160", plan_m, n_out_m,
                       "xm_resample_blocks_per_sm", 1)
    print("K7 ptxas: " + ptxas_line("polyphase_kernelINS_8F32Track"))
    del x7, xs, frames
    y, got = drive("pallas-front fused step", pal, (v, b),
                   ("resample", "fftconv", "envelope", "envelope_seg"), ref,
                   audio_s)
    k7["launches"] = got["resample"]
    front_ms = {"pallas": median_ms(lambda: pal.front(v, b))}
    del pal, y

    # 11. K8 on the real int16 tracks, then the "rsmix" step
    rsm = tbatch.make_flagship_step(fused=True, resample_backend="rsmix",
                                    device=dev)
    R, n = v.shape
    n_out = (n // plan.M) * plan.L
    k8 = compare("rsmix", "cuda", "xmtpu_torch/csrc/rsmix.cu",
                 "xmtpu/kernels/rsmix.py:52",
                 rsmix.resample_mix(v, b, rsm.sr_in, rsm.sr_bus,
                                    rsm.bgm_gain, rsm.fade),
                 rsmix.resample_mix_plain(v, b, plan, rsm.bgm_gain,
                                          rsm.fade))
    k8["ms"] = median_ms(lambda: rsmix.resample_mix(
        v, b, rsm.sr_in, rsm.sr_bus, rsm.bgm_gain, rsm.fade))
    k8_b2b = back_to_back_ms(lambda: rsmix.resample_mix(
        v, b, rsm.sr_in, rsm.sr_bus, rsm.bgm_gain, rsm.fade))
    k8["plain_ms"] = median_ms(lambda: rsmix.resample_mix_plain(
        v, b, plan, rsm.bgm_gain, rsm.fade))
    # two int16 tracks in, the float32 mix out; 2 FIRs of K2 taps and
    # the ramp and mix per output
    bound(k8, 2 * 2 * R * n + 4 * R * n_out + 4 * plan.L * plan.K2,
          (4 * plan.K2 + 8) * R * n_out)
    print(f"K8 rsmix 2 x {tuple(v.shape)} int16 -> ({R}, {n_out}): "
          f"{k8['rms_db']:.1f} dB vs plain (gate {GATE_KERNEL_DB}), max abs "
          f"{k8['max_abs_err']:.3g}; kernel {k8['ms']:.3f} ms "
          f"({k8_b2b:.3f} ms a call back to back), plain "
          f"{k8['plain_ms']:.3f} ms, no single library call, bound "
          f"{k8['bound_ms']:.4f} ms ({k8['bound_by']}) [{card}]")
    poly_geometry_line("K8", plan, n_out, "xm_rsmix_blocks_per_sm", 2)
    # a 48 kHz prefix the gate takes (2,752 frames of 160), to 44.1 kHz
    n_m = 160 * 2752
    vm, bm = v[:, :n_m].contiguous(), b[:, :n_m].contiguous()
    k8m = compare("rsmix_m160", "cuda", "xmtpu_torch/csrc/rsmix.cu",
                  "xmtpu/kernels/rsmix.py:52",
                  rsmix.resample_mix(vm, bm, 48000, 44100, rsm.bgm_gain,
                                     rsm.fade),
                  rsmix.resample_mix_plain(vm, bm, plan_m, rsm.bgm_gain,
                                           rsm.fade))
    kernels.remove(k8m)  # K8 again, off the main path: its text line only
    n_out_m = 2752 * 147
    k8m_ms = median_ms(lambda: rsmix.resample_mix(
        vm, bm, 48000, 44100, rsm.bgm_gain, rsm.fade))
    k8m_b2b = back_to_back_ms(lambda: rsmix.resample_mix(
        vm, bm, 48000, 44100, rsm.bgm_gain, rsm.fade))
    bound(k8m, 2 * 2 * R * n_m + 4 * R * n_out_m + 4 * plan_m.L * plan_m.K2,
          (4 * plan_m.K2 + 8) * R * n_out_m)
    print(f"K8 rsmix 2 x ({R}, {n_m}) int16 48k -> 44.1k -> ({R}, "
          f"{n_out_m}): {k8m['rms_db']:.1f} dB vs plain (gate "
          f"{GATE_KERNEL_DB}), max abs {k8m['max_abs_err']:.3g}; kernel "
          f"{k8m_ms:.3f} ms ({k8m_b2b:.3f} back to back), bound "
          f"{k8m['bound_ms']:.4f} ms "
          f"({k8m['bound_by']}) [{card}]")
    poly_geometry_line("K8 at M = 160", plan_m, n_out_m,
                       "xm_rsmix_blocks_per_sm", 2)
    print("K8 ptxas: " + ptxas_line("polyphase_kernelINS_13I16PairTracks"))
    del vm, bm
    y, got = drive("rsmix-front fused step", rsm, (v, b),
                   ("rsmix", "fftconv", "envelope", "envelope_seg"), ref,
                   audio_s)
    k8["launches"] = got["rsmix"]
    # the three fronts of the fused step (mix, resample, fade, normalize),
    # each alone on the same 256 clips, in one call
    front_ms["rsmix"] = median_ms(lambda: rsm.front(v, b))
    mix1st = tbatch.make_flagship_step(fused=True, device=dev)
    front_ms["mixfirst"] = median_ms(lambda: mix1st.front(v, b))
    print("fused step fronts (ms, each alone, 256 x 10 s): "
          + ", ".join(f"{k} {t:.3f}" for k, t in front_ms.items())
          + f" [{card}]")
    del rsm, mix1st, y, v, b

    # 12. the ragged batch step: 64 clips of 5-10 s padded to 10 s
    voice, bgm = make_inputs(RAGGED_BATCH, CLIP_SECONDS)
    n_in = voice.shape[1]
    lengths = np.random.default_rng(64).integers(n_in // 2, n_in + 1,
                                                 RAGGED_BATCH)
    for i, ln in enumerate(lengths):
        voice[i, ln:] = 0
        bgm[i, ln:] = 0
    args = (torch.from_numpy(voice).to(dev), torch.from_numpy(bgm).to(dev),
            torch.from_numpy(lengths).to(dev))
    ln0 = int(lengths[0])
    ref0 = tbatch.flagship_oracle_np(voice[0, :ln0], bgm[0, :ln0])
    # the branch the auto rule picks at 64 rows, then both fused branches
    for kw, need in (({}, ("iir", "state_chain", "fftconv", "envelope_seg")),
                     ({"fused": True}, ("fftconv", "envelope_seg")),
                     ({"fused": True, "lti_fold": False},
                      ("fftconv", "eq_env", "state_chain", "envelope_seg"))):
        rag = tbatch.make_batch_step(device=dev, **kw)
        opts = "".join(f", {k}={val}" for k, val in kw.items())
        label = f"ragged batch step ({RAGGED_BATCH} clips{opts})"
        y, got = drive(label, rag, args, need, ref0,
                       float(lengths.sum()) / rag.sr_in)
        out_len = torch.from_numpy(-(-lengths * rag.L // rag.M)).to(dev)
        past = (torch.arange(y.shape[1], device=dev)[None, :]
                >= out_len[:, None])
        n_past = int(past.sum())
        if bool((y[past] != 0).any()):
            raise SystemExit(f"chip_smoke: the {label} wrote past a clip's "
                             "length")
        print(f"{label}: lengths {int(lengths.min())}-"
              f"{int(lengths.max())} samples; all {n_past} samples past the "
              "clips' lengths are 0")
        del rag, y
    del args

    # 13. K1's long-IR form at config 3's operands: the folded IR over
    # the 32 channel rows of the JAX benchmark's input
    import xmtpu_torch
    from xmtpu_torch import api, effects
    from xmtpu_torch.bench import config3_chain, config3_inputs
    from xmtpu_torch.graph import fx as tfx
    from xmtpu_torch.ops import biquad as tbiquad

    SR3 = 48000
    x3, chain3 = config3_inputs()
    B3, n3, C3 = x3.shape
    xd3 = torch.from_numpy(x3).to(dev)
    folded = tfx.build_chain(SR3, chain3)[0]  # ConvLimiterFx
    h3 = torch.from_numpy(folded.conv.ir).to(dev)
    rows3 = xd3.transpose(1, 2).reshape(B3 * C3, n3).contiguous()
    ones_r = torch.ones(B3 * C3, device=dev)
    ones_n = torch.ones(n3, device=dev)
    k1l = check_k1("fftconv_long", rows3, h3, ones_r, ones_n)

    # 14. K4', the gain form, through the linked limiter at config 3's
    # detector (the K1 output, channel-linked)
    w3 = fftconv.fir_convolve_plain(rows3, h3, ones_r, ones_n).reshape(
        B3, C3, n3)
    del rows3
    k_rel3 = limiter._release_coeff(folded.lim.kw["release_ms"], SR3)
    c_att3 = limiter._attack_coeff(folded.lim.kw["attack_ms"], SR3)
    thr3 = folded.lim.kw["threshold_db"]
    passes4 = []

    def recording4(*args, **kw):
        passes4.append((args, kw))
        return envelope.envelope_pass(*args, **kw)

    yk4, stk4 = envelope.linked_limiter(w3, k_rel3, c_att3, thr3,
                                        run=recording4)
    yp4, stp4 = envelope.linked_limiter(w3, k_rel3, c_att3, thr3,
                                        run=envelope.envelope_plain)
    k4 = compare("envelope_gain", "cuda", "xmtpu_torch/csrc/envelope.cu",
                 "xmtpu/kernels/envelope.py:590", yk4, yp4)
    st_db = [rms_db((a - b).double().cpu().numpy(),
                    b.double().cpu().numpy()) for a, b in zip(stk4, stp4)]
    if not max(st_db) <= GATE_KERNEL_DB:
        raise SystemExit(f"chip_smoke: the linked limiter's states failed "
                         f"their check: {st_db} dB")
    (a_args, a_kw), (b_args, b_kw) = passes4
    rows4, seg4 = a_args[0].shape
    S4 = envelope.linked_segments(B3, n3, c_att3, dev)
    if rows4 != B3 * S4:
        raise SystemExit(f"chip_smoke: linked_limiter() ran {rows4} rows, "
                         f"not {B3} x the card's S = {S4}")
    pass_ms = [median_ms(lambda a=a, kw=kw: envelope.envelope_pass(*a, **kw))
               for a, kw in passes4]
    pass_card = [replay_ms(lambda a=a, kw=kw: envelope.envelope_pass(*a,
                                                                     **kw))
                 for a, kw in passes4]
    k4["ms"] = pass_ms[1]  # the gain-form launch (pass A is K3's form)
    t0 = time.perf_counter()
    envelope.envelope_plain(*b_args, **b_kw)
    torch.cuda.synchronize()
    k4["plain_ms"] = (time.perf_counter() - t0) * 1e3

    def linked_call():
        return envelope.linked_limiter(w3, k_rel3, c_att3, thr3)

    call_ms, call_card = median_ms(linked_call), replay_ms(linked_call)
    # the gain-form pass: env0 in, g out, ktab, E and the init; per
    # sample the correction's multiply and max, 4 recurrence operations
    # and about a dozen of the curve's
    bound(k4, 4 * (2 * rows4 * seg4 + seg4 + 3 * rows4),
          18 * rows4 * seg4)
    per_sm4 = _seg.card_slots("xm_envelope_blocks_per_sm", dev.index or 0,
                              1)[1]
    print(f"K4' envelope_gain: linked limiter {tuple(w3.shape)} at S = "
          f"{S4} (the card's rule: {per_sm4} resident blocks per SM, 32 "
          f"rows per block, segments of at least "
          f"{envelope.carry_min_seglen(c_att3, n3)}; the JAX rule's S = "
          f"{envelope.pick_segments(B3, n3, lanes=256)}) as {rows4} x "
          f"{seg4}: y {k4['rms_db']:.1f} dB, states {st_db[0]:.1f} / "
          f"{st_db[1]:.1f} dB vs the twin path (gate {GATE_KERNEL_DB}), max "
          f"abs {k4['max_abs_err']:.3g}; pass A (K3) {pass_ms[0]:.4f} ms + "
          f"gain-form pass B {pass_ms[1]:.4f} ms from the host, "
          f"{pass_card[0]:.4f} + {pass_card[1]:.4f} ms on the card as graph "
          f"replays ({cycles_at(pass_card[0], seg4):.1f}, "
          f"{cycles_at(pass_card[1], seg4):.1f} cycles per sample); "
          f"linked_limiter() call {call_ms:.3f} ms ({call_card:.4f} ms on "
          f"the card); plain pass B {k4['plain_ms']:.1f} ms (one run), "
          f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}), chain "
          f"{chain_ms(seg4, 2):.4f} ms per pass [{card}]")
    print("K4' ptxas (gain | gain, corrected): " + " | ".join(
        ptxas_line(f"row_envelope_kernelILb1EL{k}") for k in
        ("b0ELb0E", "b1ELb0E")))
    del w3, yk4, yp4, passes4, a_args, b_args

    # 15. config 3 through the public entry: the JAX benchmark's chain,
    # then with the linked (gain-form) limiter; clip 0's first 2 s
    # against the float64 oracle
    pre = 2 * SR3
    x0 = x3[0, :pre].T.astype(np.float64)  # (ch, n)
    ref3, _ = tbiquad.sosfilt_np(
        tfx.build_chain(SR3, chain3, fold=False)[0].sos, x0)
    ref3 = treverb.reverb_np(ref3, chain3[1]["params"]["ir"], wet=0.3,
                             dry=0.7)
    ref3 = limiter.limiter_np(ref3, SR3)[0].T  # (n, ch)
    for linked, need in ((False, ("fftconv_long", "envelope_seg")),
                         (True, ("fftconv_long", "gain"))):
        chain = config3_chain(SR3, linked_fuse=linked)

        def run3(x, chain=chain):
            return effects(x, SR3, chain, device=dev, device_out=True)

        label = "config 3 effects" + (" (linked_fuse)" if linked else "")
        y3, got = drive(label, run3, (xd3,), need, ref3, B3 * n3 / SR3)
        if tuple(y3.shape) != x3.shape or y3.dtype != torch.float32:
            raise SystemExit(f"chip_smoke: {label} output "
                             f"{tuple(y3.shape)} {y3.dtype}")
        if linked:
            k4["launches"] = got["gain"]
        else:
            k1l["launches"] = got["fftconv_long"]
        # the chain's stages, each alone on its real input
        (node,) = tfx.get_compiled_chain(SR3, chain)  # ConvLimiterFx
        xt3 = api._to_f32_device(xd3, dev)[0]
        wt3 = node.conv.apply(xt3, None)[0]
        yt3 = node.lim.apply(wt3, None)[0]
        stages = {
            "layout in": median_ms(lambda: api._to_f32_device(xd3, dev)),
            "eq+reverb (K1 long)": median_ms(
                lambda: node.conv.apply(xt3, None)),
            "limiter": median_ms(lambda: node.lim.apply(wt3, None)),
            "layout out": median_ms(lambda: api._from_f32_device(
                yt3, False, False, to_host=False)),
        }
        print(f"{label}: stages (ms, each alone): "
              + ", ".join(f"{k} {t:.3f}" for k, t in stages.items())
              + f" [{card}]")
        del y3, xt3, wt3, yt3
    del xd3

    # 16. K7's non-finite masks: NaN, +inf and -inf at frame interiors,
    # frame edges and the band's reach into the neighbour frames, in both
    # of the twin's branches, at 44.1k -> 16k and 48k -> 44.1k
    def nonfinite_rows(R, n, L, M, seed):
        """(R, n) noise with non-finite samples at seven kinds of place
        (each row one or two; NaN, +inf, -inf in turn), and the same rows
        with NaN alone."""
        t = tresample.aligned_tables(tresample.make_plan(L, M, 24, 9.0))
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = 0.3 * torch.randn((R, n), generator=gen, device=dev)
        rows = torch.arange(R, device=dev)
        c = 1 + (rows * 7) % max(1, n // M - 2)
        kind = rows % 7
        spots = torch.stack([c * M + M // 2, c * M, c * M + M - 1,
                             c * M + t.lo, c * M - 1, (c + 1) * M + t.hi - 1,
                             (c + 1) * M])
        p = spots.gather(0, kind[None])[0].clamp(0, n - 1)
        val = torch.tensor([float("nan"), float("inf"), -float("inf")],
                           device=dev)[rows % 3]
        x_nan = x.clone()
        x[rows, p] = val
        x_nan[rows, p] = float("nan")
        far = (rows % 5 == 0) & (p + 3 * M < n)  # a second place
        x[rows[far], p[far] + 3 * M] = val[far]
        x_nan[rows[far], p[far] + 3 * M] = float("nan")
        return x, x_nan

    k7_nan_ms = {}
    for rates, n_rows in (((44100, 16000), (441000, 441000 - 101)),
                          ((48000, 44100), (441280, 441280 - 101))):
        g = math.gcd(*rates)
        L, M = rates[1] // g, rates[0] // g
        for n in n_rows:
            x, x_nan = nonfinite_rows(512, n, L, M, n)
            aligned = kresample.twin_branch(
                tresample.make_plan(L, M, 24, 9.0), n,
                resample_output_len(n, L, M))[0]
            for arr, label in ((x, "NaN/+inf/-inf"), (x_nan, "NaN")):
                yk = kresample.resample(arr, *rates)
                yp = tresample.polyphase_resample(arr, *rates)
                fk, fp = torch.isfinite(yk), torch.isfinite(yp)
                same = bool(torch.equal(fk, fp))
                if label == "NaN":
                    same = same and bool(torch.equal(torch.isnan(yk),
                                                     torch.isnan(yp)))
                both = fk & fp
                e2 = float((yk[both] - yp[both]).double().pow(2).mean())
                db = 10.0 * math.log10(max(e2, 1e-300) / float(
                    yp[both].double().pow(2).mean()))
                print(f"K7 masks {rates[0]} -> {rates[1]}, 512 x {n} "
                      f"({'aligned' if aligned else 'windowed'} branch), "
                      f"{label}: {int((~fp).sum())} non-finite outputs in "
                      f"the twin, {int((~fk).sum())} in the kernel, masks "
                      f"equal {same}; finite outputs {db:.1f} dB (gate "
                      f"{GATE_KERNEL_DB})")
                if not (same and db <= GATE_KERNEL_DB and (~fp).any()):
                    raise SystemExit("chip_smoke: K7's non-finite mask "
                                     "differs from its twin's")
            if n == 441000:
                k7_nan_ms = {
                    "call": median_ms(lambda: kresample.resample(x, *rates)),
                    "b2b": back_to_back_ms(
                        lambda: kresample.resample(x, *rates))}
            del x, x_nan, yk, yp, fk, fp, both
    print(f"K7 at 512 x 441000 -> 160000: {k7['ms']:.3f} ms one call, "
          f"{k7_b2b:.3f} ms back to back (phase 10, finite input); with "
          f"non-finite samples in 512 rows {k7_nan_ms['call']:.3f} ms one "
          f"call, {k7_nan_ms['b2b']:.3f} back to back [{card}]")

    # 17. config 1: the port's config-1 function (int16 -> float32 -> K7)
    # with fresh counters, then the public resample on two clips
    from xmtpu_torch import bench as tbench
    from xmtpu_torch.ops import mix as tmix

    x1 = tbench.config1_inputs()
    xd1 = torch.from_numpy(x1).to(dev)
    reset_counts()
    y1 = tbench.config1_step(xd1)
    torch.cuda.synchronize()
    got1 = counts()
    if got1["resample"] < 1:
        raise SystemExit(f"chip_smoke: K7 did not launch in config 1: "
                         f"{got1}")
    y1b = tbench.config1_step(xd1, banded=True)
    db_twin = rms_db((y1[0] - y1b[0]).double().cpu().numpy(),
                     y1b[0].double().cpu().numpy())
    ref1 = tresample.resample_oracle_np(x1[0].astype(np.float64) / 32768.0,
                                        44100, 16000)
    db_or = rms_db(y1[0].double().cpu().numpy() - ref1, ref1)
    print(f"config 1: launches {got1}; clip 0 {db_twin:.1f} dB vs the twin "
          f"(gate {GATE_KERNEL_DB}), {db_or:.1f} dB vs float64 oracle (gate "
          f"{GATE_CHAIN_DB})")
    if not (db_twin <= GATE_KERNEL_DB and db_or <= GATE_CHAIN_DB):
        raise SystemExit("chip_smoke: config 1 accuracy gate failed")
    B1, n1 = x1.shape
    sec1, _ = step_seconds(tbench.config1_step, xd1, iters=20)
    sec1b, _ = step_seconds(lambda v_: tbench.config1_step(v_, banded=True),
                            xd1, iters=20)
    print(f"config 1: {B1}x{n1 / 44100:g} s in {sec1 * 1e3:.3f} ms = "
          f"{B1 * n1 / 44100 / sec1:.1f} audio-sec/sec on K7; banded FP32 "
          f"matmuls {sec1b * 1e3:.3f} ms = {B1 * n1 / 44100 / sec1b:.1f} "
          f"audio-sec/sec [{card}]")
    for clip, label in ((x1[:2].T.copy(), "(n, 2) int16"),
                        (x1[0].astype(np.float32) / 32768.0,
                         "(n,) float32")):
        got = xmtpu_torch.resample(clip, 44100, 16000)
        twin = xmtpu_torch.resample(clip, 44100, 16000, device="cpu")
        err = np.abs(got.astype(np.float64) - twin.astype(np.float64))
        ok = got.shape == twin.shape and got.dtype == twin.dtype and (
            err.max() <= 1 if got.dtype == np.int16 else rms_db(
                got.astype(np.float64) - twin, twin) <= GATE_KERNEL_DB)
        print(f"api.resample {label} {clip.shape} -> {got.shape} "
              f"{got.dtype}: max abs {err.max():.3g} vs the twin")
        if not ok:
            raise SystemExit(f"chip_smoke: api.resample {label} differs "
                             "from its twin")
    del xd1, y1, y1b

    # 18. config 2: two float32 tracks at 16 kHz, gain, fade, sum, peak
    # normalize per row
    v2, b2 = tbench.config2_inputs()
    vd2, bd2 = torch.from_numpy(v2).to(dev), torch.from_numpy(b2).to(dev)
    y2 = tbench.config2_step(vd2, bd2)
    fade2 = int(0.25 * 16000)
    ref2 = tmix.mix_oracle_np([v2[0], b2[0]], [0.9, 0.4], [fade2] * 2,
                              [fade2] * 2, normalize="peak",
                              target_amp=tmix.db_to_amp(-1.0))
    db2 = rms_db(y2[0].double().cpu().numpy() - ref2, ref2)
    sec2, _ = step_seconds(tbench.config2_step, vd2, bd2, iters=20)
    B2, n2 = v2.shape
    print(f"config 2: row 0 {db2:.1f} dB vs mix_oracle_np (gate "
          f"{GATE_KERNEL_DB}); {B2}x{n2 / 16000:g} s in {sec2 * 1e3:.3f} ms "
          f"= {B2 * n2 / 16000 / sec2:.1f} audio-sec/sec [{card}]")
    if not db2 <= GATE_KERNEL_DB:
        raise SystemExit("chip_smoke: config 2 accuracy gate failed")
    del vd2, bd2, y2

    # 19. the strided-conv resample: 16k -> 48k (band wider than 2M: the
    # drop-in takes the conv) and 8k -> 44.1k (band within 2M: the
    # drop-in takes K7; the conv asked for by method="conv") on 32 clips
    # of 10 s
    for sr_in, sr_out in ((16000, 48000), (8000, 44100)):
        xs_ = (0.3 * np.random.default_rng(sr_in).standard_normal(
            (32, int(sr_in * CLIP_SECONDS)))).astype(np.float32)
        xd_ = torch.from_numpy(xs_).to(dev)
        plan_ = tresample.make_plan(*tresample._ratio(sr_in, sr_out), 24, 9.0)
        ref_ = tresample.resample_oracle_np(xs_[0], sr_in, sr_out)
        wide = plan_.width > 2 * plan_.M
        for label, fn in (
                ("kernels.resample (" + ("the conv" if wide else "K7") + ")",
                 lambda: kresample.resample(xd_, sr_in, sr_out)),
                ('polyphase_resample(method="conv")',
                 lambda: tresample.polyphase_resample(xd_, sr_in, sr_out,
                                                      method="conv"))):
            reset_counts()
            y_ = fn()
            torch.cuda.synchronize()
            if counts()["resample"] != (0 if wide or "conv\"" in label
                                        else 1):
                raise SystemExit(f"chip_smoke: {sr_in} -> {sr_out} took the "
                                 f"wrong path: {counts()}")
            db_ = rms_db(y_[0].double().cpu().numpy() - ref_, ref_)
            ms_ = median_ms(fn)
            print(f"resample {sr_in} -> {sr_out} (L = {plan_.L}, M = "
                  f"{plan_.M}, band {plan_.width}) {label} "
                  f"{tuple(xd_.shape)} -> {tuple(y_.shape)}: clip 0 "
                  f"{db_:.1f} dB vs float64 oracle (gate {GATE_CHAIN_DB}); "
                  f"{ms_:.3f} ms [{card}]")
            if not db_ <= GATE_CHAIN_DB:
                raise SystemExit("chip_smoke: resample accuracy gate failed")
            if wide:
                break  # the drop-in is the conv
        del xd_, y_

    # 20. the float64 scan engine: effects(backend="scan") at config 3's
    # full input, then the scan step on 32 clips of 10 s, fresh counters
    xd3 = torch.from_numpy(x3).to(dev)

    def run_scan(x):
        return effects(x, SR3, chain3, device=dev, backend="scan",
                       device_out=True)

    torch.cuda.reset_peak_memory_stats()
    y3s, got = drive("config 3 effects (scan engine)", run_scan, (xd3,), (),
                     ref3, B3 * n3 / SR3)
    if any(got.values()):
        raise SystemExit(f"chip_smoke: the scan engine launched a kernel: "
                         f"{got}")
    print(f"config 3 effects (scan engine): peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del xd3, y3s
    voice, bgm = make_inputs(SMALL_BATCH, CLIP_SECONDS)
    v = torch.from_numpy(voice).to(dev)
    b = torch.from_numpy(bgm).to(dev)
    scan_step = tbatch.make_flagship_step(iir_backend="scan", device=dev)
    y, got = drive("scan step (iir_backend=scan)", scan_step, (v, b),
                   ("fftconv",), ref, SMALL_BATCH * CLIP_SECONDS)
    off = {k: got[k] for k in ("iir", "state_chain", "envelope",
                               "envelope_seg", "eq_env", "gain")}
    if any(off.values()):
        raise SystemExit(f"chip_smoke: the scan step launched {off}")
    del scan_step, v, b, y

    # 21. one podcast episode through xmtpu_torch.api.process_file: the
    # gated run with fresh counters, a timed run with the stage marks,
    # api.mix alone and its loudness, noise suppression on the whole
    # voice against the float64 oracle, the card against the CPU on the
    # first 20 s, and each kernel of the path against its twin at the
    # path's operands
    import dataclasses
    import tempfile
    from pathlib import Path

    from xmtpu_torch.io import read_wav, write_wav
    from xmtpu_torch.ops import loudness
    from xmtpu_torch.ops import ns as tns

    with tempfile.TemporaryDirectory() as tmp_:
        tmp = Path(tmp_)
        paths = episode_inputs(tmp)
        cfg = episode_config(paths)
        n_bus = resample_output_len(int(EPISODE_S * VOICE_SR),
                                    *tresample._ratio(VOICE_SR, BUS_SR))
        out = tmp / "episode.wav"
        reset_counts()
        t0 = time.perf_counter()
        xmtpu_torch.process_file(None, cfg, out)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        got_ep = counts()
        k1_key = "fftconv_long" if got_ep["fftconv_long"] else "fftconv"
        print(f"episode: launches {got_ep}; launched "
              f"{sorted(k for k, v_ in got_ep.items() if v_)}")
        if not all(got_ep[k] for k in ("resample", "iir", k1_key,
                                       "envelope_seg", "lufs")):
            raise SystemExit("chip_smoke: the episode did not launch K7 "
                             "(resample), K5 (iir), K1, the envelope "
                             f"kernel and the block powers' kernel: {got_ep}")
        marks = []

        def mark(p_):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xmtpu_torch.process_file(None, cfg, out, progress=mark)
        wall = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        stages = dict(zip(("decode", "mix (voice chain, normalize)",
                           "master chain, int16", "encode"),
                          np.diff(marks) * 1e3))
        y_ep, sr_ep = read_wav(out)
        ceiling = int(convert.f32_to_pcm16_np(
            np.float32([10.0 ** (-1.0 / 20.0)]))[0])
        peak_ep = int(np.abs(y_ep.astype(np.int32)).max())
        finite = bool(np.isfinite(y_ep.astype(np.float32)).all())
        print(f"episode: {EPISODE_S:g} s voice + {EPISODE_BGM_S:g} s looped "
              f"BGM -> {sr_ep} Hz {y_ep.shape}; peak {peak_ep} (ceiling "
              f"{ceiling}); process_file {wall:.2f} s = "
              f"{EPISODE_S / wall:.1f} audio-sec/sec wall clock with WAV "
              f"I/O (first run {first_s:.2f} s); stages (ms, CUDA-synced "
              "marks): " + ", ".join(f"{k} {t_:.1f}" for k, t_ in
                                     stages.items())
              + f"; peak memory {peak_gib:.2f} GiB [{card}]")
        if not (sr_ep == BUS_SR and y_ep.shape == (n_bus, 2) and finite
                and peak_ep <= ceiling):
            raise SystemExit("chip_smoke: the episode's file is wrong")
        del y_ep
        # the card's busy share of one run: its kernels' and copies' time
        # in a torch.profiler trace over the wall clock (the stages'
        # annotations span their idle gaps too: left out)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            xmtpu_torch.process_file(None, cfg, out)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        on_card = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.is_user_annotation), reverse=True)
        busy_ms = sum(t_ for t_, _, _ in on_card)
        print(f"episode: traced run {traced_s:.2f} s, " + (
            f"kernels on the card {busy_ms:.1f} ms = "
            f"{100 * busy_ms / (traced_s * 1e3):.1f}% busy; most time: "
            + "; ".join(f"{k[:48]} x{c} {t_:.1f} ms"
                        for t_, c, k in on_card[:6]) if on_card else
            "no device events in the trace: busy share not measured")
            + f" [{card}]")

        # api.mix alone (float32 tracks: the bus before the master chain
        # and the int16 conversion), its loudness on the card
        vf = convert.pcm16_to_f32_np(read_wav(paths["voice"])[0][:, 0])
        bf = convert.pcm16_to_f32_np(read_wav(paths["bgm"])[0])
        tracks = [dict(pcm=vf, sr=VOICE_SR, fade_in_ms=250.0),
                  dict(pcm=bf, sr=BUS_SR, kind="bgm", gain=0.5, loop=True,
                       side_duck=True, fade_in_ms=2000.0)]
        t0 = time.perf_counter()
        mixed = xmtpu_torch.mix(tracks, BUS_SR, normalize="lufs",
                                target_db=-16.0,
                                voice_effects=list(cfg.effects))
        mix_s = time.perf_counter() - t0
        bus = torch.from_numpy(mixed.T.copy()).to(dev)  # (2, n)
        lufs_card = float(loudness.measure_lufs(bus, BUS_SR))
        lufs_ms = median_ms(lambda: loudness.measure_lufs(bus, BUS_SR),
                            warmup=1, runs=3)
        lufs_ref = loudness.measure_lufs_np(mixed.T, BUS_SR)
        lufs_phase(h, bus, BUS_SR)
        (ns_fx, lti) = tfx.get_compiled_chain(BUS_SR, list(cfg.effects))
        # K7 on the whole voice, as the mixer gives it: the kernel against
        # its twin, the dense banded matmul as the library yardstick
        xv7 = torch.from_numpy(vf).to(dev)[None]
        vbus = kresample.resample(xv7, VOICE_SR, BUS_SR)
        k7e = compare("resample_episode", "cuda",
                      "xmtpu_torch/csrc/resample.cu",
                      "xmtpu/kernels/resample.py:37", vbus,
                      tresample.polyphase_resample(xv7, VOICE_SR, BUS_SR))
        k7e["ms"] = median_ms(lambda: kresample.resample(xv7, VOICE_SR,
                                                         BUS_SR))
        k7e["plain_ms"] = median_ms(lambda: tresample.polyphase_resample(
            xv7, VOICE_SR, BUS_SR), warmup=1, runs=3)
        plan_e = tresample.make_plan(*tresample._ratio(VOICE_SR, BUS_SR),
                                     24, 9.0)
        nj_e = -(-n_bus // plan_e.L)
        need_e = (nj_e + 2) * plan_e.M + plan_e.width
        xs_e = torch.nn.functional.pad(xv7, (plan_e.pad_left, need_e))[
            :, plan_e.base:plan_e.base + need_e].contiguous()
        frames_e = xs_e.as_strided((1, nj_e, plan_e.width),
                                   (xs_e.stride(0), plan_e.M, 1))
        hbank_e = torch.as_tensor(plan_e.hbank, dtype=torch.float32,
                                  device=dev)
        k7e["library_ms"] = median_ms(lambda: torch.matmul(
            frames_e, hbank_e), warmup=1, runs=3)
        k7e["launches"] = got_ep["resample"]
        bound(k7e, 4 * (xv7.numel() + n_bus + plan_e.L * plan_e.K2),
              2 * plan_e.K2 * n_bus)
        print(f"K7 on the episode's voice {tuple(xv7.shape)} -> (1, "
              f"{n_bus}) (L = {plan_e.L}, M = {plan_e.M}, band "
              f"{plan_e.width}): {k7e['rms_db']:.1f} dB vs plain (gate "
              f"{GATE_KERNEL_DB}), max abs {k7e['max_abs_err']:.3g}; kernel "
              f"{k7e['ms']:.3f} ms, plain {k7e['plain_ms']:.3f} ms, dense "
              f"banded matmul {k7e['library_ms']:.3f} ms, bound "
              f"{k7e['bound_ms']:.4f} ms ({k7e['bound_by']}) [{card}]")
        poly_geometry_line("K7 on the episode", plan_e, n_bus,
                           "xm_resample_blocks_per_sm", 1)
        del xv7, xs_e, frames_e
        vbus = tmix.apply_gain_fade(vbus, 1.0, int(0.25 * BUS_SR), 0)
        vbus = vbus.expand(2, -1).contiguous()
        chain_ms = median_ms(lambda: tfx.chain_apply(
            (ns_fx, lti), vbus, (None, None)), warmup=1, runs=3)
        norm_ms = median_ms(lambda: loudness.lufs_normalize(
            bus, BUS_SR, -16.0), warmup=1, runs=3)
        print(f"episode: api.mix {mix_s:.2f} s = {EPISODE_S / mix_s:.1f} "
              f"audio-sec/sec wall clock; alone on the card: voice chain "
              f"{chain_ms:.1f} ms ({type(ns_fx).__name__} + "
              f"{type(lti).__name__}, {len(lti.ir)} taps), lufs_normalize "
              f"{norm_ms:.1f} ms, measure_lufs {lufs_ms:.1f} ms; LUFS of the "
              f"bus {lufs_card:.4f} on the card, {lufs_ref:.4f} float64 "
              f"(gates {GATE_LU_ORACLE} LU, {GATE_LU_TARGET} LU of -16) "
              f"[{card}]")
        if not (abs(lufs_card - lufs_ref) <= GATE_LU_ORACLE
                and abs(lufs_card + 16.0) <= GATE_LU_TARGET):
            raise SystemExit("chip_smoke: the episode's loudness gate failed")

        # noise suppression on the whole voice at 48 kHz
        v48 = vbus[:1]
        ns_ms = median_ms(lambda: tns.suppress(v48), warmup=1, runs=3)
        y_ns = tns.suppress(v48)
        t0 = time.perf_counter()
        ref_ns = tns.suppress_np(v48.double().cpu().numpy())
        ns_np_s = time.perf_counter() - t0
        db_ns = rms_db(y_ns.double().cpu().numpy() - ref_ns, ref_ns)
        print(f"episode: suppress {tuple(v48.shape)} on the card "
              f"{ns_ms:.1f} ms, {db_ns:.1f} dB vs suppress_np (gate "
              f"{GATE_CHAIN_DB}; the oracle took {ns_np_s:.1f} s on the "
              f"host) [{card}]")
        if not db_ns <= GATE_CHAIN_DB:
            raise SystemExit("chip_smoke: the episode's NS gate failed")
        del ref_ns

        # the card against the CPU on the first 20 s of the voice
        v20 = tmp / "voice20.wav"
        write_wav(v20, convert.f32_to_pcm16_np(
            vf[:int(EPISODE_CPU_S * VOICE_SR)]), VOICE_SR)
        cfg20 = dataclasses.replace(cfg, tracks=(dataclasses.replace(
            cfg.tracks[0], url=str(v20)),) + cfg.tracks[1:])
        outs20 = {}
        for d_ in ("cuda", "cpu"):
            t0 = time.perf_counter()
            xmtpu_torch.process_file(None, cfg20, tmp / f"{d_}.wav",
                                     device=d_)
            outs20[d_] = (read_wav(tmp / f"{d_}.wav")[0].astype(np.float64)
                          / 32768.0, time.perf_counter() - t0)
        db_cc = rms_db(outs20["cuda"][0] - outs20["cpu"][0],
                       outs20["cpu"][0])
        print(f"episode: first {EPISODE_CPU_S:g} s on the card "
              f"({outs20['cuda'][1]:.2f} s) against the CPU "
              f"({outs20['cpu'][1]:.2f} s): {db_cc:.1f} dB (gate "
              f"{GATE_CHAIN_DB}) [{card}]")
        if not (outs20["cuda"][0].shape == outs20["cpu"][0].shape
                and db_cc <= GATE_CHAIN_DB):
            raise SystemExit("chip_smoke: the episode's card-vs-CPU gate "
                             "failed")

        # the path's kernels against their twins at its operands: K5 on
        # the K-weighting of the bus (the call at the card's S against the
        # same path on the twin), K1 on the noise-suppressed voice with
        # the folded EQ+reverb IR, K3 on the master limiter's first block
        sos_k = loudness.k_weighting_sos(BUS_SR)
        S_k = iir.sosfilt_segments(2, n_bus, dev, sos_k.shape[0])
        yk = iir.sosfilt(sos_k, bus)[0]
        t0 = time.perf_counter()
        yp = iir.sosfilt(sos_k, bus, run=iir.sosfilt_plain)[0]
        torch.cuda.synchronize()
        plain_k = (time.perf_counter() - t0) * 1e3
        k5e = compare("iir_k_weighting", "cuda", "xmtpu_torch/csrc/iir.cu",
                      "xmtpu/kernels/iir.py:37", yk, yp)
        k5e["ms"] = median_ms(lambda: iir.sosfilt(sos_k, bus))
        k5e["plain_ms"] = plain_k
        k5e["launches"] = got_ep["iir"]
        bound(k5e, 4 * (2 * 2 * n_bus + 6 * 2 + 4 * 2 * 2),
              9 * 2 * 2 * n_bus)
        print(f"K5 on the episode's K-weighting {tuple(bus.shape)} at S = "
              f"{S_k}: {k5e['rms_db']:.1f} dB vs the twin path, max abs "
              f"{k5e['max_abs_err']:.3g}; the sosfilt() call "
              f"{k5e['ms']:.3f} ms, the twin path {plain_k:.0f} ms, bound "
              f"{k5e['bound_ms']:.3f} ms ({k5e['bound_by']}) [{card}]")
        del yk, yp
        xv = torch.cat([y_ns, y_ns]).contiguous()
        k1e = check_k1("fftconv_long_episode", xv,
                       torch.from_numpy(lti.ir).to(dev),
                       torch.ones(2, device=dev),
                       torch.ones(n_bus, device=dev))
        k1e["launches"] = got_ep[k1_key]
        del xv, y_ns
        lim = tfx.get_compiled_chain(BUS_SR, list(cfg.master_effects))[0]
        blk = torch.from_numpy(convert.pcm16_to_f32_np(convert.f32_to_pcm16_np(
            mixed[:cfg.block_size].T.copy()))).to(dev)
        d_ep = blk.abs().amax(0)
        k_rel_e = limiter._release_coeff(lim.kw["release_ms"], BUS_SR)
        c_att_e = limiter._attack_coeff(lim.kw["attack_ms"], BUS_SR)
        S_e = envelope.envelope_segments(1, d_ep.shape[-1], dev)
        passes_e = []

        def recording_e(*args):
            passes_e.append(args)
            return envelope.envelope_pass(*args)

        e2k = envelope.envelope(d_ep, k_rel_e, c_att_e, run=recording_e)[0]
        e2p = envelope.envelope(d_ep, k_rel_e, c_att_e,
                                run=envelope.envelope_plain)[0]
        k3e = compare("envelope_seg_episode", "cuda",
                      "xmtpu_torch/csrc/envelope.cu",
                      "xmtpu/kernels/envelope.py:108", e2k, e2p)
        # the block's launches on the card (graph replays, as phase 7),
        # each against its twin on its own operands; the envelope() call
        # from the host (its glue and the tensor-map encodes) printed
        # beside them
        pass_err_e = [max(float((a_ - b_).abs().max()) for a_, b_ in zip(
            envelope.envelope_pass(*a), envelope.envelope_plain(*a)))
            for a in passes_e]
        k3e["max_abs_err"] = max(k3e["max_abs_err"], *pass_err_e)
        if k3e["max_abs_err"] != 0.0:
            raise SystemExit("chip_smoke: the episode's envelope launches "
                             f"differ from their twins: {pass_err_e}")
        pass_card_e = [replay_ms(lambda a=a: envelope.envelope_pass(*a))
                       for a in passes_e]
        k3e["ms"] = sum(pass_card_e)
        k3e["plain_ms"] = sum(median_ms(
            lambda a=a: envelope.envelope_plain(*a), warmup=0, runs=3)
            for a in passes_e)
        call_e = median_ms(lambda: envelope.envelope(d_ep, k_rel_e,
                                                     c_att_e))
        k3e["launches"] = got_ep["envelope_seg"]
        rows_ee, seg_ee = passes_e[0][0].shape
        bound(k3e, 4 * (len(passes_e) * 2 * rows_ee * seg_ee + seg_ee
                        + rows_ee), len(passes_e) * 5 * rows_ee * seg_ee)
        print(f"K3/K4 on the episode's master limiter block "
              f"{tuple(d_ep.shape)} at S = {S_e} ({rows_ee} x {seg_ee}, "
              f"{len(passes_e)} launches): {k3e['rms_db']:.1f} dB vs the "
              f"twin path, max abs {k3e['max_abs_err']:.3g} (each launch "
              "against its twin: must be 0); launches "
              + " + ".join(f"{t:.4f}" for t in pass_card_e)
              + f" = {k3e['ms']:.4f} ms on the card as graph replays; the "
              f"envelope() call {call_e:.3f} ms from the host; the twin's "
              f"launches {k3e['plain_ms']:.1f} ms; bound "
              f"{k3e['bound_ms']:.5f} ms ({k3e['bound_by']}) [{card}]")
        del bus, vbus, v48, blk, d_ep, e2k, e2p, mixed, passes_e

    h.check_k1 = check_k1
    # 22-23. config 5 (streaming and the 32-slot pool) and serving
    streaming_phases(h)

    # 24-26. the native runtime, config 6 (the file runner), the command
    # line, the compat handles and the examples
    runner_phases(h)

    # 27-29. sequence and data parallelism: the hour clip time-sharded,
    # the sharded step, pool and server, the dryrun twin; real cards
    parallel_phases(h)

    # 30. entry(), the interpret= rule and the FFmpeg shim
    entry_phase(h)

    # 31. the precision rungs, K1's trim=False and gp, mixfirst_pad
    precision_phase(h)

    # 32. the noise suppressor's Wiener kernel at the voice cell's spectra
    ns_phase(h)

    # 33. kernels line, then the contract line last
    print(kernels_line(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
