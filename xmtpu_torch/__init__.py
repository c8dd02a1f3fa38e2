"""xmtpu_torch — the audio chains of ``xmtpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

A port beside the JAX package, which stays the reference: every ported
function is tested against its ``xmtpu`` counterpart on the same inputs.
This package imports ``torch``, ``numpy`` and ``scipy``, never ``jax``
or ``xmtpu``.

Entry points: ``xmtpu_torch.batch.make_flagship_step(device=...)`` (the
flagship batch chain), ``xmtpu_torch.resample(pcm, sr_in, sr_out, ...)``
(rate conversion, BASELINE config 1), ``xmtpu_torch.effects(pcm, sr,
chain, ...)`` (the public effect chain, BASELINE config 3).
"""

from xmtpu_torch.api import effects, resample

__all__ = ["effects", "resample"]
__version__ = "0.1.0"
