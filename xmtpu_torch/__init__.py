"""xmtpu_torch — the flagship audio chain of ``xmtpu`` in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100, ``sm_90a``).

A port beside the JAX package, which stays the reference: every ported
function is tested against its ``xmtpu`` counterpart on the same inputs.
This package imports ``torch``, ``numpy`` and ``scipy``, never ``jax``
or ``xmtpu``.

Entry point: ``xmtpu_torch.batch.make_flagship_step(device=...)``.
"""

__version__ = "0.1.0"
