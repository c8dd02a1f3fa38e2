"""Parallelism of the port (counterpart of ``xmtpu.parallel``), driven
by one process over a :class:`Mesh` of devices:

* **DP**: a clip batch over a ``("dp",)`` mesh,
  ``xmtpu_torch.batch.flagship_step_sharded`` (no exchange needed), and
  the slots of ``SessionPool``/``PoolServer`` (``mesh=``);
* **SP**: ONE long clip sharded along time over a ``("sp",)`` mesh, this
  package: FIR ops take a taps-1 halo from the left neighbour; IIR and
  envelope state crosses shards exactly by composing each shard's
  affine (or max-plus) summary;
* both on a 2-D ``("dp", "sp")`` mesh (``sp_effects_chain(dp_axis=)``).

``python -m xmtpu_torch.parallel.dryrun N`` runs every strategy once
(:func:`xmtpu_torch.parallel.dryrun.dryrun_multichip`).
"""

from xmtpu_torch.parallel.mesh import Mesh  # noqa: F401
from xmtpu_torch.parallel.sp import (  # noqa: F401
    sp_biquad,
    sp_effects_chain,
    sp_envelope,
    sp_fir,
)
