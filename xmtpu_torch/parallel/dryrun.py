"""One step of every parallel strategy on small shapes (the twin of the
JAX package's ``__graft_entry__.dryrun_multichip``), with its legs and
asserts:

1. ``dp``: clips data-parallel over a ``("dp",)`` mesh
   (``batch.flagship_step_sharded``; the kernels on each shard);
2. ``sp``: ONE clip time-sharded over a ``("sp",)`` mesh: the EQ's exact
   cross-shard state chain, the reverb's halo, the limiter's envelope;
3. ``pool``: a ``SessionPool`` with its slots sharded over the ``dp``
   mesh (K/n sessions a shard);
4. ``serve``: a ``PoolServer`` bucketing two configs into two sharded
   pools;
5. ``2d``: a ``("dp", "sp")`` mesh, a batch of clips sharded over clips
   AND time (n >= 4 and even).

    python -m xmtpu_torch.parallel.dryrun N [--device D] [--legs dp,sp]

``device=None``: the first N cards (:class:`DeviceError` with fewer);
``device="cpu"`` or ``"cuda:0"``: N virtual shards there. The JAX
package's child process and its ``sitecustomize`` shim exist to pin
JAX's platform and device count before it initializes; one process
drives every shard here, so neither is ported.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from xmtpu_torch.entry import example_batch

LEGS = ("dp", "sp", "pool", "2d", "serve")


def _devices(n_devices: int, device) -> list:
    from xmtpu_torch.utils.errors import DeviceError

    if device is not None:
        return [torch.device(device)] * n_devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise DeviceError(f"dryrun_multichip({n_devices}) needs {n_devices} "
                          f"CUDA devices, this host has {have}; "
                          "device=\"cpu\" or \"cuda:0\" gives virtual shards")
    return [torch.device("cuda", i) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None, legs=LEGS) -> None:
    """Run each leg in ``legs`` once over meshes of ``n_devices`` shards
    (module docstring); every leg asserts its output's shape and that it
    is finite, and prints one line."""
    from xmtpu_torch import batch as tbatch
    from xmtpu_torch.ops import biquad, reverb
    from xmtpu_torch.parallel import Mesh, sp_effects_chain

    unknown = set(legs) - set(LEGS)
    if unknown:
        raise ValueError(f"unknown legs {sorted(unknown)}; legs: {LEGS}")
    devs = _devices(n_devices, device)
    mesh_dp, _ = tbatch.shard_over_batch(
        n_devices, device=None if device is None else devs[0])
    step = tbatch.flagship_step_sharded(mesh_dp, iir_backend="pallas")
    host = devs[0]

    if "dp" in legs:
        voice, bgm = example_batch(batch=2 * n_devices, n=4410)
        out = step(torch.from_numpy(voice).to(host),
                   torch.from_numpy(bgm).to(host)).cpu().numpy()
        assert out.shape == (2 * n_devices, 1600), out.shape
        assert out.dtype == np.int16
        print(f"dryrun_multichip({n_devices}): dp OK, out {out.shape} "
              f"sharded over {mesh_dp.shape}")

    sos = biquad.eq_sos([{"freq_hz": 1000.0, "gain_db": 3.0, "q": 1.0}],
                        48000)
    ir = reverb.synthetic_ir(0.005, 48000).astype(np.float32)

    if "sp" in legs:
        mesh_sp = Mesh(devs, ("sp",))
        rng = np.random.default_rng(1)
        x = (0.3 * rng.standard_normal((2, n_devices * 1024))).astype(
            np.float32)
        y = sp_effects_chain(torch.from_numpy(x).to(host), 48000, mesh_sp,
                             bands=sos, ir=ir).cpu().numpy()
        assert y.shape == x.shape and np.all(np.isfinite(y))
        print(f"dryrun_multichip({n_devices}): sp OK, one "
              f"{x.shape[-1]}-sample clip time-sharded over "
              f"{mesh_sp.shape}")

    if "pool" in legs:
        from xmtpu_torch.graph.pool import SessionPool

        K = 2 * n_devices
        rng = np.random.default_rng(2)
        srcs = [{"v": ((0.3 * rng.standard_normal(2000)).astype(np.float32),
                       16000)} for _ in range(K)]
        pool = SessionPool(
            {"tracks": [{"url": "v"}], "sampleRate": 16000,
             "normalize": None},
            K, frame_ms=20.0, sources=srcs, mesh=mesh_dp)
        grp = pool.read(2)
        assert grp.shape[0] == K and np.all(np.isfinite(grp))
        pool.leave(1)
        assert np.all(pool.read(1)[1] == 0)
        print(f"dryrun_multichip({n_devices}): pool OK, {K} sessions "
              f"sharded over {mesh_dp.shape}")

    if "serve" in legs:
        from xmtpu_torch.graph.serve import PoolServer

        rng = np.random.default_rng(3)
        pcm = (0.3 * rng.standard_normal(2000)).astype(np.float32)
        srv = PoolServer(n_slots=n_devices, frame_ms=20.0, mesh=mesh_dp)
        sid_a = srv.open(
            {"tracks": [{"url": "a"}], "sampleRate": 16000,
             "normalize": None},
            sources={"a": (pcm, 16000)})
        sid_b = srv.open(
            {"tracks": [{"url": "b", "volume": 0.5}], "sampleRate": 16000,
             "normalize": None},
            sources={"b": (pcm, 16000)})
        frames = srv.pump(2)
        assert set(frames) == {sid_a, sid_b}, sorted(frames)
        assert all(np.all(np.isfinite(np.asarray(v, dtype=np.float64)))
                   for v in frames.values())
        more = srv.read(sid_a, 1)
        assert more is not None and more.shape[-2] >= 1
        srv.close(sid_b)
        srv.close(sid_a)
        n_pools = srv.stats()["pools"]
        print(f"dryrun_multichip({n_devices}): serve OK, 2 configs -> "
              f"{n_pools} pools over {mesh_dp.shape}")

    if "2d" in legs and n_devices >= 4 and n_devices % 2 == 0:
        n_sp = n_devices // 2
        mesh_2d = Mesh(np.array(devs, dtype=object).reshape(2, n_sp),
                       ("dp", "sp"))
        rng = np.random.default_rng(4)
        xb = (0.3 * rng.standard_normal((4, 1, n_sp * 1024))).astype(
            np.float32)
        yb = sp_effects_chain(torch.from_numpy(xb).to(host), 48000, mesh_2d,
                              bands=sos, ir=ir, dp_axis="dp").cpu().numpy()
        assert yb.shape == xb.shape and np.all(np.isfinite(yb))
        print(f"dryrun_multichip({n_devices}): dp x sp OK, {xb.shape[0]} "
              f"clips x {xb.shape[-1]} samples over {mesh_2d.shape}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m xmtpu_torch.parallel.dryrun",
        description="One step of every parallel strategy on small shapes.")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="run N virtual shards on this device (cpu, "
                         "cuda:0); default: the first N cards")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help=f"comma-separated subset of {','.join(LEGS)}")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device,
                     legs=tuple(args.legs.split(",")))


if __name__ == "__main__":
    main()
