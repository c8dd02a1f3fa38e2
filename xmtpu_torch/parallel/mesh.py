"""Device meshes driven by one process (the counterpart of
``jax.sharding.Mesh`` as the JAX package uses it, with ``shard_map``'s
in/out specs and the two collectives ``parallel.sp`` uses).

Every JAX contract of the parallel paths is single-controller: an SP
function takes the whole array and returns the whole array, a sharded
pool is one object whose host calls act on global slot numbers. So one
process drives every shard here too. A shard is a block of a tensor on
one device; the exchanges between shards are device-to-device copies
(``Tensor.to(device, non_blocking=True)``, peer to peer over NVLink
between the cards of one host), and nothing in this module waits for a
device: a caller that launches every shard's local pass before the
first exchange lets the cards overlap.

Devices may repeat. Several shards on one device are virtual shards,
the counterpart of XLA's ``--xla_force_host_platform_device_count``:
the CPU tests run N shards in one process, and one card runs the real
kernels through the real cross-shard paths.
"""

from __future__ import annotations

import numpy as np
import torch

from xmtpu_torch.utils.errors import DeviceError


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` without waiting for either device: a copy to
    a card is ``non_blocking`` (a card-to-card copy is ordered after
    both devices' queued work by PyTorch); a copy to the CPU is the
    caller asking for host data and blocks."""
    return t.to(device, non_blocking=device.type == "cuda")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise DeviceError(f"mesh device {d} named, but no CUDA device is "
                          "present; a mesh of virtual shards on the CPU "
                          "names \"cpu\"")
    if d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if d.index >= torch.cuda.device_count():
        raise DeviceError(f"mesh device {d}: this host has "
                          f"{torch.cuda.device_count()} CUDA device(s)")
    return d


class Mesh:
    """Devices laid out on named axes.

    ``devices``: an array-like of devices (``torch.device`` or strings)
    shaped like the axes; a device may repeat (virtual shards).
    ``axis_names``: one name per axis. ``shape[name]`` is the axis's
    size and ``devices`` an ndarray of ``torch.device`` (``cuda`` alone
    becomes the current card). A CUDA device that this host does not
    have raises :class:`DeviceError`."""

    def __init__(self, devices, axis_names):
        names = tuple(axis_names)
        arr = np.array(devices, dtype=object)
        if arr.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh devices of shape {arr.shape} need one "
                             f"distinct name per axis, got {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = _device(arr[idx])
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; :class:`ValueError` if the mesh
        has no such axis."""
        if name not in self.shape:
            raise ValueError(f"mesh has no axis {name!r} (axes: "
                             f"{self.axis_names})")
        return self.shape[name]

    def axis_devices(self, name: str) -> list:
        """The devices along axis ``name``, the other axes at index 0."""
        n = self.axis_size(name)
        ax = self.axis_names.index(name)
        return list(np.moveaxis(self.devices, ax, 0).reshape(n, -1)[:, 0])

    def _spec(self, spec, ndim: int) -> tuple:
        spec = tuple(spec) + (None,) * (ndim - len(spec))
        named = [a for a in spec if a is not None]
        if len(spec) != ndim or len(set(named)) != len(named):
            raise ValueError(f"spec {spec} for a {ndim}-d tensor")
        for a in named:
            self.axis_size(a)
        return spec

    def split(self, x: torch.Tensor, spec) -> np.ndarray:
        """``shard_map``'s ``in_specs``: ``spec`` names, per dim of
        ``x``, the mesh axis that dim is split over (None: whole; a
        short spec is padded with None). -> an object ndarray shaped
        like the mesh; the block at a mesh index is that shard's part
        of ``x`` on that index's device (a view where the device is
        x's own). A dim that does not divide evenly over its axis
        raises :class:`ValueError`, as ``shard_map`` does: nothing is
        padded."""
        spec = self._spec(spec, x.dim())
        for d, a in enumerate(spec):
            if a is not None and x.shape[d] % self.shape[a]:
                raise ValueError(
                    f"dim {d} of {tuple(x.shape)} does not divide evenly "
                    f"over mesh axis {a!r} (size {self.shape[a]})")
        out = np.empty(self.devices.shape, dtype=object)
        for idx in np.ndindex(self.devices.shape):
            sl = []
            for d, a in enumerate(spec):
                if a is None:
                    sl.append(slice(None))
                    continue
                c = x.shape[d] // self.shape[a]
                i = idx[self.axis_names.index(a)]
                sl.append(slice(i * c, (i + 1) * c))
            out[idx] = _on(x[tuple(sl)], self.devices[idx])
        return out

    def concat(self, blocks: np.ndarray, spec, device) -> torch.Tensor:
        """``shard_map``'s ``out_specs``: the inverse of :meth:`split`,
        the blocks concatenated along the dims ``spec`` names, on
        ``device``. Along a mesh axis the spec does not name, the
        blocks are replicas: index 0's is taken."""
        device = torch.device(device)
        spec = self._spec(spec, blocks.flat[0].dim())
        grid = blocks[tuple(slice(None) if n in spec else 0
                            for n in self.axis_names)]
        order = [n for n in self.axis_names if n in spec]
        for k in reversed(range(len(order))):  # the last grid axis first
            d = spec.index(order[k])
            joined = np.empty(grid.shape[:-1], dtype=object)
            for idx in np.ndindex(grid.shape[:-1]):
                joined[idx] = torch.cat([_on(b, device) for b in grid[idx]],
                                        dim=d)
            grid = joined
        return _on(grid[()], device)

    def map_rows(self, blocks: np.ndarray, axis: str, body) -> np.ndarray:
        """Scope collectives to ``axis``, as ``shard_map`` scopes a
        named axis's: ``body(parts, devices)`` runs once for each row of
        shards along ``axis`` (the other axes index the rows) with that
        row's blocks and devices in axis order, and returns the row's
        output blocks. -> the output blocks, shaped like the mesh."""
        n = self.axis_size(axis)
        ax = self.axis_names.index(axis)
        rows = np.moveaxis(blocks, ax, -1).reshape(-1, n)
        devs = np.moveaxis(self.devices, ax, -1).reshape(-1, n)
        out = np.empty(rows.shape, dtype=object)
        for r in range(rows.shape[0]):
            for j, t in enumerate(body(list(rows[r]), list(devs[r]))):
                out[r, j] = t
        return np.moveaxis(out.reshape(np.moveaxis(blocks, ax, -1).shape),
                           -1, ax)


def shift_right(parts: list, devices: list) -> list:
    """``ppermute`` over the pairs (i, i+1): shard i receives shard
    i-1's tensor on its own device, shard 0 zeros."""
    return ([torch.zeros_like(parts[0])]
            + [_on(p, d) for p, d in zip(parts[:-1], devices[1:])])


def all_gather(parts: list, device) -> torch.Tensor:
    """``all_gather`` once: the shards' tensors (small per-shard
    summaries) stacked along a new leading axis on ``device``."""
    device = torch.device(device)
    return torch.stack([_on(p, device) for p in parts])
