"""Device meshes and the process group behind them (port of
``bvsc_tpu/parallel/mesh.py`` and of the mesh constructors of its ``tp``,
``sp`` and ``pp``).

A :class:`Mesh` is an array of torch devices with one name per axis.  It
serves two styles:

* **single controller**: one process drives every device of the mesh (the
  serving engines' ``mesh=``: each device holds a replica of the weights
  and a contiguous block of the slots);
* **SPMD**, torch.distributed's style: one process per rank, each running
  the body that ``shard_map`` ran in the JAX package (tensor, sequence and
  pipeline parallelism, the data-parallel trainers).  Rank r owns the
  device at flat index r of the mesh (row-major over its axes), and each
  axis carries the process subgroup of the ranks that differ only along it
  (:meth:`Mesh.axis`).

A mesh is SPMD when ``torch.distributed`` is initialised with as many ranks
as the mesh has devices, and single-controller otherwise.  Every rank must
build the same meshes in the same order: each builds the subgroups of every
axis (``dist.new_group`` is collective).

Devices are named, never guessed: :func:`make_mesh` raises when fewer CUDA
cards exist than asked for (the JAX package's fallback to virtual CPU
devices would hide which device ran).  Tests list ``["cpu"] * n``; two ranks
may share one card by listing it twice.  The backend follows the device
(NCCL on CUDA, gloo on the CPU) unless named; NCCL refuses two ranks on
one card, so such a run names gloo.  ``parallel.collectives`` builds every
exchange from ``all_reduce`` and ``broadcast``, the two collectives each
backend takes for each device type.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DEFAULT_TIMEOUT_S = 300.0  # a collective that waits longer fails the run


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index along
    it, the global ranks along it (index order) and their process group
    (None where the axis has one device)."""

    name: str
    size: int
    index: int
    ranks: tuple[int, ...]
    group: object | None


def _devices(devices) -> list[torch.device]:
    return [torch.device(d) for d in devices]


def take_devices(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The mesh's devices, in order: ``devices`` as given, or the first
    ``n_devices`` CUDA cards (default: one a rank of an initialised process
    group, else every card).  Raises when fewer cards exist; nothing falls
    back to the CPU."""
    if devices is not None:
        devs = _devices(devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} listed")
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return devs
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else have
    if n_devices < 1 or n_devices > have:
        raise ValueError(f"requested {n_devices} CUDA devices, only {have} available; list "
                         "the devices (devices=[...]) to run elsewhere or to share a card")
    return [torch.device("cuda", i) for i in range(n_devices)]


class Mesh:
    """Devices laid out over named axes; SPMD when the process group spans
    it (module docstring)."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        shape = src.shape
        arr = np.empty(src.size, dtype=object)
        arr[:] = _devices(src.reshape(-1).tolist())
        if len(shape) != len(axis_names):
            raise ValueError(f"a {len(shape)}-D device array for axes {axis_names}")
        self.devices = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = int(arr.size)
        self.rank: int | None = None
        self._axes: dict[str, Axis] = {}
        if dist.is_initialized() and dist.get_world_size() == self.size:
            self._bind(dist.get_rank())

    def _bind(self, rank: int) -> None:
        """This rank's coordinates and the subgroup of every axis (every
        rank builds every group, in the same order)."""
        self.rank = rank
        coords = np.unravel_index(rank, self.devices.shape)
        ids = np.arange(self.size).reshape(self.devices.shape)
        for a, name in enumerate(self.axis_names):
            size, mine = self.devices.shape[a], None
            if size > 1:
                others = [range(n) for i, n in enumerate(self.devices.shape) if i != a]
                for rest in itertools.product(*others):
                    idx = list(rest)
                    idx.insert(a, slice(None))
                    ranks = tuple(int(r) for r in ids[tuple(idx)])
                    group = (dist.group.WORLD if size == self.size
                             else dist.new_group(list(ranks)))
                    if rank in ranks:
                        mine = (ranks, group)
            ranks, group = mine if mine else ((rank,), None)
            self._axes[name] = Axis(name, size, int(coords[a]), ranks, group)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    @property
    def spmd(self) -> bool:
        return self.rank is not None

    def _require_spmd(self) -> None:
        if not self.spmd:
            raise ValueError("this needs an SPMD mesh: one process per device, with "
                             "torch.distributed initialised over all of them "
                             "(parallel.mesh.init_distributed)")

    @property
    def device(self) -> torch.device:
        """This rank's device (SPMD)."""
        self._require_spmd()
        return self.devices.reshape(-1)[self.rank]

    def axis(self, name: str) -> Axis:
        """This rank's view of axis ``name`` (SPMD); an axis the mesh lacks
        is one of size 1."""
        self._require_spmd()
        if name not in self.shape:
            return Axis(name, 1, 0, (self.rank,), None)
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_devices: int | None = None, devices=None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh (data parallelism by default) over :func:`take_devices`."""
    return Mesh(take_devices(n_devices, devices), (axis_name,))


def make_2d_mesh(n_outer: int, n_inner: int, axis_names: tuple[str, str], devices=None) -> Mesh:
    """(n_outer, n_inner) mesh over :func:`take_devices`, row-major."""
    devs = take_devices(n_outer * n_inner, devices)
    grid = np.empty((n_outer, n_inner), dtype=object)
    grid.reshape(-1)[:] = devs
    return Mesh(grid, axis_names)


def row_blocks(rows: int, n: int) -> list[slice]:
    """The contiguous blocks of ``rows`` leading-axis rows, one per shard
    (``P('data')``'s layout); raises where they do not divide."""
    if rows % n:
        raise ValueError(f"{rows} rows do not divide over {n} shards")
    k = rows // n
    return [slice(i * k, (i + 1) * k) for i in range(n)]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def replicated(mesh: Mesh, tree):
    """``tree``'s tensors on every device of the mesh: a list in device
    order (single controller), or on this rank's device (SPMD)."""
    if mesh.spmd:
        return _map(tree, lambda t: t.to(mesh.device))
    return [_map(tree, lambda t, d=d: t.to(d)) for d in mesh.devices.reshape(-1)]


def batch_sharded(mesh: Mesh, tree, axis_name: str = DATA_AXIS):
    """The leading-axis blocks of ``tree``'s tensors over ``axis_name``: one
    block a device (single controller, a list in device order; the mesh's
    other axes repeat the block), or this rank's block on its device
    (SPMD)."""
    if mesh.spmd:
        ax = mesh.axis(axis_name)
        return _map(tree, lambda t: t[row_blocks(t.shape[0], ax.size)[ax.index]].to(mesh.device))
    n, a = mesh.shape.get(axis_name, 1), (mesh.axis_names.index(axis_name)
                                          if axis_name in mesh.shape else None)
    out = []
    for flat, dev in enumerate(mesh.devices.reshape(-1)):
        i = 0 if a is None else int(np.unravel_index(flat, mesh.devices.shape)[a])
        out.append(_map(tree, lambda t, i=i, dev=dev: t[row_blocks(t.shape[0], n)[i]].to(dev)))
    return out


def shard_batch(mesh: Mesh, batch, axis_name: str = DATA_AXIS):
    """SPMD: each rank passes its LOCAL rows (its dataset shard) and gets
    the global batch on its device, the ranks' blocks in index order along
    ``axis_name`` (an all-gather).  Single controller: as
    :func:`batch_sharded`."""
    if not mesh.spmd:
        return batch_sharded(mesh, batch, axis_name)
    from bvsc_tpu_torch.parallel.collectives import all_gather

    ax = mesh.axis(axis_name)
    return _map(batch, lambda t: all_gather(torch.as_tensor(t).to(mesh.device), ax, 0))


def init_distributed(coordinator_address: str, num_processes: int, process_id: int,
                     backend: str | None = None, device=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: ``coordinator_address`` is ``host:port`` of
    process 0 (TCP) or a ``file://`` path every process shares.  The
    backend follows ``device`` (NCCL for CUDA, default; gloo for the CPU)
    unless named; two ranks on one card need ``backend='gloo'``.  A
    collective that waits ``timeout_s`` raises."""
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address needs --num_processes and --process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside 0..{num_processes - 1}")
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
