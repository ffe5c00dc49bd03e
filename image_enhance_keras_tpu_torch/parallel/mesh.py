"""Device meshes (mirror of ``parallel/mesh.py``).

A mesh is a 1-D (``("data",)``) or 2-D (``("dcn", "data")``) array of
:class:`MeshDevice` entries, each a ``torch.device`` of one process
(``process_index``, the rank in ``torch.distributed``, 0 without a process
group) with its local index ``id``; ``devices`` and ``axis_names`` read as
JAX's ``Mesh`` does.  The data-parallel engines and the trainer split their
batch (or a frame's rows) over the entries of their own process; other
processes' entries stand for the ranks a process group joins.

On CUDA, :func:`make_mesh` takes ``cuda:0 .. cuda:n-1`` and refuses more
entries than the process has cards.  An explicit ``devices`` list, repeats
allowed (``make_mesh(8, devices=["cpu"] * 8)``, or two entries of one card),
is the counterpart of XLA's ``--xla_force_host_platform_device_count``: it
lets the tests shard over 8 entries on the CPU and the smoke run shard over
one card.  It is a test affordance, not a way to gain speed: entries on one
device run one after another.

:func:`make_dcn_mesh` orders every process's entries host-major (rank, then
local index), so that each process's entries are contiguous on the data
axis; :func:`make_hybrid_mesh` makes the tiers explicit, one row a process.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "MeshDevice", "all_devices", "device_count", "make_mesh", "host_major_order", "make_dcn_mesh",
           "make_hybrid_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One entry of a mesh: ``device`` of the process ``process_index``, its local index ``id``."""

    process_index: int
    id: int
    device: torch.device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An array of :class:`MeshDevice` with one name per axis."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    def local_devices(self) -> list[torch.device]:
        """The torch devices of this process's entries, in mesh order (repeats kept)."""
        rank = _rank()
        return [d.device for d in self.devices.flat if d.process_index == rank]


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _array(entries: Sequence[Any], shape: tuple[int, ...]) -> np.ndarray:
    arr = np.empty(len(entries), dtype=object)
    for i, d in enumerate(entries):
        arr[i] = d
    return arr.reshape(shape)


def device_count() -> int:
    """The CUDA cards this process sees."""
    return torch.cuda.device_count()


def all_devices(entries: Sequence[str | torch.device] | None = None) -> list[MeshDevice]:
    """Every process's entries, rank-major: this process's ``entries`` (its
    CUDA cards when None), and the same local entries for each other rank
    of the process group (the ranks of one job are homogeneous)."""
    if entries is None:
        entries = [torch.device("cuda", i) for i in range(device_count())]
    local = [torch.device(e) for e in entries]
    return [MeshDevice(r, i, d) for r in range(_world()) for i, d in enumerate(local)]


def make_mesh(n_devices: int | None = None, axis: str = "data",
              devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of this process's CUDA cards
    (all of them when None), or of ``devices`` when given (repeats allowed).
    Raises ``ValueError`` for ``n_devices <= 0`` or more than there are."""
    local = [torch.device("cuda", i) for i in range(device_count())] if devices is None else \
        [torch.device(d) for d in devices]
    n = len(local) if n_devices is None else int(n_devices)
    if n <= 0 or n > len(local):
        raise ValueError(f"requested {n} devices, have {len(local)}")
    rank = _rank()
    return Mesh(_array([MeshDevice(rank, i, d) for i, d in enumerate(local[:n])], (n,)), (axis,))


def host_major_order(devs) -> list:
    """``devs`` sorted host-major (``process_index``, then ``id``): every
    process's entries contiguous along the data axis."""
    return sorted(devs, key=lambda d: (d.process_index, d.id))


def make_dcn_mesh(axis: str = "data", devices: Sequence[Any] | None = None) -> Mesh:
    """1-D data mesh over every process's entries in host-major order
    (:func:`all_devices` of ``devices``, or ``MeshDevice`` entries as given).
    With one process: the same entries as :func:`make_mesh`."""
    entries = _entries(devices)
    return Mesh(_array(host_major_order(entries), (len(entries),)), (axis,))


def make_hybrid_mesh(axis: str = "data", dcn_axis: str = "dcn", devices: Sequence[Any] | None = None) -> Mesh:
    """2-D ``(dcn, data)`` mesh: one row a process, its local entries along
    the row.  Every process must contribute as many entries; with one
    process, a (1, n) mesh."""
    entries = host_major_order(_entries(devices))
    per_host = Counter(d.process_index for d in entries)
    n_proc = len(per_host)
    local = len(entries) // n_proc
    # equal counts on every host: a divisible total over uneven hosts would
    # put one host's entry in another host's row
    if n_proc * local != len(entries) or len(set(per_host.values())) != 1:
        raise ValueError(f"hosts contribute unequal device counts ({dict(per_host)}); "
                         "the hybrid mesh needs a homogeneous job")
    return Mesh(_array(entries, (n_proc, local)), (dcn_axis, axis))


def _entries(devs) -> list:
    if devs is not None and all(hasattr(d, "process_index") for d in devs):
        return list(devs)
    return all_devices(devs)
