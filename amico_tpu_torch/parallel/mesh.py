"""Device-mesh voxel data parallelism (counterpart of
``amico_tpu.parallel.mesh``).

A 1-D ``('data',)`` mesh over this process's cards.  The tile driver
(``models/base.py::_run_tiled_fit``) hands whole chunks of voxel tiles to
the mesh's devices round robin; every dictionary and Gram is built once on
each device (they are small), and the solve needs no collective: the
problem is embarrassingly parallel.  ``masked_mean`` reduces each shard on
its own device and sums the partials, for whole-volume statistics.

Multi-process runs (``parallel.dist``) give each process its own slab of
voxels and its own host-local mesh.
"""
from __future__ import annotations

import torch

from ..utils.logging import AmicoError
from . import dist

DATA_AXIS = 'data'


class Mesh:
    """A 1-D mesh: ``devices`` (a tuple of ``torch.device``) along
    ``axis_names[0]``.  A live mesh is runtime state and does not pickle:
    ``config.pickle`` records it by its repr, as the JAX package records
    its ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names=(DATA_AXIS,)):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise AmicoError('a mesh needs at least one device')
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return (f'Mesh(devices={[str(d) for d in self.devices]}, '
                f'axis_names={self.axis_names})')

    def __reduce__(self):
        raise TypeError('a device mesh is runtime state and does not pickle')


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS,
              device='cuda') -> Mesh:
    """1-D mesh over (the first ``n_devices`` of) this process's cards.

    Host-local on purpose: under ``parallel.dist`` each process fits its
    own voxel slab on its own cards, so the mesh holds only the cards this
    process was given (``dist.initialize(local_device_ids=...)``, else
    every visible one).  Raises without a card.  ``device='cpu'`` gives
    ``n_devices`` (default 1) CPU entries, which run the kernels' plain
    versions: the CPU tests' stand-in for a multi-card host."""
    dev = torch.device(device)
    if dev.type == 'cpu':
        return Mesh([dev] * (1 if n_devices is None else int(n_devices)),
                    (axis_name,))
    if dev.type != 'cuda':
        raise AmicoError(f'make_mesh: device must be "cuda" or "cpu", '
                         f'got "{device}"')
    if not torch.cuda.is_available():
        raise AmicoError('make_mesh: no CUDA card is available; '
                         "make_mesh(n, device='cpu') runs the plain "
                         'PyTorch path')
    ids = dist.local_device_ids() or range(torch.cuda.device_count())
    devs = [torch.device('cuda', i) for i in ids]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise AmicoError(f'make_mesh: {n_devices} devices asked, '
                             f'{len(devs)} card(s) available')
        devs = devs[:n_devices]
    return Mesh(devs, (axis_name,))


class Placement:
    """Where a tensor goes on a mesh: ``split`` cuts its leading (tile)
    axis into contiguous pieces, one per device in mesh order (the first
    ``len % size`` pieces one longer); otherwise each device gets a
    copy."""

    def __init__(self, mesh: Mesh, split: bool):
        self.mesh, self.split = mesh, split

    def __repr__(self):
        return f'Placement({self.mesh!r}, split={self.split})'

    def place(self, x) -> list:
        """The per-device tensors of ``x`` (a tensor or an array)."""
        x = torch.as_tensor(x)
        parts = torch.tensor_split(x, self.mesh.size) if self.split \
            else [x] * self.mesh.size
        return [p.to(d) for p, d in zip(parts, self.mesh.devices)]


def tile_sharding(mesh: Mesh) -> Placement:
    """Split the leading (tile) axis across the data axis."""
    return Placement(mesh, split=True)


def replicated(mesh: Mesh) -> Placement:
    """A copy on every device of the mesh."""
    return Placement(mesh, split=False)


def shard_tiles(mesh: Mesh, *arrays):
    """Tile-major arrays placed with :func:`tile_sharding`: for each array,
    its list of per-device shards."""
    sh = tile_sharding(mesh)
    out = tuple(sh.place(a) for a in arrays)
    return out if len(out) > 1 else out[0]


def masked_mean(values, valid):
    """Mean of per-voxel statistics over the valid voxels.

    ``values`` and ``valid`` are tensors (or arrays), or lists of
    per-device shards as :func:`shard_tiles` gives them: each shard is
    reduced on its own device, and the partial sums meet on the first
    shard's device.  Returns a 0-dim tensor there."""
    if not isinstance(values, (list, tuple)):
        values, valid = [values], [valid]
    total = count = None
    for v, m in zip(values, valid):
        v = torch.as_tensor(v)
        m = torch.as_tensor(m, device=v.device).to(v.dtype)
        s, c = (v * m).sum(), m.sum()
        if total is None:
            total, count = s, c
        else:
            total = total + s.to(total.device)
            count = count + c.to(count.device)
    return total / torch.clamp(count, min=1.0)
