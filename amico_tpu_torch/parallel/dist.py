"""Multi-process execution layer (counterpart of ``amico_tpu.parallel.dist``).

Every process runs the same program and calls :func:`initialize`, which
joins a ``torch.distributed`` process group on the gloo backend; then:

* the voxel axis is split into per-process contiguous **slabs**
  (:func:`host_slab`): each process fits only its slab, on its own card;
* the small results (parameter maps, directions) are exchanged as host
  rows with :func:`allgather_rows`; files are written by process 0 only;
* collective decisions (skip a subject in a sweep) come from process 0
  through :func:`broadcast_scalar`.

gloo, because what crosses processes is host NumPy rows, as in the JAX
package (``process_allgather`` of ``np.asarray``), and gloo runs wherever
the ranks are: on one host, on many, several ranks on one card.  A failed
rendezvous raises; nothing here carries on as a single process.

Without a process group every query answers for one process (count 1,
index 0, coordinator), so single-process code paths need no special case.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.logging import AmicoError

# the cards this process was given by initialize(local_device_ids=...):
# process-wide, like the process group itself; None = every visible card
_local_device_ids: tuple | None = None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Join (or create) the process group.

    With explicit arguments the group meets at
    ``tcp://coordinator_address`` (``host:port``; process 0 listens there);
    with none, ``env://`` reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` as torchrun and SLURM wrappers set them.
    A no-op for ``num_processes=1`` and when a group already exists.
    ``local_device_ids`` pins this process to the first of those cards
    (``torch.cuda.set_device``) and limits :func:`mesh.make_mesh` to them.
    Raises when the rendezvous fails."""
    global _local_device_ids
    if num_processes == 1:
        return
    if tdist.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is None for a in explicit) \
            and not all(a is None for a in explicit):
        raise AmicoError('initialize() takes coordinator_address, '
                         'num_processes and process_id together (or none '
                         'of them, for env://)')
    ids = None
    if local_device_ids is not None:
        ids = tuple(int(i) for i in local_device_ids)
        if not ids or not torch.cuda.is_available() \
                or max(ids) >= torch.cuda.device_count():
            raise AmicoError(f'local_device_ids {list(ids)}: '
                             f'{torch.cuda.device_count()} card(s) visible')
        torch.cuda.set_device(ids[0])
    if coordinator_address is None:
        tdist.init_process_group('gloo', init_method='env://')
    else:
        tdist.init_process_group(
            'gloo', init_method=f'tcp://{coordinator_address}',
            world_size=int(num_processes), rank=int(process_id))
    _local_device_ids = ids


def local_device_ids() -> tuple | None:
    """The cards given to :func:`initialize`, or None (every visible card)."""
    return _local_device_ids


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def host_slab(n_items: int, index: int | None = None,
              count: int | None = None) -> slice:
    """Balanced contiguous slab of ``n_items`` for this process.

    The first ``n_items % count`` processes take one extra item, so slab
    sizes differ by at most one and concatenating all slabs in process
    order reconstructs the original axis.
    """
    count = process_count() if count is None else count
    index = process_index() if index is None else index
    base, extra = divmod(n_items, count)
    start = index * base + min(index, extra)
    stop = start + base + (1 if index < extra else 0)
    return slice(start, stop)


def allgather_rows(local_rows: np.ndarray, n_total: int) -> np.ndarray:
    """Concatenate per-process row slabs (process i contributed
    ``host_slab(n_total, i)``) into the full (n_total, ...) array on every
    process.

    Slabs may differ by one row, so each is zero-padded to the largest
    slab before the all-gather and trimmed after (the collective needs
    equal shapes).  The rows travel as bytes, so any dtype gathers exactly.
    """
    local = np.asarray(local_rows)
    count = process_count()
    if count == 1:
        return local
    max_rows = -(-n_total // count)
    pad = max_rows - local.shape[0]
    if pad:
        local = np.concatenate(
            [local, np.zeros((pad,) + local.shape[1:], local.dtype)])
    flat = np.ascontiguousarray(local).reshape(max_rows, -1).view(np.uint8)
    mine = torch.from_numpy(flat.copy())
    parts = [torch.empty_like(mine) for _ in range(count)]
    tdist.all_gather(parts, mine)
    rows = []
    for i, part in enumerate(parts):
        sl = host_slab(n_total, i, count)
        rows.append(part.numpy().view(local.dtype)
                    .reshape(local.shape)[:sl.stop - sl.start])
    return np.concatenate(rows, axis=0)


def broadcast_scalar(value) -> int:
    """The coordinator's value of an int scalar, on every process.

    For decisions that must be collective (e.g. skip-subject in a sweep):
    per-host filesystems can disagree about what exists -- only process 0
    writes results -- so each process deciding from its own disk desyncs
    the collectives that follow.  Single-process: identity.
    """
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    tdist.broadcast(t, src=0)
    return int(t.item())


def barrier(name: str = 'amico_tpu') -> None:
    """Wait until every process reaches the barrier of the same ``name``
    (the name documents the call site; the group pairs barriers by
    order)."""
    if process_count() > 1:
        tdist.barrier()
