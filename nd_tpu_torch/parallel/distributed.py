"""Multi-process execution over ``torch.distributed``.

Counterpart of ``nd_tpu/parallel/distributed.py``. PyTorch runs one
process per device (or per group of devices): each process loads only
its own tile of the cube (``host_local_slices``), holds it as the blocks
of its mesh positions (``cube_from_process_tiles``), and
``parallel.halo.shard_apply`` sends the edge slabs between processes.
No process ever holds the whole cube.

Nothing here discovers a cluster: pass ``initialize`` the coordinator's
address, the process count and this process's rank (or set the
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` variables that
``torchrun`` sets and pass none). NCCL takes one process per card; two
processes that share a card, or CPU processes, take gloo, whose
point-to-point and collectives move CPU tensors: the port stages CUDA
slabs through host memory under it (``halo._exchange``,
:func:`all_reduce_sum`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from .halo import ShardedArray
from .mesh import Mesh

__all__ = ['initialize', 'process_info', 'global_mesh',
           'cube_from_process_tiles', 'host_local_slices', 'all_reduce_sum']

_local_devices = None      # the devices this process drives (initialize)


def _default_local_devices():
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device('cuda', i) for i in range(count)]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend='gloo', local_devices=None):
    """Join (or form) the process group; idempotent.

    Parameters
    ----------
    coordinator_address : str, optional
        ``host:port`` of rank 0 (``tcp://`` is added); without it the
        ``env://`` variables are read.
    num_processes, process_id : int, optional
        World size and this process's rank.
    backend : str, optional
        'gloo' (default: CPU processes, or processes that share a card)
        or 'nccl' (one process per card).
    local_devices : list of torch.device, optional
        The devices this process drives, in mesh order (default: every
        visible CUDA device).

    A second call leaves the first configuration in effect, and warns
    when it passes explicit arguments.
    """
    global _local_devices
    if dist.is_initialized():
        if coordinator_address is not None or process_id is not None \
                or num_processes is not None:
            # a second call with explicit arguments cannot take effect;
            # silence would let a caller believe it joined another group
            warnings.warn(
                'torch.distributed is already initialized; the arguments '
                'of this initialize() call are IGNORED (the first '
                'configuration stays in effect)', RuntimeWarning,
                stacklevel=2)
        return
    if coordinator_address is None:
        dist.init_process_group(backend, init_method='env://')
    else:
        address = coordinator_address if '://' in coordinator_address \
            else 'tcp://' + coordinator_address
        dist.init_process_group(backend, init_method=address,
                                world_size=int(num_processes),
                                rank=int(process_id))
    _local_devices = None if local_devices is None \
        else [torch.device(d) for d in local_devices]


def _devices_here():
    return list(_local_devices) if _local_devices is not None \
        else _default_local_devices()


def process_info():
    """(process_index, process_count, local_device_count)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), len(_devices_here())
    return 0, 1, len(_devices_here())


def global_mesh(axis_names=('y', 'x'), shape=None):
    """A mesh over the devices of all processes.

    Every process drives the same number of local devices (those of
    ``initialize``); position ``r * local + j`` (row-major) is process
    ``r``'s ``j``-th device. By default y is laid across processes and x
    across each process's devices, so that only the y halo crosses a
    process boundary.
    """
    local = _devices_here()
    if not local:
        raise RuntimeError('global_mesh() found no local device; pass '
                           'local_devices= to initialize')
    _, world, _ = process_info()
    n = world * len(local)
    if shape is None:
        shape = (world, len(local))
    devices = np.empty(n, dtype=object)
    devices[:] = [local[j] for _ in range(world) for j in range(len(local))]
    ranks = np.repeat(np.arange(world), len(local))
    return Mesh(devices.reshape(shape), axis_names,
                ranks=ranks.reshape(shape))


def _spec(mesh, ndim, dims):
    return tuple(dims[i] if i < len(dims) and dims[i] in mesh.axis_names
                 else None for i in range(ndim))


def _local_indices(mesh, global_shape, spec):
    """{position: slices} of this process's positions (even blocks,
    ceil-sized, as a NamedSharding splits)."""
    chunks = []
    for axis, name in enumerate(spec):
        size = global_shape[axis]
        chunks.append(size if name is None
                      else -(-size // mesh.shape[name]))
    probe = ShardedArray(mesh, global_shape, spec, chunks, {})
    return {pos: probe.index(pos) for pos in mesh.positions()
            if mesh.is_local(pos)}, chunks


def host_local_slices(mesh, global_shape, dims=('y', 'x')):
    """The slice of the global cube this process is responsible for.

    Returns a dict dim -> slice for loading only the local tile from
    the tile store (``nd_tpu_torch.tiling``, ``open_dataset(chunks=)``).
    """
    spec = _spec(mesh, len(global_shape), dims)
    idx_map, _ = _local_indices(mesh, global_shape, spec)
    n = len(global_shape)
    lo = [min(sl[d].start for sl in idx_map.values()) for d in range(n)]
    hi = [max(sl[d].stop for sl in idx_map.values()) for d in range(n)]
    # the bounding box is only the process's slice when its blocks tile
    # the box exactly: on meshes whose process positions are not a
    # contiguous block the box over-covers rows owned by OTHER processes
    box_cells = int(np.prod([hi[d] - lo[d] for d in range(n)]))
    unique = {tuple((s.start, s.stop) for s in v) for v in idx_map.values()}
    shard_cells = sum(int(np.prod([b - a for a, b in sl])) for sl in unique)
    if shard_cells != box_cells:
        raise ValueError(
            "this process's shards are not contiguous along the mesh "
            'dims (its positions do not form one block of the mesh); lay '
            'the mesh out with process-contiguous blocks (see '
            'global_mesh) or load per-shard instead of per-process')
    return {dim: slice(lo[i], hi[i]) for i, dim in enumerate(dims)}


def cube_from_process_tiles(local_array, mesh, global_shape,
                            dims=('y', 'x')):
    """Assemble a sharded cube from this process's tile.

    ``local_array`` (numpy or a tensor) is this process's slice, as
    :func:`host_local_slices` returns it; it is cut into the blocks of
    the process's positions, each copied to its position's device. The
    result is a ShardedArray that holds those blocks only: no process
    ever holds the full cube. The sharded axes must divide the mesh.
    """
    spec = _spec(mesh, len(global_shape), dims)
    for axis, name in enumerate(spec):
        if name is not None and global_shape[axis] % mesh.shape[name]:
            raise ValueError('axis %d (%d) does not divide the mesh axis %r '
                             '(%d)' % (axis, global_shape[axis], name,
                                       mesh.shape[name]))
    idx_map, chunks = _local_indices(mesh, global_shape, spec)
    lo = [min(sl[d].start for sl in idx_map.values())
          for d in range(len(global_shape))]
    if not isinstance(local_array, torch.Tensor):
        local_array = torch.from_numpy(np.ascontiguousarray(local_array))
    blocks = {}
    for pos, index in idx_map.items():
        part = local_array[tuple(slice(s.start - o, s.stop - o)
                                 for s, o in zip(index, lo))]
        blocks[pos] = part.to(mesh.device(pos))
    return ShardedArray(mesh, global_shape, spec, chunks, blocks)


def all_reduce_sum(tensor):
    """The sum of ``tensor`` over every process, on its device. Under
    gloo, whose collectives take CPU tensors, a CUDA tensor goes through
    host memory; NCCL reduces it on the card. Without a process group it
    returns ``tensor``."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tensor
    if dist.get_backend() == 'gloo' and tensor.device.type != 'cpu':
        host = tensor.cpu()
        dist.all_reduce(host)
        return host.to(tensor.device)
    out = tensor.clone()
    dist.all_reduce(out)
    return out
