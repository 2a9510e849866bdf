"""Halo exchange over a device mesh.

Counterpart of ``nd_tpu/parallel/halo.py``. ``shard_apply`` splits a
cube into one block per mesh position (after the JAX package's
divisibility pad in the boundary mode), places each block on its
position's device, pads every block with ``halo`` rows of its
neighbours' data along each sharded axis (global edges take the
kernel's own boundary condition), runs the windowed kernel on each
padded block on its device, trims the halo and stitches the blocks.
Outputs equal the unsharded kernel's wherever ``halo`` covers the
kernel radius: the kernels compute each output from its window alone.

The axes are exchanged in ``sharded_axes`` order, and the slabs of a
later axis are cut from blocks already padded along the earlier ones,
so that the corners of a padded block hold the diagonal neighbours'
data, which a 2-D window reads.

In one process the blocks run one after another: launches are
asynchronous, so blocks on distinct cards overlap without threads, and
blocks on one card run back to back on its current stream. On a mesh
whose positions belong to several processes
(``parallel.distributed.global_mesh``) each process runs its own
positions' blocks and sends edge slabs to the other processes with
``torch.distributed.batch_isend_irecv``: under NCCL the slabs stay on
the card; under gloo, whose point-to-point takes CPU tensors only, they
go through host memory.

``halo_bytes`` counts the bytes of the edge slabs that blocks took from
other blocks (the interconnect traffic of a mesh of cards), not the
boundary fill.
"""

from __future__ import annotations

import contextlib
from collections import namedtuple

import numpy as np
import torch

from .. import _build
from ..core.variable import as_tensor
from ..ops.conv import _SCIPY_TO_NP_PAD, pad_reflect
from .mesh import _join_grid

__all__ = ['ShardedArray', 'halo_pad', 'halo_trim', 'shard_apply',
           'halo_bytes', 'reset_halo_bytes']

MODES = ('symmetric', 'reflect', 'edge', 'constant', 'wrap')
# numpy.pad names (the halo's) -> scipy.ndimage names (ops.conv's)
_NP_TO_SCIPY = {np_name: scipy_name
                for scipy_name, np_name in _SCIPY_TO_NP_PAD.items()}

halo_bytes = 0         # bytes of neighbour slabs exchanged since reset


def reset_halo_bytes():
    global halo_bytes
    halo_bytes = 0


def _count(nbytes):
    global halo_bytes
    with _build.state_lock:
        halo_bytes += int(nbytes)


def on_device(device):
    """The context that makes ``device`` current for launches."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


Shard = namedtuple('Shard', ['position', 'device', 'index', 'data'])


class ShardedArray:
    """A global array held as one block per mesh position.

    Parameters
    ----------
    mesh : parallel.mesh.Mesh
    shape : tuple of int
        The global shape.
    spec : tuple
        Per array axis, the mesh axis it is split over, or None.
    chunks : tuple of int
        Per array axis, a block's length (the last blocks of an axis
        that does not divide may be shorter, or empty).
    blocks : dict
        Position (an index tuple into the mesh) -> tensor on that
        position's device; the positions of this process only, one per
        distinct block (mesh axes absent from ``spec`` hold replicas and
        keep index 0).
    """

    def __init__(self, mesh, shape, spec, chunks, blocks):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.chunks = tuple(int(c) for c in chunks)
        self.blocks = dict(blocks)

    def index(self, position):
        """The slices of the global array that ``position``'s block
        holds."""
        out = []
        for axis, name in enumerate(self.spec):
            if name is None:
                out.append(slice(0, self.shape[axis]))
                continue
            j = position[self.mesh.axis_names.index(name)]
            size, chunk = self.shape[axis], self.chunks[axis]
            out.append(slice(min(j * chunk, size),
                             min((j + 1) * chunk, size)))
        return tuple(out)

    @property
    def addressable_shards(self):
        """This process's blocks: (position, device, index, data)."""
        return [Shard(pos, data.device, self.index(pos), data)
                for pos, data in self.blocks.items()]

    def gather(self, device=None):
        """The whole array as one tensor on ``device`` (default: the
        first block's); it needs every block in this process."""
        sharded = [(axis, name) for axis, name in enumerate(self.spec)
                   if name is not None]
        names = self.mesh.axis_names
        by_index = {}
        for pos, data in self.blocks.items():
            key = tuple(pos[names.index(name)] for _, name in sharded)
            by_index.setdefault(key, data)
        counts = [self.mesh.shape[name] for _, name in sharded]
        if len(by_index) != int(np.prod(counts, dtype=np.int64)):
            raise ValueError('this process holds %d of the %d blocks; a '
                             'sharded array across processes is read '
                             'through addressable_shards'
                             % (len(by_index), int(np.prod(counts))))
        if device is None:
            device = next(iter(self.blocks.values())).device
        return _join_grid({k: v.to(device) for k, v in by_index.items()},
                          counts, lambda parts, level: torch.cat(
                              parts, dim=sharded[level][0]))


def _block_positions(mesh, spec, local=True):
    """The positions that hold distinct blocks (index 0 along mesh axes
    the array is not split over), row-major: this process's, or with
    ``local=False`` every process's."""
    named = set(n for n in spec if n is not None)
    return [pos for pos in mesh.positions()
            if not any(pos[k] for k, name in enumerate(mesh.axis_names)
                       if name not in named)
            and (not local or mesh.is_local(pos))]


def place(arr, mesh, spec, chunks):
    """``arr`` (the global tensor, already divisible along ``spec``'s
    axes) as a ShardedArray: one block of ``chunks`` per position of
    this process, copied to the position's device."""
    if mesh.spans_processes:
        lost = [name for name, n in mesh.shape.items()
                if n > 1 and name not in spec]
        if lost:
            raise ValueError('a mesh across processes replicates no axis; '
                             'shard every axis of more than one position '
                             '(%r is not)' % (lost,))
    blocks = {}
    names = mesh.axis_names
    for pos in _block_positions(mesh, spec):
        data = arr
        for axis, name in enumerate(spec):
            if name is not None:
                j = pos[names.index(name)]
                data = data.narrow(axis, j * chunks[axis], chunks[axis])
        blocks[pos] = data.to(mesh.device(pos))
    return ShardedArray(mesh, arr.shape, spec, chunks, blocks)


def _boundary_slab(x, axis, halo, mode, side, cval=0.0):
    """The pad slab a global-boundary block supplies for itself."""
    size = x.shape[axis]
    if mode == 'symmetric':
        sl = x.narrow(axis, 0, halo) if side == 'left' \
            else x.narrow(axis, size - halo, halo)
        return torch.flip(sl, (axis,))
    if mode == 'reflect':
        sl = x.narrow(axis, 1, halo) if side == 'left' \
            else x.narrow(axis, size - halo - 1, halo)
        return torch.flip(sl, (axis,))
    if mode == 'edge':
        sl = x.narrow(axis, 0, 1) if side == 'left' \
            else x.narrow(axis, size - 1, 1)
        reps = [1] * x.ndim
        reps[axis] = halo
        return sl.repeat(reps)
    if mode == 'constant':
        shape = list(x.shape)
        shape[axis] = halo
        return torch.full(shape, cval, dtype=x.dtype, device=x.device)
    raise ValueError('unsupported halo mode %r' % mode)


def _edge(block, axis, halo, side):
    """A block's ``side`` edge slab, the one its neighbour on that side
    takes."""
    size = block.shape[axis]
    return block.narrow(axis, 0 if side == 'left' else size - halo, halo)


def _exchange(mesh, messages, blocks, axis, halo):
    """Send and receive the slabs between processes. ``messages`` lists
    (receiving position, side, sending position) in the same order in
    every process; returns {(position, side): slab on its device}."""
    import torch.distributed as dist
    me = dist.get_rank()
    # gloo's point-to-point takes CPU tensors only: under it the slabs
    # go through host memory; NCCL sends them from the card
    via_host = dist.get_backend() == 'gloo'
    ops, received = [], {}
    for tag, (pos, side, src) in enumerate(messages):
        if mesh.ranks[src] == me:
            slab = _edge(blocks[src], axis, halo,
                         'right' if side == 'left' else 'left').contiguous()
            if via_host:
                slab = slab.cpu()
            ops.append(dist.P2POp(dist.isend, slab, int(mesh.ranks[pos]),
                                  tag=tag))
        elif mesh.ranks[pos] == me:
            like = blocks[pos]
            shape = list(like.shape)
            shape[axis] = halo
            buf = torch.empty(shape, dtype=like.dtype,
                              device='cpu' if via_host else like.device)
            ops.append(dist.P2POp(dist.irecv, buf, int(mesh.ranks[src]),
                                  tag=tag))
            received[(pos, side)] = buf
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = {}
    for (pos, side), buf in received.items():
        _count(buf.numel() * buf.element_size())
        out[(pos, side)] = buf.to(blocks[pos].device)
    return out


def halo_pad(x, axis_name, axis, halo, mode='symmetric', cval=0.0):
    """Pad every block of a ShardedArray with ``halo`` entries per side
    along array ``axis`` (split over mesh axis ``axis_name``).

    Interior sides take their neighbour's edge slab, copied to the
    block's device (sent by another process where the neighbour is
    remote); global boundary sides are filled per ``mode`` (numpy.pad
    naming: 'symmetric' == scipy.ndimage 'reflect'; 'wrap' takes the
    opposite edge). Returns a ShardedArray of the padded blocks.
    """
    if halo == 0:
        return x
    mesh = x.mesh
    k = mesh.axis_names.index(axis_name)
    n = mesh.shape[axis_name]
    for pos, block in x.blocks.items():
        size = block.shape[axis]
        # 'reflect' (edge excluded) mirrors indices 1..halo, so it needs
        # one row more than the halo itself
        limit = size - 1 if mode == 'reflect' else size
        if halo > limit:
            raise ValueError(
                'halo (%d) exceeds the largest supported value (%d) for a '
                'shard of %d rows with mode %r along %r — use fewer shards'
                % (halo, limit, size, mode, axis_name))

    def neighbour(pos, side):
        j = pos[k] + (-1 if side == 'left' else 1)
        if not 0 <= j < n:
            if mode != 'wrap':
                return None
            j %= n
        return pos[:k] + (j,) + pos[k + 1:]

    messages = []
    if mesh.spans_processes:
        for pos in _block_positions(mesh, x.spec, local=False):
            for side in ('left', 'right'):
                src = neighbour(pos, side)
                if src is not None and mesh.ranks[src] != mesh.ranks[pos]:
                    messages.append((pos, side, src))
    remote = _exchange(mesh, messages, x.blocks, axis, halo) \
        if messages else {}

    out = {}
    for pos, block in x.blocks.items():
        pads = []
        for side in ('left', 'right'):
            src = neighbour(pos, side)
            if src is None:
                pads.append(_boundary_slab(block, axis, halo, mode, side,
                                           cval))
            elif (pos, side) in remote:
                pads.append(remote[(pos, side)])
            else:
                slab = _edge(x.blocks[src], axis, halo,
                             'right' if side == 'left' else 'left')
                if src != pos:
                    _count(slab.numel() * slab.element_size())
                pads.append(slab.to(block.device))
        out[pos] = torch.cat([pads[0], block, pads[1]], dim=axis)
    return ShardedArray(mesh, x.shape, x.spec, x.chunks, out)


def halo_trim(x, axis, halo):
    """Drop ``halo`` entries from both ends of ``axis``."""
    if halo == 0:
        return x
    return x.narrow(axis, halo, x.shape[axis] - 2 * halo)


def _divisible(arr, mesh, sharded_axes, mode, cval):
    """The JAX package's decomposition: each sharded axis padded at its
    end in the boundary mode until it divides the mesh, by at least
    ``halo``. Returns (padded tensor, chunk per axis)."""
    pads = [(0, 0)] * arr.ndim
    chunks = list(arr.shape)
    for axis_name, (axis, halo) in sharded_axes.items():
        n_shards = mesh.shape[axis_name]
        size = arr.shape[axis]
        rem = (-size) % n_shards
        if rem:
            if mode == 'wrap':
                # Padding breaks periodicity: the wrap exchange would
                # hand block 0 rows from the pad region instead of the
                # true opposite edge. Callers must pick a divisible
                # decomposition (apply_sharded drops such axes).
                raise ValueError(
                    "mode='wrap' requires the %r axis size (%d) to "
                    'divide the mesh (%d shards)'
                    % (axis_name, size, n_shards))
            # The pad must be at least `halo` wide, otherwise outputs
            # near the true edge would see the last block's local
            # boundary slab instead of the global boundary condition.
            while 0 < rem < halo:
                rem += n_shards
            pads[axis] = (0, rem)
        chunks[axis] = (size + rem) // n_shards
    if any(p != (0, 0) for p in pads):
        arr = pad_reflect(arr, pads, mode=_NP_TO_SCIPY[mode], cval=cval)
    return arr, tuple(chunks)


def shard_blocks(fn, arr, mesh, sharded_axes, mode='symmetric', cval=0.0):
    """:func:`shard_apply` without the stitch: the result as a
    ShardedArray of this process's blocks (cropped to the global
    shape)."""
    if mode not in MODES:
        raise ValueError('unsupported boundary mode %r' % mode)
    if isinstance(arr, ShardedArray):
        x = arr
        for axis_name, (axis, _) in sharded_axes.items():
            if x.spec[axis] != axis_name \
                    or x.chunks[axis] * mesh.shape[axis_name] \
                    != x.shape[axis]:
                raise ValueError(
                    'a ShardedArray must be split evenly over %r along '
                    'axis %d (spec %r, chunks %r, shape %r)'
                    % (axis_name, axis, x.spec, x.chunks, x.shape))
        if set(n for n in x.spec if n is not None) != set(sharded_axes):
            raise ValueError('the array is split over %r, the call over %r'
                             % (x.spec, tuple(sharded_axes)))
    else:
        spec = [None] * arr.ndim
        for axis_name, (axis, _) in sharded_axes.items():
            spec[axis] = axis_name
        padded, chunks = _divisible(arr, mesh, sharded_axes, mode, cval)
        x = place(padded, mesh, tuple(spec), chunks)
        x.shape = tuple(arr.shape)

    for axis_name, (axis, halo) in sharded_axes.items():
        x = halo_pad(x, axis_name, axis, halo, mode=mode, cval=cval)

    out = {}
    for pos, block in x.blocks.items():
        with on_device(block.device):
            y = fn(block)
        for axis_name, (axis, halo) in sharded_axes.items():
            y = halo_trim(y, axis, halo)
        for axis, sl in enumerate(x.index(pos)):
            size = sl.stop - sl.start
            if x.spec[axis] is not None and y.shape[axis] != size:
                y = y.narrow(axis, 0, size)
        out[pos] = y
    first = next(iter(out.values()))
    shape = tuple(x.shape[a] if x.spec[a] is not None else first.shape[a]
                  for a in range(first.ndim))
    chunks = tuple(x.chunks[a] if x.spec[a] is not None else first.shape[a]
                   for a in range(first.ndim))
    return ShardedArray(mesh, shape, x.spec, chunks, out)


def shard_apply(fn, arr, mesh, sharded_axes, mode='symmetric', cval=0.0):
    """Run a windowed kernel sharded over a mesh with halo exchange.

    Parameters
    ----------
    fn : callable
        Tensor function; must produce an output of the same shape along
        the sharded axes (it sees the halo-padded block and its output
        halo is trimmed). It runs with the block's device current.
    arr : torch.Tensor or ShardedArray
        The global input (numpy lands on ``cuda``), or blocks already on
        the mesh (``distributed.cube_from_process_tiles``, split evenly).
    mesh : parallel.mesh.Mesh
    sharded_axes : dict
        ``{axis_name: (array_axis, halo)}``.
    mode : str, optional
        Boundary fill mode at the global edges (numpy.pad naming).
    cval : float, optional
        The fill of mode 'constant'.

    Returns
    -------
    A tensor on ``arr``'s device for a tensor on a mesh of this process
    alone; otherwise a ShardedArray of this process's blocks.
    """
    if not isinstance(arr, ShardedArray):
        arr = as_tensor(arr)
    out = shard_blocks(fn, arr, mesh, sharded_axes, mode=mode, cval=cval)
    if isinstance(arr, ShardedArray) or mesh.spans_processes:
        return out
    return out.gather(arr.device)
