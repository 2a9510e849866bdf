"""Device meshes.

Counterpart of ``nd_tpu/parallel/mesh.py``. A :class:`Mesh` is a grid of
devices with named axes, named after datacube dims (usually ``y`` and
``x``), over which ``parallel.halo`` and ``parallel.engine`` split a
cube. PyTorch has no single-controller partitioner: a mesh here is a
plan, read by ``shard_apply``, which places one block of the cube per
position on that position's device and runs the kernels there.

A mesh may name a device more than once: ``get_mesh((2, 2),
devices=[torch.device('cuda:0')] * 4)`` shards a cube four ways on one
card, and ``[torch.device('cpu')] * 8`` is the CPU tests' counterpart of
the JAX suite's eight forced host devices. Positions of a mesh built by
``parallel.distributed.global_mesh`` belong to processes (``ranks``);
a process runs the blocks of its own positions only.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ['Mesh', 'get_mesh', 'factorize2d']


def factorize2d(n):
    """Split n into the most square (a, b) factorization with a*b = n."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def _largest_divisor(n, size):
    """The largest count, at most ``n`` and at least 1, that divides
    ``size``."""
    n = max(1, min(int(n), int(size)))
    while size % n:
        n -= 1
    return n


def _join_grid(blocks, counts, join):
    """The whole rebuilt from a grid of blocks. ``blocks`` maps a grid
    index (one entry per split axis, ``counts[i]`` along axis i) to a
    block; ``join(parts, i)`` joins parts along split axis i."""
    def build(prefix):
        level = len(prefix)
        if level == len(counts):
            return blocks[prefix]
        return join([build(prefix + (j,)) for j in range(counts[level])],
                    level)
    return build(())


def _object_array(items, shape):
    arr = np.empty(len(items), dtype=object)
    arr[:] = list(items)
    return arr.reshape(shape)


class Mesh:
    """A grid of devices with named axes.

    Parameters
    ----------
    devices : array-like of torch.device
        One device per position, shaped like the mesh (a device may
        appear more than once).
    axis_names : tuple of str
        One name per mesh axis.
    ranks : array-like of int, optional
        The process that owns each position (default: this process owns
        them all).

    Attributes
    ----------
    devices : ndarray of torch.device, shaped like the mesh
    axis_names : tuple of str
    shape : dict
        Axis name -> number of positions, in axis order (``mesh.shape['y']``,
        ``mesh.shape.get('y', 1)``).
    ranks : ndarray of int or None
    """

    def __init__(self, devices, axis_names, ranks=None):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        shape = np.shape(np.asarray(devices, dtype=object))
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError('a mesh of shape %r needs %d axis names, got %r'
                             % (shape, len(shape), axis_names))
        self.devices = _object_array([torch.device(d) for d in flat], shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(n) for n in shape)))
        if ranks is not None:
            ranks = np.asarray(ranks, dtype=np.int64).reshape(shape)
        self.ranks = ranks

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def spans_processes(self):
        """True when positions belong to more than one process."""
        return self.ranks is not None and len(np.unique(self.ranks)) > 1

    def positions(self):
        """Every position (an index tuple), row-major."""
        return list(itertools.product(*(range(n) for n in
                                         self.devices.shape)))

    def is_local(self, position):
        """True when this process runs ``position``'s block."""
        if self.ranks is None:
            return True
        return int(self.ranks[position]) == _rank()

    def device(self, position):
        return self.devices[position]

    def reshaped(self, shape):
        """A mesh over the first ``prod(shape)`` positions (row-major),
        with the same axis names."""
        total = int(np.prod(shape))
        devices = self.devices.reshape(-1)[:total].reshape(shape)
        ranks = None if self.ranks is None \
            else self.ranks.reshape(-1)[:total].reshape(shape)
        return Mesh(devices, self.axis_names, ranks)

    def __repr__(self):
        return 'Mesh(%s, devices=%s)' % (
            ', '.join('%s=%d' % kv for kv in self.shape.items()),
            sorted({str(d) for d in self.devices.reshape(-1)}))


def _rank():
    """This process's rank, 0 without a process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_mesh(shape=None, axis_names=('y', 'x'), devices=None):
    """Build a Mesh over the available devices.

    Parameters
    ----------
    shape : tuple of int, optional
        Devices per axis; by default the device count is factorized as
        squarely as possible over two axes.
    axis_names : tuple of str, optional
        Mesh axis names; name them after datacube dims (default
        ('y', 'x')).
    devices : list of torch.device, optional
        Devices to use, a device possibly more than once (default: every
        visible CUDA device). Without a CUDA device this argument is
        required: there is no CPU fallback.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count == 0:
            raise RuntimeError(
                'get_mesh() found no CUDA device; pass devices= (a mesh of '
                'CPU devices is built only when asked for)')
        devices = [torch.device('cuda', i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            shape = factorize2d(n)
            shape = shape + (1,) * (len(axis_names) - 2)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError('mesh shape %r does not match %d devices'
                         % (shape, n))
    return Mesh(_object_array(devices, shape), axis_names)
