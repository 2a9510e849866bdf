"""Mesh-sharded execution of datacube algorithms.

Counterpart of ``nd_tpu/parallel/engine.py``: the device-level
counterpart of ``Algorithm.apply(njobs=...)``. Windowed filters run
through ``parallel.halo.shard_apply`` (one block per mesh position,
halos from the neighbours); pixelwise kernels (change detection,
reprojection over time) run on each block of ``shard_dataset`` on the
block's device. Results equal single-device execution bit for bit: each
kernel computes an output from its window alone, in the same order.

A mesh whose positions belong to several processes is ``shard_apply``'s
(``parallel.distributed``); the functions here take a mesh of this
process.
"""

from __future__ import annotations

import torch

from ..core import DataArray
from ..core.dataarray import concat
from ..core.variable import Variable
from .halo import on_device, shard_apply
from .mesh import _join_grid, _largest_divisor, get_mesh

__all__ = ['apply_sharded', 'shard_dataset', 'sharded_change_detection',
           'sharded_reproject', 'ShardedDataset']

# numpy.pad-style boundary modes of each filter kernel family;
# scipy.ndimage 'reflect' (used by convolution filters) is numpy
# 'symmetric', the NLMeans convention is numpy 'reflect'. Shared with
# the conv kernels so the halo's boundary fill can never diverge from
# what convolve itself does.
from ..ops.conv import _SCIPY_TO_NP_PAD as _SCIPY_TO_NP


def _local(mesh):
    if mesh.spans_processes:
        raise ValueError('this function takes a mesh of one process; on a '
                         'mesh across processes use shard_apply on the '
                         'blocks of cube_from_process_tiles')
    return mesh


def _fit_mesh_to_dims(mesh, ds, dims, halos):
    """Shrink mesh axes that don't fit the data (shard >= 2 x halo)."""
    shape = []
    for name in mesh.axis_names:
        n = mesh.shape[name]
        if name in dims:
            size = ds.sizes[name]
            halo = halos.get(name, 0)
            max_shards = max(1, size // max(2 * halo, 1))
            n = min(n, max_shards, size)
        shape.append(n)
    return mesh.reshaped(tuple(shape))


def _filter_pad_mode(algo):
    from ..filters import NLMeansFilter
    if isinstance(algo, NLMeansFilter):
        return 'reflect'
    mode = getattr(algo, 'kwargs', {}).get('mode', 'reflect')
    return _SCIPY_TO_NP.get(mode, 'symmetric')


def _device_of(obj):
    """The device of the first tensor payload of a Dataset or
    DataArray."""
    variables = [obj.variable] if isinstance(obj, DataArray) \
        else list(obj._variables.values())
    for var in variables:
        if isinstance(var.data, torch.Tensor):
            return var.data.device
    return None


def _to_device(obj, device):
    """A shallow copy of a Dataset or DataArray with every tensor (data
    and coordinates) on ``device``."""
    out = obj.copy(deep=False)
    tables = [out._coords] if isinstance(out, DataArray) \
        else [out._variables, out._coords]
    if isinstance(out, DataArray):
        var = out.variable
        if isinstance(var.data, torch.Tensor):
            out.data = var.data.to(device)
    for table in tables:
        for k, var in table.items():
            if isinstance(var.data, torch.Tensor) \
                    and var.data.device != device:
                table[k] = Variable(var.dims, var.data.to(device),
                                    var.attrs)
    return out


def apply_sharded(algo, ds, mesh=None):
    """Apply a Filter algorithm sharded across the device mesh.

    The mesh axes named after dataset dims are sharded; the filter's
    ``_buffer(dim)`` supplies the halo per axis. Non-filter (batch) dims
    stay whole within each block.

    Parameters
    ----------
    algo : nd_tpu_torch.filters.Filter
    ds : Dataset or DataArray
    mesh : parallel.mesh.Mesh, optional
        Default: ``get_mesh()``, every visible CUDA device.

    Returns
    -------
    Same type as ``ds``, on its device, equal to ``algo.apply(ds)``.
    """
    from ..filters import Filter

    if not isinstance(algo, Filter):
        raise TypeError('apply_sharded expects a Filter algorithm; use '
                        'sharded_change_detection or shard_dataset for '
                        'pixelwise ops.')

    mesh = _local(mesh if mesh is not None else get_mesh())
    halos = {d: int(algo._buffer(d)) for d in mesh.axis_names}
    shard_dims = [d for d in mesh.axis_names
                  if d in ds.sizes and d in algo.dims]
    mesh = _fit_mesh_to_dims(mesh, ds, shard_dims, halos)
    # axes the fit shrank to a single block need no halo exchange at
    # all (the halo limit of halo_pad would refuse big-halo filters on
    # small axes, where the serial apply works)
    shard_dims = [d for d in shard_dims if mesh.shape[d] > 1]
    mode = _filter_pad_mode(algo)
    cval = float(getattr(algo, 'kwargs', {}).get('cval', 0.0))
    if mode == 'wrap':
        # periodic halos cannot ride divisibility padding (see
        # halo.shard_apply); keep such axes whole instead
        shard_dims = [d for d in shard_dims
                      if ds.sizes[d] % mesh.shape[d] == 0]

    def run(arr, dims):
        sharded_axes = {d: (dims.index(d), halos.get(d, 0))
                        for d in shard_dims if d in dims}
        if not sharded_axes:
            return algo._run(arr, dims)
        return shard_apply(lambda x: algo._run(x, dims), arr, mesh,
                           sharded_axes, mode=mode, cval=cval)

    # Filter.apply's own layout (complex disassembly, the joint-filter
    # shim, same-layout variables stacked on a leading axis, the joint
    # NLMeans path): the layout picks the kernel's route, and the same
    # route is what makes the result bit-equal to the serial apply
    return algo._apply_layout(ds, run)


class ShardedDataset:
    """A Dataset held as one block per mesh position, each block on its
    position's device (``shard_dataset``'s result).

    Attributes
    ----------
    mesh : parallel.mesh.Mesh
        The mesh after the fit (axes shrunk to divisors).
    dims : tuple of str
        The dims split over the mesh axes of the same names.
    sizes : dict
        The whole Dataset's sizes.
    blocks : dict
        Position -> Dataset block (index 0 along mesh axes that split no
        dim: those would hold replicas).
    """

    def __init__(self, mesh, dims, sizes, blocks):
        self.mesh = mesh
        self.dims = tuple(dims)
        self.sizes = dict(sizes)
        self.blocks = dict(blocks)

    def index(self, position):
        """dim -> the slice of the whole Dataset a block holds."""
        out = {}
        for k, name in enumerate(self.mesh.axis_names):
            if name in self.dims:
                chunk = self.sizes[name] // self.mesh.shape[name]
                out[name] = slice(position[k] * chunk,
                                  (position[k] + 1) * chunk)
        return out

    def map(self, fn):
        """``fn`` on each block with the block's device current:
        position -> result."""
        out = {}
        for pos, block in self.blocks.items():
            with on_device(self.mesh.device(pos)):
                out[pos] = fn(block)
        return out

    def stitch(self, parts, device=None):
        """Join per-position Datasets or DataArrays (``map``'s result)
        along the sharded dims, on ``device`` (default: the first
        block's)."""
        names = [n for n in self.mesh.axis_names if n in self.dims]
        counts = [self.mesh.shape[n] for n in names]
        ks = [self.mesh.axis_names.index(n) for n in names]
        if device is None:
            device = self.mesh.device(next(iter(parts)))
        by_index = {tuple(pos[k] for k in ks): _to_device(p, device)
                    for pos, p in parts.items()}
        return _join_grid(by_index, counts,
                          lambda pieces, level: concat(pieces, names[level]))


def shard_dataset(ds, mesh=None, dims=('y', 'x')):
    """Split a Dataset over the mesh: one block per position, on the
    position's device (a ShardedDataset).

    Mesh axes that don't divide the corresponding dimension are shrunk to
    the largest divisor (blocks of equal size, as the JAX package's
    NamedSharding requires); ``sharded_change_detection`` pads instead,
    to keep every position busy. Variables without a sharded dim are
    copied whole to every block.
    """
    mesh = _local(mesh if mesh is not None else get_mesh())
    shape = []
    for name in mesh.axis_names:
        count = mesh.shape[name]
        if name in dims and name in ds.sizes:
            count = _largest_divisor(count, ds.sizes[name])
        shape.append(count)
    if tuple(shape) != tuple(mesh.shape.values()):
        mesh = mesh.reshaped(tuple(shape))
    split = tuple(d for d in dims if d in mesh.axis_names and d in ds.sizes)
    out = ShardedDataset(mesh, split, ds.sizes, {})
    for pos in mesh.positions():
        if any(pos[k] for k, name in enumerate(mesh.axis_names)
               if name not in split):
            continue
        out.blocks[pos] = _to_device(ds.isel(out.index(pos)),
                                     mesh.device(pos))
    return out


def sharded_change_detection(ds, alpha=0.01, ml=None, n=1, mesh=None):
    """Omnibus change detection data-parallel over the mesh.

    The (y, x) pixel grid is sharded; the time axis stays whole in each
    block (the per-pixel scan needs the full series). The multilook rides
    the halo engine (``apply_sharded(BoxcarFilter(w=ml))``). Returns the
    (y, x, time) bool change map on ``ds``'s device, equal to
    ``OmnibusTest(ml=ml, n=n, alpha=alpha).apply(ds)``.
    """
    from ..change import _omnibus_change_detection
    from ..filters import BoxcarFilter

    mesh = _local(mesh if mesh is not None else get_mesh())
    home = _device_of(ds)

    work = ds
    if ml is not None:
        work = apply_sharded(BoxcarFilter(w=ml), ds, mesh=mesh)
        n = ml ** 2

    # pad (y, x) up to mesh-divisible sizes so every position keeps a
    # block on awkward shapes; pixels are independent, so the pad region
    # cannot influence real pixels and is cropped afterwards
    ny, nx = work.sizes['y'], work.sizes['x']
    pad_y = (-ny) % mesh.shape.get('y', 1)
    pad_x = (-nx) % mesh.shape.get('x', 1)
    if pad_y or pad_x:
        work = work.pad(y=(0, pad_y), x=(0, pad_x), constant_values=0.0)

    sharded = shard_dataset(work, mesh, dims=('y', 'x'))
    parts = sharded.map(lambda block: _omnibus_change_detection(
        block, alpha=alpha, ml=None, n=n))
    result = sharded.stitch(parts, home)
    if pad_y or pad_x:
        result = result.isel(y=slice(0, ny), x=slice(0, nx))
    return result


def sharded_reproject(ds, mesh=None, batch_dim='time', **kwargs):
    """Reprojection data-parallel over the device mesh.

    Warping gathers arbitrary source pixels per output pixel, so the
    pixel grid is not sharded; the batch dimension (``time`` by default,
    the axis the reference's process pool splits) is split over the
    mesh's positions, and each block is warped on its position's device.
    Equal to ``reproject(ds, **kwargs)``, on ``ds``'s device; batch sizes
    that don't divide the position count use the largest divisor.
    """
    from ..warp import Reprojection

    mesh = _local(mesh if mesh is not None else get_mesh())
    devices = list(mesh.devices.reshape(-1))
    algo = Reprojection(**kwargs)
    size = ds.sizes.get(batch_dim, 1)
    count = _largest_divisor(len(devices), size)
    if count <= 1:
        return algo.apply(ds)
    home = _device_of(ds)
    step = size // count
    parts = []
    for i in range(count):
        block = _to_device(ds.isel({batch_dim: slice(i * step,
                                                     (i + 1) * step)}),
                           devices[i])
        with on_device(devices[i]):
            parts.append(_to_device(algo.apply(block), home))
    return concat(parts, batch_dim)
