"""Tiling and mosaicking: larger-than-memory processing through tiles on
disk with overlap buffers.

Counterpart of ``nd_tpu/tiling.py``, on the port's data model: deferred
execution is a small built-in ``Delayed``; ``tile`` writes netCDF tiles
(netCDF-4 where ``h5py`` imports, classic CDF-2 otherwise); a path given
to ``tile`` is opened lazily, so each tile reads only its own slab of a
file larger than memory and writes it without passing through the card;
``map_over_tiles`` opens each tile onto ``device`` (``cuda`` unless the
caller names another), runs ``fn`` there and writes the result;
``auto_merge`` puts the tiles back together. The tile store doubles as
the checkpoint: a tile is written to ``<name>.part`` and renamed, and a
tile that exists is skipped, so an interrupted job resumes.
"""

from __future__ import annotations

import glob
import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import utils
from .core import DataArray, Dataset, concat
from .core.dataarray import _device_of
from .core.variable import Variable
from .io import add_time, open_netcdf, to_netcdf

__all__ = ['tile', 'map_over_tiles', 'auto_merge', 'debuffer',
           'sort_key', 'sort_into_array', 'Delayed']


class Delayed:
    """Minimal stand-in for dask.delayed: a thunk with .compute()."""

    def __init__(self, fn, *args, **kwargs):
        self._fn = fn
        self._args = args
        self._kwargs = kwargs

    def compute(self):
        args = [a.compute() if isinstance(a, Delayed) else
                [x.compute() if isinstance(x, Delayed) else x
                 for x in a] if isinstance(a, list) else a
                for a in self._args]
        return self._fn(*args, **self._kwargs)


def tile(ds, path, prefix='part', chunks=None, buffer=0, complevel=0,
         max_workers=4):
    """Split a dataset into (buffered) tiles and write them to disk.

    Parameters
    ----------
    ds : Dataset or str
        The dataset (or netCDF path) to split into tiles. A path is
        opened lazily: each tile reads only its own slab of the file into
        host memory and writes it, so a file larger than memory streams
        through.
    path : str
        Output directory.
    prefix : str, optional
        Tile file names start with ``{prefix}.``.
    chunks : dict, optional
        Chunk size per dimension to split along, e.g. ``{'y': 100}``.
    buffer : int or dict, optional
        Overlapping pixels stored around each tile (default: 0).
    complevel : int, optional
        zlib level of netCDF-4 tiles (classic files are uncompressed).
        Tiles are intermediates of a streaming pipeline, so the default
        is 0 (uncompressed).
    max_workers : int, optional
        Tile writes are independent; a small thread pool overlaps the
        per-file reads, encoding and writes (default 4).
    """
    if os.path.isfile(path):
        raise ValueError('`path` cannot be a file!')
    if not os.path.isdir(path):
        os.makedirs(path)

    if isinstance(ds, str):
        # verbatim (tile() keeps whatever dim names the file has) and
        # lazy: a tile's isel slices the view, and its write reads only
        # that slab, into host memory; nothing here needs the card, so
        # the coordinates stay there too
        ds = open_netcdf(ds, rename_latlon=False, chunks={}, device='cpu')

    if not chunks:
        raise ValueError('`chunks` must be provided (e.g. {"y": 100}).')

    slices = {}
    for dim, chunk_len in chunks.items():
        n = ds.sizes[dim]
        if isinstance(buffer, int):
            _buf = buffer
        elif isinstance(buffer, dict) and dim in buffer:
            _buf = buffer[dim]
        else:
            _buf = 0
        slices[dim] = []
        start = 0
        while start < n:
            _start = max(0, start - _buf)
            stop = min(start + chunk_len + _buf, n)
            slices[dim].append(slice(_start, stop))
            start += chunk_len

    def _write_tile(slice_dict):
        subset = ds.isel(slice_dict)
        suffix = '.'.join('{}_{}_{}'.format(dim, s.start, s.stop)
                          for dim, s in slice_dict.items())
        tile_name = '{}.{}.nc'.format(prefix, suffix)
        tile_path = os.path.join(path, tile_name)
        if not os.path.isfile(tile_path):
            # to_netcdf writes to .part and renames atomically
            to_netcdf(subset, tile_path, complevel=complevel)

    jobs = list(utils.dict_product(slices))
    if max_workers is None or max_workers <= 1 or len(jobs) <= 1:
        for slice_dict in jobs:
            _write_tile(slice_dict)
    else:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            # list() propagates the first exception
            list(pool.map(_write_tile, jobs))


def map_over_tiles(files, fn, args=(), kwargs={}, path=None, suffix='',
                   merge=True, overwrite=False, compute=True,
                   max_workers=4, complevel=0, device=None):
    """Apply a function to each tile file: open -> fn -> write.

    The stages are pipelined: a prefetch pool reads tiles ahead onto
    ``device``, ``fn`` runs in file order on the calling thread, and a
    write-behind pool copies each result to the host (inside
    ``to_netcdf``) and writes it, so disk reads, the card's work and the
    writes overlap.

    Parameters
    ----------
    files : str or list of str
        Glob expression or list of tile paths.
    fn : callable
        Function applied to each opened tile dataset.
    args, kwargs : optional
        Extra arguments for ``fn``.
    path : str, optional
        Output directory (default: alongside inputs).
    suffix : str, optional
        Inserted before the extension of each output file.
    merge : bool, optional
        Return a merged dataset (default: True).
    overwrite : bool, optional
        Overwrite existing outputs; otherwise append ``_new``.
    compute : bool, optional
        If False, return a ``Delayed`` instead of computing now.
    max_workers : int, optional
        Width of the prefetch and write-behind pools (default: 4).
    complevel : int, optional
        zlib level of netCDF-4 outputs (default 0; see :func:`tile`).
    device : torch.device or str, optional
        Where the tiles are read (default ``cuda``).

    Returns
    -------
    Dataset or list or Delayed
    """
    if isinstance(files, str):
        files = sorted(glob.glob(files))
    if path is not None:
        os.makedirs(path, exist_ok=True)

    def _out_file(f):
        root, name = os.path.split(f)
        stem, ext = os.path.splitext(name)
        out_path = root if path is None else path
        out_file = os.path.join(out_path,
                                '{}{}{}'.format(stem, suffix, ext))
        if not overwrite and os.path.exists(out_file):
            out_file = '{}_new{}'.format(*os.path.splitext(out_file))
        return out_file

    def _open(f):
        return open_netcdf(f, rename_latlon=False, device=device)

    def _store(result, out_file):
        # runs on a writer thread: its copy of a CUDA result to the host
        # is ordered after fn's kernels only because every launch and
        # copy goes to the default stream; work on a side stream would
        # need an event recorded after fn and waited for here
        to_netcdf(result, out_file, complevel=complevel)
        return out_file

    def _wrapper(f):
        return _store(fn(_open(f), *args, **kwargs), _out_file(f))

    def _run_all(fs, collect=None):
        """Process all tiles; with ``collect`` a list, also append each
        in-memory result, so that the merge takes them directly instead
        of reading the files just written."""
        if len(fs) <= 1 or (max_workers is not None
                            and max_workers <= 1):
            if collect is None:
                return [_wrapper(f) for f in fs]
            out = []
            for f in fs:
                result = fn(_open(f), *args, **kwargs)
                collect.append(result)
                out.append(_store(result, _out_file(f)))
            return out
        # the first tile runs alone: it builds the kernels and fills the
        # wrappers' plan caches that the other tiles reuse
        first_result = fn(_open(fs[0]), *args, **kwargs)
        if collect is not None:
            collect.append(first_result)
        head = [_store(first_result, _out_file(fs[0]))]
        rest = fs[1:]
        # None = "pick for me" (ThreadPoolExecutor's old contract)
        workers = max(2, max_workers if max_workers is not None else 4)
        depth = workers                      # prefetch window
        with ThreadPoolExecutor(max_workers=workers) as readers, \
                ThreadPoolExecutor(max_workers=workers) as writers:
            it = iter(rest)
            pending = [(f, readers.submit(_open, f))
                       for f in itertools.islice(it, depth)]
            stores = []
            while pending:
                f, fut = pending.pop(0)
                result = fn(fut.result(), *args, **kwargs)
                if collect is not None:
                    collect.append(result)
                stores.append(writers.submit(_store, result,
                                             _out_file(f)))
                nxt = next(it, None)
                if nxt is not None:
                    pending.append((nxt, readers.submit(_open, nxt)))
            tail = [s.result() for s in stores]
        return head + tail

    def _run_and_merge(fs):
        # merge straight from the in-memory results (the tiles are still
        # written, for resume and audit); a DataArray comes back from
        # netCDF as a Dataset with its name (or 'data'), so the merged
        # type does not depend on which path produced it
        results = []
        _run_all(fs, collect=results)
        results = [r.to_dataset(name=r.name or 'data')
                   if isinstance(r, DataArray) else r
                   for r in results]
        return auto_merge(results)

    if merge:
        result = Delayed(_run_and_merge, files)
    else:
        result = Delayed(_run_all, files)

    if compute:
        return result.compute()
    return result


def _axis_tokens(vals, flip):
    """Orderable ascending view of a coordinate vector: datetimes become
    int64 ticks, and axes that run high-to-low (``flip``) compare through
    a sign change so 'earlier on the axis' always sorts first. Dtypes
    with no meaningful negation pass through unchanged."""
    v = np.asarray(vals)
    if v.dtype.kind in 'mM':
        v = v.astype('int64')
    if flip and np.issubdtype(v.dtype, np.number):
        v = -v
    return v


def _dim_flip(coord_vectors):
    """Whether a dimension's coordinate runs high-to-low, decided by the
    first tile wide enough to express a direction."""
    for c in coord_vectors:
        if len(c) > 1:
            return bool(c[-1] < c[0])
    return False


def sort_key(ds, dims):
    """Sort key ordering datasets by their position on the tile grid."""
    key = ()
    for d in dims:
        vals = np.asarray(ds[d].values)
        t = _axis_tokens(vals, _dim_flip([vals]))
        key += (t[0], t[-1])
    return key


def sort_into_array(datasets, dims=None):
    """Arrange tiles into a grid array by their coordinate origins.

    Each tile's grid index along a dimension is the rank of its origin
    token among the distinct origins (searchsorted against the sorted
    unique set), so placement needs no pairwise comparisons.
    """
    dims = utils.get_dims(datasets[0]) if dims is None else tuple(dims)
    index = []
    for dim in dims:
        cols = [np.asarray(d[dim].values) for d in datasets]
        flip = _dim_flip(cols)
        tokens = np.asarray([_axis_tokens(c, flip)[0] for c in cols])
        index.append(np.searchsorted(np.unique(tokens), tokens))
    grid = np.empty(tuple(int(i.max()) + 1 for i in index), dtype=object)
    for pos, d in zip(zip(*(i.tolist() for i in index)), datasets):
        grid[pos] = d
    return grid


def debuffer(datasets, flat=True):
    """Remove overlap buffers from tiled datasets.

    Adjacent tiles sharing a halo keep half each: the predecessor drops
    ceil(overlap/2) rows from its trailing edge, the successor drops
    floor(overlap/2) from its leading edge. All of a tile's trims are
    derived up front from its neighbours' coordinate ranges (a
    searchsorted count of the shared run: the coordinates are monotone)
    and applied in one combined ``isel``.
    """
    dims = utils.get_dims(datasets[0])
    grid = sort_into_array(datasets, dims)
    coord_values = {(cell, dim): np.asarray(grid[cell][dim].values)
                    for cell in np.ndindex(*grid.shape) for dim in dims}
    flips = {dim: _dim_flip([coord_values[cell, dim]
                             for cell in np.ndindex(*grid.shape)])
             for dim in dims}

    def _shared_run(cell, axis, dim):
        # length of the coordinate overlap between grid[cell] and its
        # successor along `axis`
        succ = cell[:axis] + (cell[axis] + 1,) + cell[axis + 1:]
        ta = _axis_tokens(coord_values[cell, dim], flips[dim])
        tb = _axis_tokens(coord_values[succ, dim], flips[dim])
        tail = ta.size - int(np.searchsorted(ta, tb[0], side='left'))
        head = int(np.searchsorted(tb, ta[-1], side='right'))
        return min(tail, head)

    trimmed = np.empty(grid.shape, dtype=object)
    for cell in np.ndindex(*grid.shape):
        sel = {}
        for axis, dim in enumerate(dims):
            pred = cell[:axis] + (cell[axis] - 1,) + cell[axis + 1:]
            drop_head = (_shared_run(pred, axis, dim) // 2
                         if cell[axis] > 0 else 0)
            after = (_shared_run(cell, axis, dim)
                     if cell[axis] + 1 < grid.shape[axis] else 0)
            drop_tail = after - after // 2
            if drop_head or drop_tail:
                sel[dim] = slice(drop_head or None,
                                 -drop_tail if drop_tail else None)
        trimmed[cell] = grid[cell].isel(**sel) if sel else grid[cell]

    if flat:
        return list(trimmed.flatten())
    return trimmed


class _FallBack(Exception):
    """The grid is not uniform enough for the one-pass assembly."""


def _combine_grid_fast(grid, dims):
    """One-pass mosaic assembly: each variable's output is allocated once,
    on the first tile's device, and every tile's slab is copied into
    place. Returns None where the grid is not uniform (mixed names, dim
    orders, dtypes or devices, ragged sizes, lazy payloads); the
    recursive concat handles those."""
    g = grid.shape
    first = grid.flat[0]
    dim_to_axis = {d: ax for ax, d in enumerate(dims)}

    # extent of each grid row/column from the tiles on the axis' edge
    offs = []
    for ax, d in enumerate(dims):
        sizes = []
        idx = [0] * grid.ndim
        for j in range(g[ax]):
            idx[ax] = j
            sizes.append(grid[tuple(idx)].sizes.get(d))
        if any(s is None for s in sizes):
            return None
        offs.append(np.concatenate([[0], np.cumsum(sizes)]).astype(int))
    totals = {d: int(offs[ax][-1]) for ax, d in enumerate(dims)}

    def same_kind(v, v0):
        return (v.dims == v0.dims and v.dtype == v0.dtype
                and not v.is_lazy and v.device == v0.device)

    def assemble(table, name):
        v0 = getattr(first, table)[name]
        if v0.is_lazy:
            raise _FallBack
        if not any(d in dim_to_axis for d in v0.dims):
            return v0                    # replicated across tiles
        out_shape = tuple(totals.get(d, s)
                          for d, s in zip(v0.dims, v0.shape))
        d0 = v0.data
        out = torch.empty(out_shape, dtype=d0.dtype, device=d0.device) \
            if isinstance(d0, torch.Tensor) else np.empty(out_shape,
                                                          d0.dtype)
        for gi in np.ndindex(*g):
            v = getattr(grid[gi], table)[name]
            if not same_kind(v, v0):
                raise _FallBack
            sl = []
            for d, s in zip(v0.dims, v.shape):
                if d in dim_to_axis:
                    ax = dim_to_axis[d]
                    j = gi[ax]
                    if s != offs[ax][j + 1] - offs[ax][j]:
                        raise _FallBack
                    sl.append(slice(offs[ax][j], offs[ax][j] + s))
                else:
                    if s != out_shape[len(sl)]:
                        raise _FallBack
                    sl.append(slice(None))
            out[tuple(sl)] = v.data
        return Variable(v0.dims, out, v0.attrs)

    for t in grid.flat:
        if (list(t._variables) != list(first._variables)
                or list(t._coords) != list(first._coords)):
            return None
    out = Dataset(attrs=dict(first.attrs))
    try:
        for name in first._variables:
            out._variables[name] = assemble('_variables', name)
        for name in first._coords:
            out._coords[name] = assemble('_coords', name)
    except _FallBack:
        return None
    return out


def _combine_grid(datasets):
    """Combine de-buffered tiles by concatenating along each split
    dimension (the counterpart of xr.combine_by_coords)."""
    dims = utils.get_dims(datasets[0])
    grid = sort_into_array(datasets)

    fast = _combine_grid_fast(grid, dims)
    if fast is not None:
        return fast

    def _merge_axis(grid, axis, dim):
        if grid.shape[axis] == 1:
            return np.take(grid, 0, axis=axis)
        out_shape = grid.shape[:axis] + grid.shape[axis + 1:]
        out = np.empty(out_shape, dtype=object)
        for idx in np.ndindex(out_shape):
            full_idx = idx[:axis] + (slice(None),) + idx[axis:]
            # grid order along the axis already matches coordinate
            # order (sort_into_array handles descending coords)
            out[idx] = concat(list(grid[full_idx]), dim)
        return out

    # collapse grid axes from last to first; axis i is dims[i] by
    # construction of sort_into_array
    for axis in range(grid.ndim - 1, -1, -1):
        grid = _merge_axis(grid, axis, dims[axis])

    return grid.item() if isinstance(grid, np.ndarray) else grid


def _get_common_attrs(datasets):
    """All attributes that are identical in every dataset."""
    attrs = {}
    not_equal = []
    for d in datasets:
        for key, val in d.attrs.items():
            if key not in attrs:
                attrs[key] = val
            elif not np.array_equal(val, attrs[key]):
                not_equal.append(key)
    return {k: v for k, v in attrs.items() if k not in not_equal}


def _factorize(values):
    """(codes, categories) numbered in order of first appearance, as
    ``pandas.factorize`` numbers them; missing values (None, NaN, NaT)
    get code -1 and no category."""
    flat = values.ravel()
    if flat.dtype.kind in 'mM':
        missing = np.isnat(flat)
    elif flat.dtype == object:
        missing = np.asarray([v is None or (isinstance(v, float)
                                            and np.isnan(v))
                              for v in flat], dtype=bool)
    else:
        missing = np.zeros(flat.shape, dtype=bool)
    codes = np.full(flat.shape, -1, dtype=np.int64)
    present = flat[~missing]
    if not present.size:
        return codes, []
    uniq, first, inverse = np.unique(present, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind='stable')
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    codes[~missing] = rank[inverse.ravel()]
    return codes, list(uniq[order])


def auto_merge(datasets, buffer=True, chunks={}, meta_variables=[],
               use_xarray_combine=True, device=None):
    """Automatically merge a split dataset (multi-dimensional mosaic).

    Parameters
    ----------
    datasets : str, list of str, or list of Dataset
        Glob expression, tile paths, or opened datasets.
    buffer : bool, optional
        Auto-detect and remove overlap buffers (default: True).
    meta_variables : list, optional
        Metadata attributes lifted into (time) variables, categorical
        values factorized with a ``legend`` attribute.
    use_xarray_combine : bool, optional
        Kept for API parity (ignored; the built-in combine is used).
    device : torch.device or str, optional
        Where tile files are read (default ``cuda``).

    Returns
    -------
    Dataset
    """
    pattern = datasets if isinstance(datasets, str) else None
    if pattern is not None:
        datasets = sorted(glob.glob(pattern))
    if len(datasets) == 0:
        raise ValueError('no tile inputs%s'
                         % (' matched %r' % pattern if pattern
                            else ''))
    if isinstance(datasets[0], str):
        def _open(p):
            d = open_netcdf(p, rename_latlon=False, device=device)
            # only datasets that can carry a time axis get one: a
            # time-less tile (e.g. from a single raster) merges as it is
            if 'time' in d._coords or 'start_date' in d.attrs:
                d = add_time(d)
            return d
        if len(datasets) > 1:
            # file reads and decoding release the GIL in large parts
            with ThreadPoolExecutor(max_workers=4) as pool:
                datasets = list(pool.map(_open, datasets))
        else:
            datasets = [_open(path) for path in datasets]
    else:
        # in-memory inputs get the same time-axis treatment as re-opened
        # tiles (map_over_tiles merges without a re-read)
        datasets = [add_time(d)
                    if 'time' not in d._coords
                    and 'start_date' in d.attrs else d
                    for d in datasets]

    for meta in meta_variables:
        for d in datasets:
            val = d.attrs.get(meta)
            if 'time' in d.sizes:
                d[meta] = (('time',),
                           np.asarray([val] * d.sizes['time']))
            else:
                d[meta] = ((), np.asarray(val))

    if buffer:
        datasets = debuffer(datasets, flat=True)

    merged = _combine_grid(datasets)
    merged.attrs.clear()
    merged.attrs.update(_get_common_attrs(datasets))

    for meta in meta_variables:
        mvar = merged._variables[meta]
        vals = np.asarray(mvar.values)
        if not np.issubdtype(vals.dtype, np.number):
            codes, legend = _factorize(vals)
            # keep the variable's own dims (a dataset without time gets
            # no time dimension)
            merged._variables[meta] = Variable(
                mvar.dims, codes.reshape(vals.shape),
                {'legend': tuple((i, v) for i, v in enumerate(legend))},
                _device_of(merged))
    return merged
