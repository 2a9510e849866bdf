"""Zarr v2 store: chunked datacube storage, the port's own copy of
``nd_tpu/io/zarr.py``.

A from-scratch implementation of the Zarr v2 on-disk layout (directory
of ``.zgroup``/``.zarray``/``.zattrs`` JSON plus chunk files named
``"0.0.1"``), interoperable with ``zarr-python``/xarray: dimension
names travel in the xarray ``_ARRAY_DIMENSIONS`` convention, the
compressor is zlib (a standard numcodecs codec; ``numcodecs`` is
optional and only read for blosc stores), and complex variables
round-trip natively. A CUDA dataset is written with one host copy per
variable; :func:`open_zarr` puts numeric data on ``device``.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

__all__ = ['to_zarr', 'open_zarr']

_SEP = '.'


def _json_default(v):
    if isinstance(v, np.bool_):
        return bool(v)        # str() would make 'False' truthy
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


def _coerce_attrs(attrs):
    from ..crs import CRS, Affine
    out = {}
    for k, v in attrs.items():
        if isinstance(v, CRS):
            v = v.to_proj4()
        elif isinstance(v, Affine):
            v = list(v)
        out[k] = v
    return out


def _dtype_str(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == 'U':
        return dtype.str
    return dtype.newbyteorder('<').str


def _parse_fill(fill, dtype):
    """Zarr fill_value JSON -> a numpy scalar of the array dtype."""
    if fill is None:
        return None
    if isinstance(fill, str) and fill in ('NaN', 'nan', 'Infinity',
                                          '-Infinity'):
        fill = float(fill.replace('Infinity', 'inf'))
    try:
        # inside the try: lenient writers emit 'NaN' (or infinities)
        # even for integer dtypes, which must degrade to no-fill, not
        # crash the open (inf -> int raises OverflowError)
        return np.asarray(fill, dtype)
    except (TypeError, ValueError, OverflowError):
        return None


def _decompress_chunk(raw, comp):
    if comp is None:
        return raw
    if comp.get('id') == 'numcodecs':
        return bytes(comp['_codec'].decode(raw))
    return zlib.decompress(raw)


def _write_array(dirpath, name, dims, data, attrs, chunks=None,
                 compress=True):
    data = np.asarray(data)
    if data.dtype == object:
        data = data.astype(str)
    if data.dtype.kind == 'M':
        # store datetimes as int64 ns since epoch with CF-ish metadata
        attrs = dict(attrs)
        attrs['_nd_tpu_datetime64'] = str(data.dtype)
        data = data.astype('datetime64[ns]').astype('int64')
    apath = os.path.join(dirpath, name)
    # resolve + VALIDATE the chunk grid before touching any existing
    # store: a bad chunk spec must fail without destroying data
    if chunks is None:
        chunks = data.shape if data.ndim else (1,)
    if data.ndim:
        chunks = tuple(
            int(s) if (c is None or int(c) <= 0) else int(min(c, s))
            if s else 1
            for c, s in zip(chunks, data.shape))
        if any(c <= 0 for c in chunks):
            raise ValueError('invalid chunk grid %r for shape %r'
                             % (chunks, data.shape))
    else:
        chunks = (1,)
    # write into a temp sibling and swap in atomically: a mid-write
    # failure leaves the previous array intact
    import shutil
    import tempfile
    tmpdir = tempfile.mkdtemp(prefix='.%s.' % name, dir=dirpath)
    final_apath = apath
    apath = tmpdir
    try:
        _write_array_payload(apath, final_apath, name, dims, data,
                             attrs, chunks, compress)
    except BaseException:
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise


def _write_array_payload(apath, final_apath, name, dims, data, attrs,
                         chunks, compress):
    import shutil
    shape = data.shape if data.ndim else ()
    meta = {
        'zarr_format': 2,
        'shape': list(shape),
        'chunks': list(chunks if data.ndim else (1,)),
        'dtype': _dtype_str(data.dtype),
        'compressor': ({'id': 'zlib', 'level': 5} if compress else None),
        'fill_value': 'NaN' if data.dtype.kind == 'f' else None,
        'order': 'C',
        'filters': None,
        'dimension_separator': _SEP,
    }
    with open(os.path.join(apath, '.zarray'), 'w') as fh:
        json.dump(meta, fh, default=_json_default)
    zattrs = dict(_coerce_attrs(attrs))
    zattrs['_ARRAY_DIMENSIONS'] = list(dims)
    with open(os.path.join(apath, '.zattrs'), 'w') as fh:
        json.dump(zattrs, fh, default=_json_default)

    # write chunks
    if not data.ndim:
        grid = [(0,)]
    else:
        counts = [int(np.ceil(s / c)) for s, c in zip(shape, chunks)]
        grid = np.ndindex(*counts)
    for idx in grid:
        if data.ndim:
            key = tuple(slice(i * c, min((i + 1) * c, s))
                        for i, c, s in zip(idx, chunks, shape))
            block = data[key]
            # zarr chunks are always full-size; pad the edge blocks
            if block.shape != tuple(chunks):
                full = np.zeros(chunks, dtype=data.dtype)
                full[tuple(slice(0, e) for e in block.shape)] = block
                block = full
        else:
            block = data.reshape(1)
        raw = np.ascontiguousarray(
            block, dtype=block.dtype.newbyteorder('<')
            if block.dtype.kind not in 'US' else block.dtype).tobytes()
        if compress:
            raw = zlib.compress(raw, 5)
        cname = _SEP.join(str(i) for i in (idx if data.ndim else (0,)))
        with open(os.path.join(apath, cname), 'wb') as fh:
            fh.write(raw)

    # the array is complete: swap it into place (replacing any
    # previous version only now)
    if os.path.isdir(final_apath):
        shutil.rmtree(final_apath)
    os.replace(apath, final_apath)


def to_zarr(ds, path, chunks=None, compress=True):
    """Write a Dataset (or DataArray) to a Zarr v2 directory store.

    Parameters
    ----------
    ds : Dataset or DataArray
    path : str
        Target directory (created; existing arrays are overwritten).
    chunks : dict, optional
        Chunk length per dimension (default: one chunk per array).
    compress : bool, optional
        zlib-compress chunks (default True).
    """
    from ..core import DataArray
    if isinstance(ds, DataArray):
        ds = ds.to_dataset(name=ds.name or 'data')
    os.makedirs(path, exist_ok=True)
    # remove arrays that are no longer part of the dataset ("existing
    # arrays are overwritten" must not leave ghosts behind)
    current = set(ds._coords) | set(ds._variables)
    for name in os.listdir(path):
        apath = os.path.join(path, name)
        if os.path.isdir(apath) and \
                os.path.exists(os.path.join(apath, '.zarray')) and \
                name not in current:
            import shutil
            shutil.rmtree(apath)
    with open(os.path.join(path, '.zgroup'), 'w') as fh:
        json.dump({'zarr_format': 2}, fh)
    gattrs = _coerce_attrs(ds.attrs)
    if ds._coords:
        # record coordinate membership (xarray stores this per data
        # variable; the group-level list covers scalar/non-dim/2-d
        # coords either way). Namespaced so a user attribute that
        # happens to be called 'coordinates' survives the round trip.
        gattrs['_nd_tpu_coordinates'] = ' '.join(sorted(ds._coords))
    with open(os.path.join(path, '.zattrs'), 'w') as fh:
        json.dump(gattrs, fh, default=_json_default)

    def _chunks_for(var):
        if chunks is None:
            return None
        return tuple(int(chunks.get(d, s))
                     for d, s in zip(var.dims, var.shape))

    for name, var in list(ds._coords.items()) \
            + list(ds._variables.items()):
        _write_array(path, name, var.dims, var.values, var.attrs,
                     chunks=_chunks_for(var), compress=compress)

    # consolidated metadata (.zmetadata): one JSON holding every
    # .zgroup/.zattrs/.zarray so remote readers make a single metadata
    # fetch — xr.open_zarr(..., consolidated=True) accepts our stores
    meta = {}
    for root, _dirs, files in os.walk(path):
        for fn in files:
            if fn in ('.zgroup', '.zattrs', '.zarray'):
                rel = os.path.relpath(os.path.join(root, fn), path)
                rel = rel.replace(os.sep, '/')
                with open(os.path.join(root, fn)) as fh:
                    meta[rel] = json.load(fh)
    with open(os.path.join(path, '.zmetadata'), 'w') as fh:
        json.dump({'zarr_consolidated_format': 1, 'metadata': meta},
                  fh, default=_json_default)
    return path


def _read_array(apath):
    with open(os.path.join(apath, '.zarray')) as fh:
        meta = json.load(fh)
    attrs = {}
    zattrs_path = os.path.join(apath, '.zattrs')
    if os.path.exists(zattrs_path):
        with open(zattrs_path) as fh:
            attrs = json.load(fh)
    dims = attrs.pop('_ARRAY_DIMENSIONS', None)
    shape = tuple(meta['shape'])
    chunks = tuple(meta['chunks'])
    dtype = np.dtype(meta['dtype'])
    comp = meta.get('compressor')
    sep = meta.get('dimension_separator', '.')
    if comp is not None and comp.get('id') != 'zlib':
        # blosc (zarr-python's default) needs the c-blosc library;
        # use it via numcodecs when available, else fail with the
        # remedies spelled out
        cid = comp.get('id')
        if cid == 'blosc':
            try:
                import numcodecs
                comp = {'id': 'numcodecs', '_codec':
                        numcodecs.get_codec(comp)}
            except ImportError:
                raise IOError(
                    "zarr store is blosc-compressed (zarr-python's "
                    "default); this reader decodes zlib natively — "
                    "install numcodecs, or write the store with "
                    "compressor=numcodecs.Zlib() / "
                    "ds.to_zarr(..., compress=True) from this "
                    "framework")
        else:
            raise IOError(
                'unsupported zarr compressor %r (zlib is decoded '
                'natively; install numcodecs for blosc)' % cid)
    if meta.get('order', 'C') != 'C':
        raise IOError('unsupported zarr chunk order %r' % meta['order'])
    if meta.get('filters'):
        raise IOError('unsupported zarr filters %r' % meta['filters'])
    fill = _parse_fill(meta.get('fill_value'), dtype)

    def _finish(data):
        if attrs.pop('_nd_tpu_datetime64', None):
            data = np.asarray(data).astype('int64') \
                .view('datetime64[ns]')
        return data

    if not shape:
        fpath = os.path.join(apath, '0')
        if not os.path.exists(fpath):
            data = (fill if fill is not None
                    else np.zeros((), dtype)[()])
            return dims or (), _finish(np.asarray(data)), attrs
        raw = _decompress_chunk(open(fpath, 'rb').read(), comp)
        data = np.frombuffer(raw, dtype=dtype)[0]
        return dims or (), _finish(np.asarray(data)), attrs

    counts = [int(np.ceil(s / c)) for s, c in zip(shape, chunks)]
    padded = tuple(cnt * c for cnt, c in zip(counts, chunks))
    # absent chunks mean "entirely fill_value" (zarr writers omit them)
    data = (np.full(padded, fill, dtype=dtype) if fill is not None
            else np.zeros(padded, dtype=dtype))
    for idx in np.ndindex(*counts):
        cname = sep.join(str(i) for i in idx)
        fpath = os.path.join(apath, cname)
        if not os.path.exists(fpath) and sep == '.':
            fpath = os.path.join(apath, '/'.join(str(i) for i in idx))
        if not os.path.exists(fpath):
            continue          # missing chunk -> fill
        raw = _decompress_chunk(open(fpath, 'rb').read(), comp)
        block = np.frombuffer(raw, dtype=dtype).reshape(chunks)
        key = tuple(slice(i * c, (i + 1) * c)
                    for i, c in zip(idx, chunks))
        data[key] = block
    data = _finish(data[tuple(slice(0, s) for s in shape)])
    if dims is None:
        # phantom dims are named by SIZE (dim_<n>), like the NetCDF
        # reader's phony dims: naming them by position collided
        # different-sized axes of different arrays onto one dim name
        dims = tuple('dim_%d' % s for s in shape)
        if len(set(dims)) != len(dims):      # equal sizes: suffix
            dims = tuple('%s_%d' % (d, i)
                         for i, d in enumerate(dims))
    return tuple(dims), data, attrs


def open_zarr(path, device=None):
    """Open a Zarr v2 directory store written by :func:`to_zarr` (or by
    xarray/zarr-python with the ``_ARRAY_DIMENSIONS`` convention), with
    its numeric data on ``device`` (default ``cuda``)."""
    from ..core import Dataset, Variable
    ds = Dataset()
    gattrs_path = os.path.join(path, '.zattrs')
    if os.path.exists(gattrs_path):
        with open(gattrs_path) as fh:
            ds.attrs.update(json.load(fh))
    arrays = {}
    for name in sorted(os.listdir(path)):
        if name.startswith('.'):
            continue   # hidden entries incl. crashed-write temp dirs
        apath = os.path.join(path, name)
        if os.path.isdir(apath) and \
                os.path.exists(os.path.join(apath, '.zarray')):
            arrays[name] = _read_array(apath)
    # coords = arrays named after their only dimension, plus anything
    # listed in the group-level or per-variable (xarray convention)
    # 'coordinates' attributes
    coord_names = set()
    for name, (dims, _, _) in arrays.items():
        if dims == (name,):
            coord_names.add(name)
    extra = ds.attrs.pop('_nd_tpu_coordinates', None)
    if extra:
        coord_names.update(str(extra).split())
    # legacy/xarray group-level 'coordinates': consume it only when
    # every token names an array here (a user attribute that happens
    # to share the name stays untouched)
    legacy = ds.attrs.get('coordinates')
    if legacy and all(tok in arrays for tok in str(legacy).split()):
        coord_names.update(str(legacy).split())
        ds.attrs.pop('coordinates')
    for name, (dims, data, attrs) in arrays.items():
        per_var = attrs.get('coordinates')
        # consume the attr only when every token names an array here
        # (same guard as the group-level path: a user attribute that
        # happens to be called 'coordinates' survives the round trip)
        if per_var and all(tok in arrays
                           for tok in str(per_var).split()):
            coord_names.update(str(per_var).split())
            attrs.pop('coordinates')
    coord_names &= set(arrays)
    for name, (dims, data, attrs) in arrays.items():
        if name in coord_names:
            ds._coords[name] = Variable(dims, data, attrs, device=device)
    for name, (dims, data, attrs) in arrays.items():
        if name not in coord_names:
            ds._variables[name] = Variable(dims, data, attrs,
                                           device=device)
    return ds
