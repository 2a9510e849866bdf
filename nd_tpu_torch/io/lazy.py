"""Lazily read file-backed arrays.

Counterpart of ``nd_tpu/io/lazy.py``. ``open_netcdf(..., chunks=...)``
and ``open_rasterio(..., chunks=...)`` return datasets whose data
variables are lazy views: nothing is read at open time, basic indexing
(ints, slices, steps) composes lazily, and the file slab is read only
when the values are needed. ``np.asarray``, ``.values`` and
``to_netcdf`` read it into host numpy; any computation on the
variable's data reads it onto the variable's device
(``core.variable.Variable``). This lets ``tiling.tile`` and
``map_over_tiles`` stream a file larger than memory: each tile's
``isel`` slices the view, and only its own slab is read.

A file is opened for each read and closed right after it, so views are
safe to pass between threads and never pin a file descriptor or a
memory mapping. netCDF-4 reads go through ``h5py``; netCDF classic
(the only route where ``h5py`` is missing) reads each slab's rows at
their offsets into a native-endian array, with no memory mapping (a
sandbox that counts a mapped file as resident whole would otherwise see
every read pin the file). GeoTIFF views decode only the strips or tiles
their window intersects.
"""

from __future__ import annotations

import numpy as np

__all__ = ['LazyArray', 'LazyNetCDFArray', 'LazyGeoTIFFArray']


def _native(dtype):
    dtype = np.dtype(dtype)
    return dtype if dtype.isnative else dtype.newbyteorder('=')


class LazyArray:
    """Base for lazy views of one on-disk array.

    Subclasses implement ``_materialize(key)``, which reads the file slab
    selected by ``key`` (a tuple of slices and ints over the *stored*
    array, slices with non-negative steps), and ``_clone(key, shape)``,
    which returns a new view of the same file with the composed key.

    Parameters
    ----------
    shape, dtype :
        Shape and dtype of this view after the decode (native byte
        order).
    key : tuple of (slice or int), optional
        Indexing into the stored array (default: all of it).
    decode : callable, optional
        Applied to each raw slab after reading (the CF decode).
    """

    def __init__(self, shape, dtype, key=None, decode=None):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = _native(dtype)
        if key is None:
            key = tuple(slice(0, s, 1) for s in self.shape)
        self._key = tuple(key)
        self._decode = decode

    # -- subclass hooks ----------------------------------------------------
    def _materialize(self, key):
        raise NotImplementedError

    def _clone(self, key, shape):
        raise NotImplementedError

    # -- array protocol ----------------------------------------------------
    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self):
        return self.size * self.dtype.itemsize

    def __len__(self):
        if not self.shape:
            raise TypeError('len() of a 0-d lazy array')
        return self.shape[0]

    # -- materialization ---------------------------------------------------
    def _read(self):
        raw = np.asarray(self._materialize(self._key))
        if not raw.dtype.isnative:
            raw = raw.astype(_native(raw.dtype))
        if self._decode is not None:
            raw = self._decode(raw)
        return raw

    def __array__(self, dtype=None, copy=None):
        out = self._read()
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out

    @property
    def values(self):
        return self._read()

    # -- lazy indexing -----------------------------------------------------
    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > self.ndim:
            raise IndexError(
                'too many indices for array: array is %d-dimensional, '
                'but %d were indexed' % (self.ndim, len(key)))

        def _is_lazy_ok(k):
            if isinstance(k, slice):
                return True
            if isinstance(k, (bool, np.bool_)):
                return False           # numpy: a mask, not an index
            if isinstance(k, float) or (hasattr(k, 'dtype')
                                        and np.ndim(k) == 0
                                        and np.asarray(k).dtype.kind
                                        == 'f'):
                raise IndexError(
                    'only integers, slices and arrays are valid '
                    'indices (got float)')
            return np.isscalar(k) or (hasattr(k, 'ndim')
                                      and np.ndim(k) == 0)

        if any(k is None or k is Ellipsis or not _is_lazy_ok(k)
               for k in key):
            # fancy, newaxis or bool indexing: read, then numpy's rules
            return self._read()[key]
        key = key + (slice(None),) * (self.ndim - len(key))

        new_key = []
        new_shape = []
        view_axis = 0
        for stored in self._key:
            if isinstance(stored, int):
                new_key.append(stored)       # an axis already dropped
                continue
            b0, _, bs = stored.indices(np.iinfo(np.int64).max)
            n = self.shape[view_axis]
            k = key[view_axis]
            view_axis += 1
            if isinstance(k, slice):
                s0, s1, ss = k.indices(n)
                if ss < 0:
                    return self._read()[key]   # a reversed view: read
                new_key.append(slice(b0 + s0 * bs, b0 + s1 * bs,
                                     bs * ss))
                new_shape.append(max(0, -(-(s1 - s0) // ss)))
            else:
                i = int(k)
                if i < 0:
                    i += n
                if not 0 <= i < n:
                    raise IndexError(
                        'index %d out of bounds for axis of size %d'
                        % (k, n))
                new_key.append(b0 + i * bs)
        return self._clone(tuple(new_key), tuple(new_shape))

    def astype(self, dtype, copy=True):
        return self._read().astype(dtype, copy=copy)

    def __repr__(self):
        return ('%s(shape=%s, dtype=%s)'
                % (type(self).__name__, self.shape, self.dtype))


class LazyNetCDFArray(LazyArray):
    """A lazy view of one netCDF variable with an optional decode step:
    netCDF-4 through ``h5py``, or netCDF classic, whose variable
    ``classic`` locates: ``(begin, stride, stored shape, stored
    dtype)`` (``io.netcdf._classic_layout``)."""

    def __init__(self, path, name, shape, dtype, key=None, decode=None,
                 classic=None):
        super().__init__(shape, dtype, key=key, decode=decode)
        self._path = path
        self._name = name
        self._classic = classic

    def _materialize(self, key):
        if self._classic is not None:
            from .netcdf import _read_classic_slab
            return _read_classic_slab(self._path, *self._classic, key)
        import h5py
        with h5py.File(self._path, 'r') as f:
            return f[self._name][key]

    def _clone(self, key, shape):
        return LazyNetCDFArray(self._path, self._name, shape, self.dtype,
                               key=key, decode=self._decode,
                               classic=self._classic)

    def __repr__(self):
        return ('LazyNetCDFArray(%r:%r, shape=%s, dtype=%s)'
                % (self._path, self._name, self.shape, self.dtype))


class LazyGeoTIFFArray(LazyArray):
    """A lazy (band, y, x) view of a GeoTIFF raster.

    A read opens the file, decodes only the strips or tiles the selected
    window intersects (``TiffFile.read_window``) and closes it again.
    """

    def __init__(self, path, shape, dtype, key=None, decode=None,
                 full_shape=None):
        super().__init__(shape, dtype, key=key, decode=decode)
        self._path = path
        # the stored raster's shape (the view's key indexes into it)
        self._full_shape = self.shape if full_shape is None \
            else tuple(full_shape)

    def _materialize(self, key):
        from .geotiff import TiffFile
        bk, yk, xk = key

        def _bounds(k, n):
            if isinstance(k, int):
                return k, k + 1, 1, True
            start, stop, step = k.indices(n)
            return start, max(start, stop), step, False

        nb, ny, nx = self._full_shape
        b0, b1, bs, bdrop = _bounds(bk, nb)
        y0, y1, ys, ydrop = _bounds(yk, ny)
        x0, x1, xs, xdrop = _bounds(xk, nx)
        bands = list(range(b0, b1, bs))
        with TiffFile(self._path) as t:
            out = t.read_window(bands, y0, y1, x0, x1)
        out = out[:, ::ys, ::xs]
        if xdrop:
            out = out[:, :, 0]
        if ydrop:
            out = out[:, 0]
        if bdrop:
            out = out[0]
        return out

    def _clone(self, key, shape):
        return LazyGeoTIFFArray(self._path, shape, self.dtype, key=key,
                                decode=self._decode,
                                full_shape=self._full_shape)

    @classmethod
    def from_file(cls, path, shape, dtype, decode=None):
        return cls(str(path), shape, dtype, decode=decode)

    def __repr__(self):
        return ('LazyGeoTIFFArray(%r, shape=%s, dtype=%s)'
                % (self._path, self.shape, self.dtype))
