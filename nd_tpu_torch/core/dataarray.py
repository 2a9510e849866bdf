"""Labelled arrays with torch payloads: ``DataArray`` and ``Dataset``.

Counterpart of ``nd_tpu/core/dataarray.py``, cut to what the SAR change
and warp paths use: dims, sizes, ``data_vars``, item access by name and
by list, item assignment, ``to_array``, ``transpose``, ``copy``,
``astype``, ``_replace``, attrs, coords (index coordinates and
non-dimension ones such as warp's 2-D ``lat``/``lon``), and ``.values``
to numpy. The ``.nd`` and ``.filter`` namespaces are attached by
``nd_tpu_torch.accessors``. ``from_jax_dataset``
converts any object with the JAX package's Dataset surface. The rest of
the data model is still to be ported (ROADMAP item 11).
"""

from __future__ import annotations

import numpy as np
import torch

from .variable import Variable, as_array

__all__ = ['DataArray', 'Dataset', 'expand_variables_da',
           'from_jax_dataset']


class _CoordsView:
    """Mapping view over an object's coordinates."""

    def __init__(self, obj):
        self._obj = obj

    def __getitem__(self, key):
        return self._obj._coord_dataarray(key)

    def __setitem__(self, key, value):
        self._obj._set_coord(key, value)

    def __contains__(self, key):
        return key in self._obj._coords

    def __iter__(self):
        return iter(self._obj._coords)

    def __len__(self):
        return len(self._obj._coords)

    def keys(self):
        return self._obj._coords.keys()

    def items(self):
        return ((k, self[k]) for k in self._obj._coords)


def _coerce_coord(name, value, device=None):
    if isinstance(value, Variable):
        return value
    if isinstance(value, DataArray):
        return Variable(value.dims, value.data, value.attrs)
    if isinstance(value, tuple) and len(value) in (2, 3) \
            and isinstance(value[0], (tuple, list, str)):
        return Variable(value[0], value[1],
                        value[2] if len(value) == 3 else None, device)
    arr = as_array(value, device)
    if arr.ndim == 0:
        return Variable((), arr)
    if arr.ndim == 1:
        return Variable((name,), arr)
    raise ValueError('cannot infer dimensions for %d-d coordinate %r; pass '
                     '(dims, data)' % (arr.ndim, name))


def _check_sizes(sizes, var, what):
    for d, s in zip(var.dims, var.shape):
        if sizes.get(d, s) != s:
            raise ValueError('%s conflicts on dim %r (%d != %d)'
                             % (what, d, s, sizes[d]))


class DataArray:
    """A labelled n-dimensional tensor with coordinates and attributes.

    Numeric non-tensor ``data`` and coordinates land on ``device``
    (default ``cuda``); a tensor stays on its device.
    """

    def __init__(self, data, coords=None, dims=None, attrs=None, name=None,
                 device=None):
        data = as_array(data, device)
        if dims is None:
            dims = tuple('dim_%d' % i for i in range(data.ndim))
        self.variable = Variable(dims, data)
        self._coords = {}
        self.attrs = dict(attrs) if attrs else {}
        self.name = name
        for k, v in dict(coords or {}).items():
            self._set_coord(k, v, device)

    @classmethod
    def _from_parts(cls, variable, coords, attrs, name):
        obj = cls.__new__(cls)
        obj.variable = variable
        obj._coords = dict(coords)
        obj.attrs = dict(attrs) if attrs else {}
        obj.name = name
        return obj

    def _set_coord(self, key, value, device=None):
        var = _coerce_coord(key, value, device)
        _check_sizes(self.sizes, var, 'coordinate %r' % key)
        self._coords[key] = var

    def _coord_dataarray(self, key):
        var = self._coords[key]
        sub = {k: v for k, v in self._coords.items()
               if set(v.dims).issubset(set(var.dims))}
        return DataArray._from_parts(var, sub, var.attrs, key)

    @property
    def data(self):
        return self.variable.data

    @data.setter
    def data(self, value):
        value = as_array(value)
        if tuple(value.shape) != self.shape:
            raise ValueError('shape mismatch')
        self.variable = Variable(self.dims, value, self.variable.attrs)

    @property
    def values(self):
        return self.variable.values

    @property
    def dims(self):
        return self.variable.dims

    @property
    def shape(self):
        return self.variable.shape

    @property
    def ndim(self):
        return self.variable.ndim

    @property
    def dtype(self):
        return self.variable.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def coords(self):
        return _CoordsView(self)

    def _replace(self, data, dims=None, coords=None, name=None):
        dims = self.dims if dims is None else dims
        coords = self._coords if coords is None else coords
        coords = {k: v for k, v in coords.items()
                  if set(v.dims).issubset(set(dims))}
        return DataArray._from_parts(Variable(dims, data), coords,
                                     self.attrs,
                                     self.name if name is None else name)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._coord_dataarray(key)
        raise TypeError('positional indexing is not ported yet '
                        '(ROADMAP item 11)')

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self._set_coord(key, value)
            return
        raise TypeError('positional assignment not supported')

    def __contains__(self, key):
        return key in self._coords

    def copy(self, deep=True):
        return DataArray._from_parts(
            self.variable.copy(deep),
            {k: v.copy(deep) for k, v in self._coords.items()},
            dict(self.attrs), self.name)

    def astype(self, dtype):
        return self._replace(self.variable.astype(dtype).data)

    def transpose(self, *dims):
        if not dims:
            dims = self.dims[::-1]
        dims = tuple(d for d in dims if d in self.dims)
        return DataArray._from_parts(self.variable.transpose(*dims),
                                     self._coords, self.attrs, self.name)

    def to_dataset(self, name=None):
        name = name or self.name
        if name is None:
            raise ValueError('cannot convert unnamed DataArray to Dataset')
        ds = Dataset(attrs=self.attrs)
        ds._coords.update(self._coords)
        ds[name] = self
        return ds

    def __repr__(self):
        return '<nd_tpu_torch.DataArray %r %r %s>' % (
            self.name, self.sizes, self.dtype)


class Dataset:
    """A dict of DataArrays sharing dimensions and coordinates.

    Numeric non-tensor data variables and coordinates land on ``device``
    (default ``cuda``); a tensor stays on its device.
    """

    def __init__(self, data_vars=None, coords=None, attrs=None, device=None):
        self._variables = {}
        self._coords = {}
        self.attrs = dict(attrs) if attrs else {}
        for k, v in dict(coords or {}).items():
            self._set_coord(k, v, device)
        for k, v in dict(data_vars or {}).items():
            self._assign(k, v, device)

    def _set_coord(self, key, value, device=None):
        var = _coerce_coord(key, value, device)
        _check_sizes(self.sizes, var, 'coordinate %r' % key)
        self._coords[key] = var

    def _coord_dataarray(self, key):
        var = self._coords[key]
        sub = {k: v for k, v in self._coords.items()
               if set(v.dims).issubset(set(var.dims))}
        return DataArray._from_parts(var, sub, var.attrs, key)

    @property
    def data_vars(self):
        return {k: self[k] for k in self._variables}

    @property
    def coords(self):
        return _CoordsView(self)

    @property
    def sizes(self):
        """Mapping dim -> size, in coordinate-then-variable order."""
        out = {}
        for v in list(self._coords.values()) + list(self._variables.values()):
            for d, s in zip(v.dims, v.shape):
                out.setdefault(d, s)
        return out

    @property
    def dims(self):
        return dict(sorted(self.sizes.items()))

    def __getitem__(self, key):
        if isinstance(key, (list, tuple)):
            ds = Dataset(attrs=self.attrs)
            keep = set()
            for k in key:
                if k not in self._variables:
                    raise KeyError(k)
                ds._variables[k] = self._variables[k]
                keep |= set(self._variables[k].dims)
            for ck, cv in self._coords.items():
                if set(cv.dims).issubset(keep):
                    ds._coords[ck] = cv
            return ds
        if key in self._variables:
            var = self._variables[key]
            coords = {k: v for k, v in self._coords.items()
                      if set(v.dims).issubset(set(var.dims))}
            return DataArray._from_parts(var, coords, var.attrs, key)
        if key in self._coords:
            return self._coord_dataarray(key)
        raise KeyError(key)

    def __setitem__(self, key, value):
        self._assign(key, value)

    def _assign(self, key, value, device=None):
        if isinstance(value, DataArray):
            var = Variable(value.dims, value.data, value.attrs)
            for ck, cv in value._coords.items():
                self._coords.setdefault(ck, cv)
        elif isinstance(value, Variable):
            var = value
        elif isinstance(value, tuple) and len(value) in (2, 3):
            var = Variable(value[0], value[1],
                           value[2] if len(value) == 3 else None, device)
        else:
            raise TypeError('cannot assign %r to a Dataset variable; use '
                            '(dims, data) or a DataArray' % type(value))
        if var.dims == (key,):
            # a 1-d variable named after its own dimension is an index
            # coordinate, not a data variable
            self._set_coord(key, var)
            return
        sizes = {}
        for k2, v2 in list(self._coords.items()) \
                + list(self._variables.items()):
            if k2 == key and v2 is self._variables.get(key):
                continue
            for d, s in zip(v2.dims, v2.shape):
                sizes.setdefault(d, s)
        _check_sizes(sizes, var, 'variable %r' % key)
        self._variables[key] = var

    def __contains__(self, key):
        return key in self._variables or key in self._coords

    def __iter__(self):
        return iter(self._variables)

    def __len__(self):
        return len(self._variables)

    def keys(self):
        return self._variables.keys()

    def copy(self, deep=True):
        ds = Dataset(attrs=dict(self.attrs))
        ds._coords = {k: v.copy(deep) for k, v in self._coords.items()}
        ds._variables = {k: v.copy(deep) for k, v in self._variables.items()}
        return ds

    def astype(self, dtype):
        ds = self.copy(deep=False)
        ds._variables = {k: v.astype(dtype)
                         for k, v in self._variables.items()}
        return ds

    def transpose(self, *dims):
        ds = Dataset(attrs=self.attrs)
        ds._coords = dict(self._coords)
        for k, v in self._variables.items():
            order = tuple(d for d in dims if d in v.dims) if dims \
                else tuple(reversed(v.dims))
            extra = tuple(d for d in v.dims if d not in order)
            ds._variables[k] = v.transpose(*(order + extra))
        return ds

    def to_array(self, dim='variable'):
        """Stack all data variables into one DataArray along a new
        leading ``dim`` (variables are broadcast to the union of dims)."""
        if not self._variables:
            raise ValueError('empty dataset')
        names = list(self._variables)
        union = []
        for v in self._variables.values():
            union += [d for d in v.dims if d not in union]
        sizes = self.sizes
        shape = tuple(sizes[d] for d in union)
        data = torch.stack([self._variables[n].broadcast_to(union, shape).data
                            for n in names])
        coords = dict(self._coords)
        coords[dim] = Variable((dim,), np.asarray(names))
        return DataArray._from_parts(Variable((dim,) + tuple(union), data),
                                     coords, self.attrs, None)

    def __repr__(self):
        return '<nd_tpu_torch.Dataset %r vars=%r>' % (
            self.sizes, list(self._variables))


def expand_variables_da(da, dim='variable'):
    """Inverse of :meth:`Dataset.to_array`."""
    names = [str(n) for n in np.asarray(da[dim].values)]
    axis = da.dims.index(dim)
    ds = Dataset(attrs=dict(da.attrs))
    for k, v in da._coords.items():
        if k != dim:
            ds._coords[k] = v
    new_dims = tuple(d for d in da.dims if d != dim)
    for i, n in enumerate(names):
        ds._variables[n] = Variable(new_dims, da.data.select(axis, i))
    return ds


def from_jax_dataset(obj, device=None):
    """Convert any object with the JAX package's Dataset surface
    (``data_vars``, ``ds[v].dims``, ``ds[v].values``, ``attrs``,
    ``coords``) into a :class:`Dataset`, data variables and numeric
    coordinates as tensors on ``device`` (default ``cuda``). Read by
    duck typing: the JAX package is not imported."""
    ds = Dataset(attrs=dict(getattr(obj, 'attrs', {}) or {}))
    coords = getattr(obj, 'coords', None)
    if coords is not None:
        for k in list(coords.keys()):
            c = coords[k]
            ds._coords[k] = Variable(tuple(c.dims), np.asarray(c.values),
                                     dict(getattr(c, 'attrs', {}) or {}),
                                     device)
    for v in obj.data_vars:
        da = obj[v]
        data = np.array(da.values, copy=True, order='C')
        ds[v] = Variable(tuple(da.dims), data,
                         dict(getattr(da, 'attrs', {}) or {}), device)
    return ds
