"""Labelled arrays with torch payloads: ``DataArray`` and ``Dataset``.

Counterpart of ``nd_tpu/core/dataarray.py``, cut to what the SAR change
and warp paths and the classifiers use: dims, sizes, ``data_vars``, item
access by name and by list, item assignment, ``to_array``,
``transpose``, ``squeeze``, ``expand_dims``, ``copy``, ``astype``,
``_replace``, attrs, coords (index coordinates and non-dimension ones
such as warp's 2-D ``lat``/``lon``), ``.values`` to numpy, the
arithmetic and comparison operators (aligned by dimension name),
``where``, ``isnull``/``notnull`` and the NaN-skipping reductions
(``mean``, ``std``, ``var``, ``min``, ``max``, ``sum``, ``count``).
Results stay on the operands' device. The ``.nd`` and ``.filter``
namespaces are attached by ``nd_tpu_torch.accessors``.
``from_jax_dataset`` converts any object with the JAX package's Dataset
surface. The rest of the data model is still to be ported (ROADMAP item
11).
"""

from __future__ import annotations

import numpy as np
import torch

from .variable import Variable, _operand, as_array

__all__ = ['DataArray', 'Dataset', 'broadcast_variables',
           'expand_variables_da', 'from_jax_dataset']


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


# -- NaN-skipping reductions (numpy's nan* semantics, ddof 0) ---------------

def _floating(x):
    """Integer and bool data reduce in float64, as numpy's nanmean."""
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(torch.float64)


def _nanmean(x, dim=None):
    return torch.nanmean(_floating(x), dim=dim)


def _nanvar(x, dim=None, ddof=0):
    x = _floating(x)
    dev = (x - torch.nanmean(x, dim=dim, keepdim=True)) ** 2
    cnt = (~torch.isnan(x)).sum(dim=dim)
    return torch.nansum(dev, dim=dim) / (cnt - ddof)


def _nanstd(x, dim=None, ddof=0):
    return torch.sqrt(_nanvar(x, dim, ddof))


def _nansum(x, dim=None):
    if x.is_floating_point():
        return torch.nansum(x, dim=dim)
    return torch.sum(x, dim=dim)


def _nanextreme(x, dim, fill, reduce):
    if dim is None:
        x, dim = x.reshape(-1), 0
    if not x.is_floating_point():
        return reduce(x, dim=dim)
    nan = torch.isnan(x)
    out = reduce(x.masked_fill(nan, fill), dim=dim)
    # an all-NaN slice gives NaN, as np.nanmin does
    return out.masked_fill(nan.all(dim=dim), float('nan'))


def _nanmin(x, dim=None):
    return _nanextreme(x, dim, float('inf'), torch.amin)


def _nanmax(x, dim=None):
    return _nanextreme(x, dim, float('-inf'), torch.amax)


def _where(cond, a, other):
    """``torch.where`` with numpy's promotion for a float ``other``
    against integer or bool data (to float64)."""
    if isinstance(other, float) and not (a.is_floating_point()
                                         or a.is_complex()):
        a = a.to(torch.float64)
    if cond.dtype != torch.bool:
        cond = cond != 0          # truthiness, as np.where reads it
    return torch.where(cond, a, other)


def _truediv(a, b):
    """``a / b``; two integer operands divide in float64, as numpy."""
    def integral(v):
        return isinstance(v, int) or (isinstance(v, torch.Tensor)
                                      and not v.is_floating_point()
                                      and not v.is_complex())
    if integral(a) and integral(b):
        a = a.to(torch.float64) if isinstance(a, torch.Tensor) \
            else float(a)
    return a / b


class _NDOpsMixin:
    """Arithmetic and comparison operators, elementwise (like xarray)."""

    def _apply_binary(self, other, op, reflexive=False):
        raise NotImplementedError

    def __add__(self, o):
        return self._apply_binary(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._apply_binary(o, lambda a, b: a + b, True)

    def __sub__(self, o):
        return self._apply_binary(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._apply_binary(o, lambda a, b: a - b, True)

    def __mul__(self, o):
        return self._apply_binary(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._apply_binary(o, lambda a, b: a * b, True)

    def __truediv__(self, o):
        return self._apply_binary(o, _truediv)

    def __rtruediv__(self, o):
        return self._apply_binary(o, _truediv, True)

    def __pow__(self, o):
        return self._apply_binary(o, lambda a, b: a ** b)

    def __mod__(self, o):
        return self._apply_binary(o, lambda a, b: a % b)

    def __and__(self, o):
        return self._apply_binary(o, lambda a, b: a & b)

    def __or__(self, o):
        return self._apply_binary(o, lambda a, b: a | b)

    def __xor__(self, o):
        return self._apply_binary(o, lambda a, b: a ^ b)

    def __lt__(self, o):
        return self._apply_binary(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._apply_binary(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._apply_binary(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._apply_binary(o, lambda a, b: a >= b)

    def __eq__(self, o):  # elementwise, like xarray
        return self._apply_binary(o, lambda a, b: a == b)

    def __ne__(self, o):
        return self._apply_binary(o, lambda a, b: a != b)

    __hash__ = None


class DataArray(_NDOpsMixin):
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

    def squeeze(self, dim=None):
        var = self.variable.squeeze(dim)
        dropped = set(self.dims) - set(var.dims)
        coords = {}
        for k, v in self._coords.items():
            for d in [d for d in v.dims if d in dropped]:
                v = v.squeeze(d)
            coords[k] = v
        return DataArray._from_parts(var, coords, self.attrs, self.name)

    def expand_dims(self, dim, axis=0):
        """A new axis ``dim`` of size 1 at ``axis`` (the dict form of
        the JAX package waits for ROADMAP item 11)."""
        if not isinstance(dim, str):
            raise TypeError('expand_dims takes one dimension name here; '
                            'the dict form is not ported yet (ROADMAP '
                            'item 11)')
        var = self.variable.expand_dims(dim, axis)
        coords = dict(self._coords)
        if dim in coords and coords[dim].ndim == 0:
            coords[dim] = coords[dim].expand_dims(dim)
        return DataArray._from_parts(var, coords, self.attrs, self.name)

    def where(self, cond, other=np.nan):
        """Keep the data where ``cond`` holds, else ``other``; a
        DataArray ``cond`` or ``other`` is aligned by dimension name."""
        if isinstance(cond, DataArray):
            a, b = broadcast_variables(self.variable, cond.variable)
            if isinstance(other, DataArray):
                a, o = broadcast_variables(a, other.variable)
                b, _ = broadcast_variables(b, o)
                other = o.data
            return self._replace(_where(b.data, a.data, other), dims=a.dims)
        if isinstance(other, DataArray):
            a, o = broadcast_variables(self.variable, other.variable)
            return self._replace(_where(_operand(cond, a.data), a.data,
                                        o.data), dims=a.dims)
        return self._replace(_where(_operand(cond, self.data), self.data,
                                    other))

    def isnull(self):
        data = self.data
        if not isinstance(data, torch.Tensor):
            # datetimes and strings stay numpy; NaT is null (xarray)
            null = np.isnat(data) if data.dtype.kind in 'mM' \
                else np.zeros(data.shape, bool)
            return self._replace(torch.from_numpy(null))
        if data.is_floating_point() or data.is_complex():
            return self._replace(torch.isnan(data))
        return self._replace(torch.zeros_like(data, dtype=torch.bool))

    def notnull(self):
        out = self.isnull()
        return out._replace(torch.logical_not(out.data))

    # -- arithmetic -----------------------------------------------------------
    def _apply_binary(self, other, op, reflexive=False):
        if isinstance(other, Dataset):
            return NotImplemented
        if isinstance(other, DataArray):
            var = self.variable._binary_op(other.variable, op, reflexive)
            coords = dict(other._coords)
            coords.update(self._coords)
            coords = {k: v for k, v in coords.items()
                      if set(v.dims).issubset(set(var.dims))}
            name = self.name if self.name == other.name else None
            return DataArray._from_parts(var, coords, {}, name)
        var = self.variable._binary_op(other, op, reflexive)
        return DataArray._from_parts(var, self._coords, {}, self.name)

    def __neg__(self):
        return self._replace(-self.data)

    def __abs__(self):
        return self._replace(torch.abs(self.data))

    def __invert__(self):
        return self._replace(torch.logical_not(self.data))

    # -- reductions -------------------------------------------------------------
    def reduce(self, func, dim=None, **kwargs):
        """Reduce with ``func(data, dim=...)`` over the named dims (all
        of them for ``None``)."""
        var = self.variable.reduce(func, dim, **kwargs)
        coords = {k: v for k, v in self._coords.items()
                  if set(v.dims).issubset(set(var.dims))}
        return DataArray._from_parts(var, coords, self.attrs, self.name)

    def mean(self, dim=None, **kw):
        return self.reduce(_nanmean, dim, **kw)

    def std(self, dim=None, **kw):
        return self.reduce(_nanstd, dim, **kw)

    def var(self, dim=None, **kw):
        return self.reduce(_nanvar, dim, **kw)

    def min(self, dim=None, **kw):
        return self.reduce(_nanmin, dim, **kw)

    def max(self, dim=None, **kw):
        return self.reduce(_nanmax, dim, **kw)

    def sum(self, dim=None, **kw):
        return self.reduce(_nansum, dim, **kw)

    def count(self, dim=None, **kw):
        return self.notnull().astype(torch.int64).reduce(torch.sum, dim,
                                                           **kw)

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


class Dataset(_NDOpsMixin):
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

    def squeeze(self, dim=None):
        if dim is not None and self.sizes.get(dim, 1) != 1:
            raise ValueError('cannot squeeze dim %r of length %d'
                             % (dim, self.sizes[dim]))
        sizes = self.sizes
        ds = Dataset(attrs=self.attrs)
        for key, table in (('_coords', self._coords),
                           ('_variables', self._variables)):
            for k, v in table.items():
                for d in [d for d in v.dims
                          if d == dim or (dim is None and sizes[d] == 1)]:
                    v = v.squeeze(d)
                getattr(ds, key)[k] = v
        return ds

    def expand_dims(self, dim, axis=0):
        ds = Dataset(attrs=self.attrs)
        ds._coords = dict(self._coords)
        for k, v in self._variables.items():
            ds._variables[k] = v.expand_dims(dim, axis)
        if dim in ds._coords and ds._coords[dim].ndim == 0:
            ds._coords[dim] = ds._coords[dim].expand_dims(dim)
        return ds

    def map(self, func, **kwargs):
        """``func(DataArray)`` over every data variable."""
        ds = Dataset(attrs=self.attrs)
        ds._coords = dict(self._coords)
        for k in self._variables:
            res = func(self[k], **kwargs)
            ds._variables[k] = Variable(res.dims, res.data, res.attrs)
            for ck, cv in res._coords.items():
                if ck not in ds._coords:
                    ds._coords[ck] = cv
        return ds

    def where(self, cond, other=np.nan):
        return self.map(lambda da: da.where(
            cond if not isinstance(cond, Dataset) else cond[da.name], other))

    def isnull(self):
        return self.map(lambda da: da.isnull())

    def notnull(self):
        return self.map(lambda da: da.notnull())

    # -- arithmetic ---------------------------------------------------------------
    def _apply_binary(self, other, op, reflexive=False):
        ds = Dataset(attrs={})
        ds._coords = dict(self._coords)
        for k, v in self._variables.items():
            if isinstance(other, Dataset):
                o = other._variables.get(k)
                if o is None:
                    continue
            elif isinstance(other, DataArray):
                o = other.variable
            else:
                o = other
            ds._variables[k] = v._binary_op(o, op, reflexive)
        return ds

    # -- reductions ---------------------------------------------------------------
    def _reduce_all(self, name, dim=None, **kw):
        dims = None if dim is None else (
            {dim} if isinstance(dim, str) else set(dim))
        ds = Dataset(attrs=self.attrs)
        for k, v in self._coords.items():
            if dims is None or not set(v.dims) & dims:
                ds._coords[k] = v
        for k in self._variables:
            da = self[k]
            if dims is not None:
                sub = tuple(d for d in da.dims if d in dims)
                res = getattr(da, name)(dim=sub, **kw) if sub else da
            else:
                res = getattr(da, name)(dim=None, **kw)
            ds._variables[k] = Variable(res.dims, res.data, res.attrs)
        return ds

    def mean(self, dim=None, **kw):
        return self._reduce_all('mean', dim, **kw)

    def std(self, dim=None, **kw):
        return self._reduce_all('std', dim, **kw)

    def var(self, dim=None, **kw):
        return self._reduce_all('var', dim, **kw)

    def min(self, dim=None, **kw):
        return self._reduce_all('min', dim, **kw)

    def max(self, dim=None, **kw):
        return self._reduce_all('max', dim, **kw)

    def sum(self, dim=None, **kw):
        return self._reduce_all('sum', dim, **kw)

    def count(self, dim=None, **kw):
        return self._reduce_all('count', dim, **kw)

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


def broadcast_variables(a, b):
    """Broadcast two Variables against each other by dimension name."""
    out_dims = list(a.dims)
    for d in b.dims:
        if d not in out_dims:
            out_dims.append(d)
    sizes = dict(zip(a.dims, a.shape))
    for d, s in zip(b.dims, b.shape):
        sizes[d] = max(sizes.get(d, s), s)
    shape = tuple(sizes[d] for d in out_dims)
    return (a.broadcast_to(out_dims, shape), b.broadcast_to(out_dims, shape))


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
