"""Labelled arrays with torch payloads: ``DataArray`` and ``Dataset``.

Counterpart of ``nd_tpu/core/dataarray.py``: dims, sizes, coordinates
(index coordinates and non-dimension ones such as warp's 2-D
``lat``/``lon``), attrs; positional and label indexing (``isel``,
``sel`` with ``method`` nearest, pad or backfill, slices and datetime
strings, ``loc``, ``head``/``tail``/``thin``, the ``drop_*`` family,
``reindex``, ``sortby``); combining and reshaping (``concat``,
``merge``, ``broadcast``, ``full_like``, ``stack``/``unstack``,
``expand_dims``, ``rename*``, ``swap_dims``, ``set_coords``/
``reset_coords``, ``assign*``, ``update``, ``combine_first``); the
arithmetic and comparison operators (aligned by dimension name) and
``where``; NaN-skipping reductions, ``quantile`` and accumulations
(``core/nanops.py``); gap filling (``fillna``, ``ffill``/``bfill``,
``dropna``, ``interpolate_na``) and regridding (``interp``,
``interp_like``); ``groupby``/``resample``/``rolling``/``coarsen``/
``weighted`` and ``.dt`` (``core/grouped.py``); serialisation and the
pandas bridge (``to_series``, ``to_dataframe``, ``to_index``,
``get_index``: they import pandas when called, and nothing else here
needs it).

Numeric payloads are tensors and stay on the device of the operands;
coordinates computed on the host land on the device of the object they
belong to. Datetime and string payloads stay numpy. The ``.nd`` and
``.filter`` namespaces are attached by ``nd_tpu_torch.accessors``.
``from_jax_dataset`` converts any object with the JAX package's Dataset
surface.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import nanops
from .variable import (Variable, _operand, add, as_array, less,
                       less_equal, promote, sub, to_numpy, torch_dtype,
                       truediv)

__all__ = ['DataArray', 'Dataset', 'broadcast_variables', 'broadcast',
           'concat', 'merge', 'full_like', 'zeros_like', 'ones_like',
           'expand_variables_da', 'from_jax_dataset']

_STACK_ATTR = '_nd_tpu_stacked'


class _CoordsView:
    """Mapping view over an object's coordinates."""

    def __init__(self, obj):
        self._obj = obj

    def __getitem__(self, key):
        return self._obj._coord_dataarray(key)

    def __setitem__(self, key, value):
        self._obj._set_coord(key, value)

    def __delitem__(self, key):
        del self._obj._coords[key]

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

    def values(self):
        return (self[k] for k in self._obj._coords)

    def variables(self):
        return dict(self._obj._coords)

    def __repr__(self):
        return 'Coordinates: ' + ', '.join(
            '%s %r' % (k, v.dims) for k, v in self._obj._coords.items())


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


def _normalize_indexers(indexers, kwargs):
    indexers = dict(indexers or {})
    indexers.update(kwargs)
    return indexers


def _device_of(obj):
    """The device of an object's tensors (payload first, then its
    coordinates and variables); None where it holds none (host numpy
    arrays then land on the default device)."""
    tables = [getattr(obj, '_coords', {})]
    if isinstance(obj, Dataset):
        tables.insert(0, obj._variables)
    elif isinstance(obj, DataArray) and obj.variable.device is not None:
        return obj.variable.device
    for table in tables:
        for v in table.values():
            if v.device is not None:
                return v.device
    return None


def _var(dims, values, attrs=None, like=None):
    """A Variable of host ``values`` on the device of ``like`` (the host
    where ``like`` holds no tensor: values derived from host data such
    as datetimes stay there)."""
    if like is None:
        return Variable(dims, values, attrs)
    return Variable(dims, values, attrs, _device_of(like) or 'cpu')


def _kind(data):
    """numpy's dtype kind of a tensor or an array."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.bool:
            return 'b'
        if data.is_complex():
            return 'c'
        if data.is_floating_point():
            return 'f'
        return 'u' if data.dtype == torch.uint8 else 'i'
    return np.asarray(data).dtype.kind


def _is_nan_fill(fill_value):
    try:
        return bool(np.isnan(fill_value))
    except (TypeError, ValueError):
        return False


def _fill_for(fill_value, data):
    """The fill for a payload: NaN on a datetime or timedelta array means
    NaT (keeping the dtype)."""
    kind = _kind(data)
    if kind in 'mM' and _is_nan_fill(fill_value):
        return np.asarray('NaT', dtype=np.asarray(data).dtype)
    return fill_value


def _promote_for(fill_value, data):
    """Integer and bool data become float64 where the fill is NaN."""
    if _kind(data) in 'iub' and _is_nan_fill(fill_value):
        return data.to(torch.float64) if isinstance(data, torch.Tensor) \
            else data.astype(np.float64)
    return data


def _where_any(cond, a, b):
    """``where`` over a tensor or a numpy payload; ``cond`` may be numpy
    (it goes to the payload's device)."""
    if isinstance(a, torch.Tensor):
        cond = torch.as_tensor(cond, device=a.device) \
            if not isinstance(cond, torch.Tensor) else cond
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(np.asarray(b), dtype=a.dtype,
                                device=a.device)
        return torch.where(cond, a, b)
    return np.where(to_numpy(cond), a, b)


def _cat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        dev = parts[0].device
        return torch.cat([torch.as_tensor(p, device=dev) for p in parts],
                         dim=axis)
    return np.concatenate([to_numpy(p) for p in parts], axis=axis)


def _full(shape, fill, like):
    if isinstance(like, torch.Tensor):
        return torch.full(tuple(shape), fill, dtype=like.dtype,
                          device=like.device)
    return np.full(tuple(shape), fill, dtype=like.dtype)


def _flip(a, axis):
    return torch.flip(a, (axis,)) if isinstance(a, torch.Tensor) \
        else np.flip(a, axis=axis)


def _shift_with_fill(a, axis, p, fill):
    """``a`` shifted ``p`` positions toward higher indices along
    ``axis``; vacated entries take ``fill``."""
    n = a.shape[axis]
    shape = list(a.shape)
    shape[axis] = min(p, n)
    key = [slice(None)] * a.ndim
    key[axis] = slice(0, max(n - p, 0))
    return _cat([_full(shape, fill, a), a[tuple(key)]], axis)


def _arange(n, shape, like):
    if isinstance(like, torch.Tensor):
        return torch.arange(n, dtype=torch.int32,
                            device=like.device).reshape(shape)
    return np.arange(n, dtype=np.int32).reshape(shape)


def _propagate_last_valid(valid, payloads, axis):
    """Position of (and payloads at) the most recent valid element at or
    before each index along ``axis``, by log-step pointer doubling
    (shifts and selects, no gather). Returns ``(pos, payloads)``: ``pos``
    is -1 where no valid element precedes; payload entries there are
    garbage and must stay masked."""
    n = valid.shape[axis]
    shape = [1] * valid.ndim
    shape[axis] = n
    ar = _arange(n, shape, valid)
    pos = _where_any(valid, ar, np.int32(-1))
    payloads = list(payloads)
    p = 1
    while p < n:
        pos_c = _shift_with_fill(pos, axis, p, -1)
        take = pos_c > pos
        payloads = [_where_any(take, _shift_with_fill(x, axis, p, 0), x)
                    for x in payloads]
        pos = _where_any(take, pos_c, pos)
        p *= 2
    return pos, payloads


def _as_float_index(values):
    """A coordinate as float64 positions: datetimes become ns since the
    epoch so gap arithmetic works uniformly."""
    values = to_numpy(values)
    if values.dtype.kind == 'M':
        return values.astype('datetime64[ns]').astype('int64') \
            .astype('float64')
    if values.dtype.kind == 'm':
        return values.astype('timedelta64[ns]').astype('int64') \
            .astype('float64')
    return values.astype('float64')


def _coerce_label(x, values):
    if isinstance(x, slice) or x is None:
        return x
    if values.dtype.kind in 'mM':
        return np.asarray(x, dtype=values.dtype)
    return np.asarray(to_numpy(x), dtype=values.dtype)


def _sel_to_isel(coord_var, label, method=None):
    """A label selection on a 1-d coordinate as positions: exact labels,
    or with ``method`` 'nearest', 'pad'/'ffill' (the nearest label at or
    before) or 'backfill'/'bfill' (the nearest at or after); slices keep
    the labels inside their bounds."""
    if method not in (None, 'nearest', 'pad', 'ffill', 'backfill', 'bfill'):
        raise ValueError('method must be None, nearest, pad/ffill or '
                         'backfill/bfill, got %r' % (method,))
    values = coord_var.values
    if isinstance(label, slice):
        lo, hi = label.start, label.stop
        mask = np.ones(len(values), dtype=bool)
        ascending = len(values) < 2 or values[0] <= values[-1]
        if lo is not None:
            lo = _coerce_label(lo, values)
            mask &= (values >= lo) if ascending else (values <= lo)
        if hi is not None:
            hi = _coerce_label(hi, values)
            mask &= (values <= hi) if ascending else (values >= hi)
        idx = np.nonzero(mask)[0]
        if len(idx) == 0:
            return slice(0, 0)
        return slice(int(idx[0]), int(idx[-1]) + 1)
    label_arr = _coerce_label(label, values)
    scalar = np.ndim(label_arr) == 0
    label_arr = np.atleast_1d(label_arr)
    out = np.empty(len(label_arr), dtype=np.int64)
    num = _as_float_index(values) if values.dtype.kind in 'mMfiu' else None
    for i, lab in enumerate(label_arr):
        matches = np.nonzero(values == lab)[0]
        if len(matches) and method != 'nearest':
            out[i] = int(matches[0])
            continue
        if method is None:
            raise KeyError('label %r not found in coordinate' % (lab,))
        x = float(_as_float_index(np.asarray(lab, dtype=values.dtype)))
        if method == 'nearest':
            out[i] = int(np.argmin(np.abs(num - x)))
            continue
        forward = method in ('pad', 'ffill')
        cand = np.nonzero(num <= x if forward else num >= x)[0]
        if not len(cand):
            raise KeyError('no label %s %r in coordinate'
                           % ('at or before' if forward else 'at or after',
                              lab))
        out[i] = int(cand[np.argmin(np.abs(num[cand] - x))])
    if scalar:
        return int(out[0])
    return out


def _validate_swap(mapping, coords):
    """swap_dims contract: an existing replacement coordinate must be
    1-d along the dimension it replaces."""
    for old, new in mapping.items():
        if new in coords and coords[new].dims != (old,):
            raise ValueError(
                'replacement dimension %r must be a 1-d variable along %r, '
                'not dims %r' % (new, old, coords[new].dims))


def _mask_missing(var, d, missing, fill_value):
    """``var`` with the ``missing`` positions along dim ``d`` set to the
    fill (integers promoted to float64 for NaN, NaT for datetimes)."""
    fill = _fill_for(fill_value, var.data)
    data = _promote_for(fill, var.data)
    mshape = [1] * var.ndim
    mshape[var.dims.index(d)] = len(missing)
    return Variable(var.dims, _where_any(~missing.reshape(mshape), data,
                                         fill), var.attrs)


def _pad_coord(cv, widths, like):
    """A padded coordinate: NaN for numbers, NaT for datetimes."""
    vals = cv.values
    if vals.dtype.kind in 'mM':
        padded = np.pad(vals, widths, mode='constant')
        fill = np.asarray('NaT', dtype=vals.dtype)
        for ax, (lo, hi) in enumerate(widths):
            key = [slice(None)] * vals.ndim
            if lo:
                key[ax] = slice(0, lo)
                padded[tuple(key)] = fill
            if hi:
                key[ax] = slice(-hi, None)
                padded[tuple(key)] = fill
    else:
        if vals.dtype.kind not in 'fc':
            vals = vals.astype(np.float64)
        padded = np.pad(vals, widths, mode='constant',
                        constant_values=np.nan)
    return _var(cv.dims, padded, cv.attrs, like)


def _reindex_positions(coord_var, new_labels, method=None):
    """(positions, missing mask, labels) of new labels against a 1-d
    coordinate; missing positions point at 0 and are masked by the
    caller."""
    values = coord_var.values
    labels = to_numpy(new_labels.values if hasattr(new_labels, 'variable')
                      else new_labels)
    if labels.dtype != values.dtype and values.dtype.kind == 'M':
        labels = labels.astype(values.dtype)
    idx = np.zeros(len(labels), dtype=np.int64)
    missing = np.zeros(len(labels), dtype=bool)
    for i, lab in enumerate(labels):
        m = np.nonzero(values == lab)[0]
        if len(m):
            idx[i] = m[0]
        elif method == 'nearest':
            diffs = np.abs(_as_float_index(values)
                           - float(_as_float_index(
                               np.asarray(lab, dtype=values.dtype))))
            idx[i] = int(np.argmin(diffs))
        elif method is None:
            missing[i] = True
        else:
            raise NotImplementedError('reindex method %r not supported'
                                      % method)
    return idx, missing, labels


def _array_equiv(a, b):
    """Elementwise equality with NaN == NaN."""
    a, b = to_numpy(a), to_numpy(b)
    if a.shape != b.shape:
        return False
    if a.dtype.kind in 'fc' and b.dtype.kind in 'fc':
        return bool(np.array_equal(a, b, equal_nan=True))
    if a.dtype.kind in 'mM' or b.dtype.kind in 'mM':
        return bool(np.array_equal(a.astype('int64'), b.astype('int64')))
    return bool(np.array_equal(a, b))


def _coords_equiv(a, b):
    if set(a) != set(b):
        return False
    return all(a[k].dims == b[k].dims and _array_equiv(a[k].values,
                                                       b[k].values)
               for k in a)


def _union_align(a, b):
    """Reindex two objects onto the union of their 1-d dimension
    coordinate labels (NaN where one side has no data); unions of two
    descending axes stay descending."""
    indexers = {}
    for d in set(a.sizes) & set(b.sizes):
        ca, cb = a._coords.get(d), b._coords.get(d)
        if ca is None or cb is None or ca.ndim != 1 or cb.ndim != 1:
            continue
        va, vb = ca.values, cb.values
        if va.shape == vb.shape and (va == vb).all():
            continue
        union = np.union1d(va, vb)
        if len(va) > 1 and va[0] > va[-1] and len(vb) > 1 \
                and vb[0] > vb[-1]:
            union = union[::-1]
        indexers[d] = union
    if indexers:
        a = a.reindex(indexers)
        b = b.reindex(indexers)
    return a, b


def _pad_data(data, widths, mode, cval):
    """numpy.pad's modes on a tensor (index-mapped on its device) or an
    array."""
    if not isinstance(data, torch.Tensor):
        kw = {'constant_values': cval} if mode == 'constant' else {}
        return np.pad(data, widths, mode=mode, **kw)
    from ..ops.conv import pad_reflect
    scipy_mode = {'constant': 'constant', 'edge': 'nearest',
                  'reflect': 'mirror', 'symmetric': 'reflect',
                  'wrap': 'wrap'}.get(mode)
    if scipy_mode is None:
        raise ValueError('pad mode %r is not supported' % (mode,))
    if mode == 'constant' and data.ndim and any(lo or hi
                                                for lo, hi in widths):
        out = data
        for ax, (lo, hi) in enumerate(widths):
            shape = list(out.shape)
            parts = []
            if lo:
                shape[ax] = lo
                parts.append(_full(shape, cval, out))
            parts.append(out)
            if hi:
                shape[ax] = hi
                parts.append(_full(shape, cval, out))
            out = _cat(parts, ax)
        return out
    return pad_reflect(data, widths, scipy_mode, cval)


def _reduced_coords(coords, dims):
    return {k: v for k, v in coords.items() if set(v.dims).issubset(dims)}


def _where(cond, a, other):
    """``torch.where`` with numpy's promotion for a float ``other``
    against integer or bool data (to float64)."""
    if isinstance(other, float) and not (a.is_floating_point()
                                         or a.is_complex()):
        a = a.to(torch.float64)
    if cond.dtype != torch.bool:
        cond = cond != 0          # truthiness, as np.where reads it
    return torch.where(cond, a, other)


def _round(x, decimals):
    """numpy's ``round``: integers unchanged (to the ``10**-decimals``
    multiple, half to even, for negative ``decimals``), bool as float16,
    complex part by part."""
    if x.dtype == torch.bool:
        x = x.to(torch.float16)
    if x.is_complex():
        return torch.complex(_round(x.real, decimals),
                             _round(x.imag, decimals))
    if x.is_floating_point():
        return torch.round(x, decimals=decimals)
    if decimals >= 0:
        return x.clone()
    step = 10.0 ** -decimals
    return (torch.round(x.to(torch.float64) / step) * step).to(x.dtype)


def _clip(x, lo, hi):
    """numpy's ``clip``: the result dtype is numpy's of ``x`` and the
    bounds; a complex value with a NaN part is kept, the others are
    clipped in numpy's order of complex numbers."""
    lo, hi = (None if v is None else _operand(v, x) for v in (lo, hi))
    for bound in (lo, hi):
        if bound is not None:
            x, _ = promote(x, bound)
    if not x.is_complex():
        return torch.clamp(x, lo, hi)
    keep = torch.isnan(x)
    for bound, low in ((lo, True), (hi, False)):
        if bound is not None:
            b = torch.as_tensor(bound, dtype=x.dtype, device=x.device)
            out = less(x, b) if low else less(b, x)
            x = torch.where(out & ~keep, b, x)
    return x


class _NDOpsMixin:
    """Arithmetic and comparison operators, elementwise (like xarray)."""

    def _apply_binary(self, other, op, reflexive=False):
        raise NotImplementedError

    def __add__(self, o):
        return self._apply_binary(o, add)

    def __radd__(self, o):
        return self._apply_binary(o, add, True)

    def __sub__(self, o):
        return self._apply_binary(o, sub)

    def __rsub__(self, o):
        return self._apply_binary(o, sub, True)

    def __mul__(self, o):
        return self._apply_binary(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._apply_binary(o, lambda a, b: a * b, True)

    def __truediv__(self, o):
        return self._apply_binary(o, truediv)

    def __rtruediv__(self, o):
        return self._apply_binary(o, truediv, True)

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
        return self._apply_binary(o, less)

    def __le__(self, o):
        return self._apply_binary(o, less_equal)

    def __gt__(self, o):
        return self._apply_binary(o, lambda a, b: less(b, a))

    def __ge__(self, o):
        return self._apply_binary(o, lambda a, b: less_equal(b, a))

    def __eq__(self, o):  # elementwise, like xarray
        return self._apply_binary(o, lambda a, b: a == b)

    def __ne__(self, o):
        return self._apply_binary(o, lambda a, b: a != b)

    __hash__ = None


class _LocIndexer:
    """``obj.loc[...]``: label selection (``sel``) by position of the
    dims, or by a dict."""

    def __init__(self, obj):
        self._obj = obj

    def __getitem__(self, key):
        if isinstance(key, dict):
            return self._obj.sel(key)
        if not isinstance(key, tuple):
            key = (key,)
        dims = list(self._obj.dims) if isinstance(self._obj, DataArray) \
            else list(self._obj.sizes)
        return self._obj.sel({d: k for d, k in zip(dims, key)
                              if not (isinstance(k, slice) and k == slice(
                                  None))})


class DataArray(_NDOpsMixin):
    """A labelled n-dimensional tensor with coordinates and attributes.

    Numeric non-tensor ``data`` and coordinates land on ``device``
    (default ``cuda``); a tensor stays on its device.
    """

    def __init__(self, data, coords=None, dims=None, attrs=None, name=None,
                 device=None):
        if isinstance(data, DataArray):
            dims = data.dims if dims is None else dims
            coords = dict(data._coords) if coords is None else coords
            attrs = dict(data.attrs) if attrs is None else attrs
            name = data.name if name is None else name
            data = data.data
        if isinstance(data, Variable):
            dims = data.dims if dims is None else dims
            attrs = dict(data.attrs) if attrs is None else attrs
            data = data.data
        data = as_array(data, device)
        if dims is None:
            dims = tuple('dim_%d' % i for i in range(data.ndim))
        if isinstance(dims, str):
            dims = (dims,)
        self.variable = Variable(tuple(dims), data, device=device)
        self._coords = {}
        self.attrs = dict(attrs) if attrs else {}
        self.name = name
        if coords is not None and not isinstance(coords, dict):
            coords = dict(zip(self.dims, coords))
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
        if device is None and not isinstance(value, (Variable, DataArray)):
            device = _device_of(self)
        var = _coerce_coord(key, value, device)
        _check_sizes(self.sizes, var, 'coordinate %r' % key)
        self._coords[key] = var

    def _coord_dataarray(self, key):
        var = self._coords[key]
        sub = _reduced_coords(self._coords, set(var.dims))
        return DataArray._from_parts(var, sub, var.attrs, key)

    # -- properties -------------------------------------------------------------
    @property
    def data(self):
        return self.variable.data

    @data.setter
    def data(self, value):
        value = as_array(value, _device_of(self))
        if tuple(value.shape) != self.shape:
            raise ValueError('shape mismatch')
        self.variable = Variable(self.dims, value, self.variable.attrs)

    @property
    def values(self):
        return self.variable.values

    @values.setter
    def values(self, value):
        self.data = np.asarray(value)

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
    def size(self):
        return self.variable.size

    @property
    def nbytes(self):
        return self.variable.nbytes

    @property
    def dtype(self):
        return self.variable.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def coords(self):
        return _CoordsView(self)

    @property
    def real(self):
        return self._replace(self.data.real)

    @property
    def imag(self):
        return self._replace(self.data.imag)

    @property
    def chunks(self):
        return None

    @property
    def loc(self):
        return _LocIndexer(self)

    @property
    def T(self):
        return self.transpose()

    def item(self):
        return self.values.item()

    def __bool__(self):
        return bool(self.values)

    def __float__(self):
        return float(self.values)

    def __int__(self):
        return int(self.values)

    def __complex__(self):
        return complex(self.values)

    def __len__(self):
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        v = self.values
        return v.astype(dtype) if dtype is not None else v

    def _replace(self, data, dims=None, coords=None, name=None):
        dims = self.dims if dims is None else dims
        coords = self._coords if coords is None else coords
        return DataArray._from_parts(
            Variable(dims, data), _reduced_coords(coords, set(dims)),
            self.attrs, self.name if name is None else name)

    # -- mapping access ---------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return self._coord_dataarray(key)
        if isinstance(key, dict):
            return self.isel(key)
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) > self.ndim:
            raise IndexError('too many indices: %d for %d dims'
                             % (len(key), self.ndim))
        return self.isel(dict(zip(self.dims, key)))

    def __setitem__(self, key, value):
        if isinstance(key, str):
            self._set_coord(key, value)
            return
        raise TypeError('positional assignment not supported')

    def __delitem__(self, key):
        del self._coords[key]

    def __contains__(self, key):
        return key in self._coords

    def get(self, key, default=None):
        return self._coord_dataarray(key) if key in self._coords \
            else default

    # -- structure ----------------------------------------------------------------
    def copy(self, deep=True):
        return DataArray._from_parts(
            self.variable.copy(deep),
            {k: v.copy(deep) for k, v in self._coords.items()},
            dict(self.attrs), self.name)

    def isel(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        for d in indexers:
            if d not in self.dims:
                raise ValueError('dimension %r not in %r' % (d, self.dims))
        var = self.variable.isel(indexers)
        coords = {}
        for k, v in self._coords.items():
            sub = {d: i for d, i in indexers.items() if d in v.dims}
            coords[k] = v.isel(sub) if sub else v
        return DataArray._from_parts(var, coords, self.attrs, self.name)

    def sel(self, indexers=None, method=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        isel_kw = {}
        for d, label in indexers.items():
            if d not in self._coords:
                raise KeyError('no coordinate for dimension %r' % d)
            isel_kw[d] = _sel_to_isel(self._coords[d], label, method)
        return self.isel(isel_kw)

    def head(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        return self.isel({d: slice(0, int(n)) for d, n in indexers.items()})

    def tail(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        return self.isel({d: slice(-int(n), None)
                          for d, n in indexers.items()})

    def thin(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        return self.isel({d: slice(None, None, int(n))
                          for d, n in indexers.items()})

    def drop_isel(self, indexers=None, **kwargs):
        """Drop positions along dimensions (the complement of isel)."""
        return _drop_isel(self, _normalize_indexers(indexers, kwargs))

    def drop_sel(self, indexers=None, **kwargs):
        """Drop coordinate labels along dimensions."""
        return _drop_sel(self, _normalize_indexers(indexers, kwargs))

    def drop_vars(self, names):
        """Drop coordinates (a DataArray has no other variables)."""
        out = self.copy(deep=False)
        for n in [names] if isinstance(names, str) else names:
            out._coords.pop(n, None)
        return out

    drop = drop_vars

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
        """A new axis ``dim`` of size 1 at ``axis``; a dict maps new dims
        to sizes or to coordinate values (the first key outermost)."""
        if isinstance(dim, dict):
            out = self
            for d, val in reversed(list(dim.items())):
                out = out.expand_dims(d, axis)
                n = int(val) if np.isscalar(val) else len(val)
                if n != 1:
                    shape = list(out.shape)
                    shape[axis] = n
                    data = out.data.expand(*shape) \
                        if isinstance(out.data, torch.Tensor) \
                        else np.broadcast_to(out.data, shape)
                    out = out._replace(data)
                if not np.isscalar(val):
                    out._coords[d] = _var((d,), to_numpy(val), None, self)
            return out
        var = self.variable.expand_dims(dim, axis)
        coords = dict(self._coords)
        if dim in coords and coords[dim].ndim == 0:
            coords[dim] = coords[dim].expand_dims(dim)
        return DataArray._from_parts(var, coords, self.attrs, self.name)

    def rename(self, mapping=None, **kwargs):
        if isinstance(mapping, str):
            out = self.copy(deep=False)
            out.name = mapping
            return out
        mapping = _normalize_indexers(mapping, kwargs)
        var = self.variable.rename_dims(mapping)
        coords = {mapping.get(k, k): v.rename_dims(mapping)
                  for k, v in self._coords.items()}
        return DataArray._from_parts(var, coords, self.attrs,
                                     mapping.get(self.name, self.name))

    def swap_dims(self, mapping=None, **kwargs):
        mapping = _normalize_indexers(mapping, kwargs)
        _validate_swap(mapping, self._coords)
        return DataArray._from_parts(
            self.variable.rename_dims(mapping),
            {k: v.rename_dims(mapping) for k, v in self._coords.items()},
            self.attrs, self.name)

    def astype(self, dtype):
        if isinstance(self.data, torch.Tensor):
            return self._replace(self.data.to(torch_dtype(dtype)))
        return self._replace(self.data.astype(dtype))

    def assign_coords(self, coords=None, **kwargs):
        out = self.copy(deep=False)
        for k, v in {**(coords or {}), **kwargs}.items():
            out._set_coord(k, v)
        return out

    def assign_attrs(self, *args, **kwargs):
        out = self.copy(deep=False)
        out.attrs.update(dict(*args, **kwargs))
        return out

    def reset_coords(self, names=None, drop=False):
        """Demote non-index coordinates: ``drop=True`` removes them,
        otherwise they become data variables of a Dataset."""
        if names is None:
            names = [k for k in self._coords if k not in self.dims]
        elif isinstance(names, str):
            names = [names]
        for k in names:
            if k in self.dims:
                raise ValueError('cannot reset index coordinate %r' % k)
        if drop:
            out = self.copy(deep=False)
            for k in names:
                out._coords.pop(k, None)
            return out
        if self.name is None:
            raise ValueError('cannot convert an unnamed DataArray to a '
                             'Dataset: pass name first')
        ds = Dataset({self.name: self})
        for k in names:
            if k in ds._coords:
                ds._variables[k] = ds._coords.pop(k)
        return ds

    def to_dataset(self, name=None, dim=None):
        if dim is not None:
            return expand_variables_da(self, dim)
        name = name or self.name
        if name is None:
            raise ValueError('cannot convert unnamed DataArray to Dataset')
        ds = Dataset(attrs=self.attrs)
        ds._coords.update(self._coords)
        ds[name] = self
        return ds

    def stack(self, **kwargs):
        """Stack several dims into one new dim (one per call)."""
        (new_dim, dims), = kwargs.items()
        dims = tuple(dims)
        other = tuple(d for d in self.dims if d not in dims)
        var = self.variable.transpose(*(other + dims))
        size = int(np.prod([self.sizes[d] for d in dims], dtype=np.int64))
        data = var.data.reshape(var.shape[:len(other)] + (size,))
        coords = {k: v for k, v in self._coords.items()
                  if not set(v.dims) & set(dims)}
        out = DataArray._from_parts(Variable(other + (new_dim,), data),
                                    coords, self.attrs, self.name)
        out.attrs[_STACK_ATTR] = {
            'dim': new_dim, 'dims': dims,
            'shape': tuple(self.sizes[d] for d in dims),
            'coords': {k: v for k, v in self._coords.items()
                       if set(v.dims) & set(dims)}}
        return out

    def unstack(self, dim=None):
        info = self.attrs.get(_STACK_ATTR)
        if info is None:
            raise ValueError('DataArray was not stacked by nd_tpu_torch')
        new_dim, dims, shape = info['dim'], info['dims'], info['shape']
        other = tuple(d for d in self.dims if d != new_dim)
        var = self.variable.transpose(*(other + (new_dim,)))
        data = var.data.reshape(var.shape[:-1] + tuple(shape))
        coords = {k: v for k, v in self._coords.items() if k != new_dim}
        coords.update(info['coords'])
        attrs = {k: v for k, v in self.attrs.items() if k != _STACK_ATTR}
        return DataArray._from_parts(Variable(other + tuple(dims), data),
                                     coords, attrs, self.name)

    def broadcast_like(self, other):
        """Self broadcast against ``other``'s dimensions, with ``other``'s
        coordinates on the new dims."""
        bc = broadcast(self, other)[0]
        for ck, cv in other._coords.items():
            if ck not in bc._coords and set(cv.dims).issubset(set(bc.dims)):
                bc._coords[ck] = cv
        return bc

    def combine_first(self, other):
        """Self's values where valid, else ``other``'s, on the union of
        both 1-d dimension coordinates (NaN elsewhere)."""
        a, b = _union_align(self, other)
        a, b = broadcast(a, b)
        return a.where(a.notnull(), b)

    # -- elementwise ----------------------------------------------------------------
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

    def fillna(self, value):
        if _kind(self.data) not in 'fc':      # nothing can be missing
            return self.copy(deep=False)
        return self.where(self.notnull(), value)

    def isnull(self):
        data = self.data
        if not isinstance(data, torch.Tensor):
            null = np.isnat(data) if data.dtype.kind in 'mM' \
                else np.zeros(data.shape, bool)
            return self._replace(torch.from_numpy(null))
        if data.is_floating_point() or data.is_complex():
            return self._replace(torch.isnan(data))
        return self._replace(torch.zeros_like(data, dtype=torch.bool))

    def notnull(self):
        out = self.isnull()
        return out._replace(torch.logical_not(out.data))

    def clip(self, min=None, max=None):
        return self._replace(_clip(self.data, min, max))

    def round(self, decimals=0):
        return self._replace(_round(self.data, decimals))

    def conj(self):
        return self._replace(torch.conj(self.data).resolve_conj())

    conjugate = conj

    def isin(self, test_elements):
        """Elementwise membership mask."""
        if isinstance(test_elements, DataArray):
            test_elements = test_elements.values
        test = torch.as_tensor(np.asarray(test_elements).ravel(),
                               device=self.data.device)
        return self._replace(torch.isin(self.data, test))

    def argsort(self, axis=-1):
        return self._replace(torch.argsort(self.data, dim=axis,
                                           stable=True))

    # -- arithmetic -------------------------------------------------------------------
    def _apply_binary(self, other, op, reflexive=False):
        if isinstance(other, Dataset):
            return NotImplemented
        if isinstance(other, DataArray):
            var = self.variable._binary_op(other.variable, op, reflexive)
            coords = dict(other._coords)
            coords.update(self._coords)
            name = self.name if self.name == other.name else None
            return DataArray._from_parts(
                var, _reduced_coords(coords, set(var.dims)), {}, name)
        var = self.variable._binary_op(other, op, reflexive)
        return DataArray._from_parts(var, self._coords, {}, self.name)

    def __neg__(self):
        return self._replace(-self.data)

    def __abs__(self):
        return self._replace(torch.abs(self.data))

    def __invert__(self):
        return self._replace(torch.logical_not(self.data))

    # -- reductions ---------------------------------------------------------------------
    def reduce(self, func, dim=None, **kwargs):
        """Reduce with ``func(data, axis=...)`` over the named dims (all
        of them for ``None``), as numpy's reducers take it; ``axis`` is
        None, an int or a tuple of ints."""
        return self._reduced(self.variable.reduce(func, dim, **kwargs))

    def _reduce(self, func, dim=None, **kwargs):
        """The port's own reducers: ``func(data, dim=...)``."""
        return self._reduced(self.variable._reduce(func, dim, **kwargs))

    def _reduced(self, var):
        return DataArray._from_parts(
            var, _reduced_coords(self._coords, set(var.dims)), self.attrs,
            self.name)

    def mean(self, dim=None, **kw):
        return self._reduce(nanops.nanmean, dim, **kw)

    def std(self, dim=None, **kw):
        return self._reduce(nanops.nanstd, dim, **kw)

    def var(self, dim=None, **kw):
        return self._reduce(nanops.nanvar, dim, **kw)

    def min(self, dim=None, **kw):
        return self._reduce(nanops.nanmin, dim, **kw)

    def max(self, dim=None, **kw):
        return self._reduce(nanops.nanmax, dim, **kw)

    def sum(self, dim=None, **kw):
        return self._reduce(nanops.nansum, dim, **kw)

    def median(self, dim=None, **kw):
        return self._reduce(nanops.nanmedian, dim, **kw)

    def prod(self, dim=None, **kw):
        return self._reduce(nanops.nanprod, dim, **kw)

    def all(self, dim=None, **kw):
        return self._reduce(nanops.all_, dim, **kw)

    def any(self, dim=None, **kw):
        return self._reduce(nanops.any_, dim, **kw)

    def count(self, dim=None, **kw):
        return self.notnull().astype(torch.int64)._reduce(torch.sum, dim,
                                                            **kw)

    def argmin(self, dim=None, **kw):
        return self._reduce(nanops.nanargmin, dim, **kw)

    def argmax(self, dim=None, **kw):
        return self._reduce(nanops.nanargmax, dim, **kw)

    def quantile(self, q, dim=None, method='linear', **kw):
        """numpy's nanquantile with ``method`` one of
        ``nanops.QUANTILE_METHODS``; a 1-d ``q`` gives a new leading
        ``quantile`` dim with its coordinate."""
        q_arr = np.asarray(q, np.float64)
        if q_arr.ndim == 0:
            return self._reduce(
                lambda x, dim: nanops.nanquantile(x, float(q_arr), dim,
                                                  method),
                dim, **kw)
        red = self.dims if dim is None else \
            ((dim,) if isinstance(dim, str) else tuple(dim))
        axes = tuple(self.dims.index(d) for d in red)
        data = nanops.nanquantile(self.data, q_arr, axes, method)
        out_dims = ('quantile',) + tuple(d for d in self.dims
                                         if d not in red)
        coords = _reduced_coords(self._coords, set(out_dims))
        coords['quantile'] = _var(('quantile',), q_arr, None, self)
        return DataArray._from_parts(Variable(out_dims, data), coords,
                                     self.attrs, self.name)

    def idxmin(self, dim):
        return self._idx_reduce(dim, 'argmin')

    def idxmax(self, dim):
        return self._idx_reduce(dim, 'argmax')

    def _idx_reduce(self, dim, which):
        if dim not in self._coords:
            raise KeyError('no coordinate for dimension %r' % dim)
        idx = getattr(self, which)(dim=dim)
        labels = self._coords[dim].values[np.asarray(idx.values)]
        return DataArray._from_parts(_var(idx.dims, labels, None, self),
                                     dict(idx._coords), self.attrs,
                                     self.name)

    # -- accumulations, shifts, padding -------------------------------------------
    def _accumulate(self, fn, dim=None):
        dims = self.dims if dim is None else \
            ((dim,) if isinstance(dim, str) else tuple(dim))
        data = self.data
        for d in dims:
            data = fn(data, self.dims.index(d))
        return self._replace(data)

    def cumsum(self, dim=None, **kw):
        return self._accumulate(nanops.nancumsum, dim)

    def cumprod(self, dim=None, **kw):
        return self._accumulate(nanops.nancumprod, dim)

    def diff(self, dim, n=1, label='upper'):
        out = self
        for _ in range(n):
            upper = out.isel({dim: slice(1, None)})
            lower = out.variable.isel({dim: slice(None, -1)})
            base = upper if label == 'upper' \
                else out.isel({dim: slice(None, -1)})
            out = base._replace(sub(upper.data, lower.data))
        return out

    def shift(self, shifts=None, fill_value=np.nan, **kwargs):
        shifts = _normalize_indexers(shifts, kwargs)
        fill = _fill_for(fill_value, self.data)
        data = _promote_for(fill, self.data)
        for d, k in shifts.items():
            k = int(k)
            if k == 0:
                continue
            ax = self.dims.index(d)
            n = self.shape[ax]
            shape = list(data.shape)
            shape[ax] = min(abs(k), n)
            pad = _full(shape, fill, data)
            key = [slice(None)] * self.ndim
            if k > 0:
                key[ax] = slice(0, max(n - k, 0))
                data = _cat([pad, data[tuple(key)]], ax)
            else:
                key[ax] = slice(min(-k, n), None)
                data = _cat([data[tuple(key)], pad], ax)
        return self._replace(data)

    def roll(self, shifts=None, roll_coords=False, **kwargs):
        shifts = _normalize_indexers(shifts, kwargs)
        data = self.data
        for d, k in shifts.items():
            ax = self.dims.index(d)
            data = torch.roll(data, int(k), ax) \
                if isinstance(data, torch.Tensor) \
                else np.roll(data, int(k), axis=ax)
        out = self._replace(data)
        if roll_coords:
            for ck, cv in list(out._coords.items()):
                out._coords[ck] = _roll_coord(cv, shifts)
        return out

    def pad(self, pad_width=None, mode='constant', constant_values=np.nan,
            **kwargs):
        pad_width = _normalize_indexers(pad_width, kwargs)
        norm = {d: ((w, w) if np.isscalar(w) else tuple(w))
                for d, w in pad_width.items()}
        widths = [norm.get(d, (0, 0)) for d in self.dims]
        data = self.data
        if mode == 'constant':
            constant_values = _fill_for(constant_values, data)
            data = _promote_for(constant_values, data)
        data = _pad_data(data, widths, mode, constant_values)
        coords = {}
        for ck, cv in self._coords.items():
            cw = [norm.get(d, (0, 0)) for d in cv.dims]
            coords[ck] = _pad_coord(cv, cw, self) \
                if any(a or b for a, b in cw) else cv
        return DataArray._from_parts(Variable(self.dims, data), coords,
                                     self.attrs, self.name)

    # -- reordering and realignment ----------------------------------------------------
    def sortby(self, variables, ascending=True):
        return _sortby(self, variables, ascending)

    def reindex(self, indexers=None, method=None, fill_value=np.nan,
                **kwargs):
        return _reindex(self, _normalize_indexers(indexers, kwargs), method,
                        fill_value)

    def reindex_like(self, other, method=None, fill_value=np.nan):
        indexers = {d: other._coords[d].values for d in self.dims
                    if d in other._coords and d in self._coords}
        return self.reindex(indexers, method=method, fill_value=fill_value)

    def dropna(self, dim, how='any', thresh=None):
        other = tuple(d for d in self.dims if d != dim)
        counts = np.asarray(self.notnull().sum(dim=other).values
                            if other else self.notnull().values)
        total = int(np.prod([self.sizes[d] for d in other],
                            dtype=np.int64)) if other else 1
        return self.isel({dim: _keep(counts, total, how, thresh)})

    # -- grouped and windowed --------------------------------------------------------------
    def groupby(self, group):
        from .grouped import GroupBy
        return GroupBy.from_group(self, group)

    def resample(self, indexer=None, **kwargs):
        from .grouped import Resample
        (dim, freq), = _normalize_indexers(indexer, kwargs).items()
        return Resample.from_freq(self, dim, freq)

    def rolling(self, dim=None, min_periods=None, center=False,
                **window_kwargs):
        from .grouped import Rolling
        (d, w), = _normalize_indexers(dim if isinstance(dim, dict) else None,
                                      window_kwargs).items()
        return Rolling(self, d, w, min_periods=min_periods, center=center)

    def coarsen(self, dim=None, boundary='exact', side='left',
                coord_func='mean', **window_kwargs):
        from .grouped import Coarsen
        windows = _normalize_indexers(dim if isinstance(dim, dict) else None,
                                      window_kwargs)
        return Coarsen(self, windows, boundary=boundary, side=side,
                       coord_func=coord_func)

    def weighted(self, weights):
        from .grouped import Weighted
        return Weighted(self, weights)

    @property
    def dt(self):
        """Calendar fields of a datetime array (``da.dt.month`` etc.)."""
        from .grouped import DatetimeAccessor
        return DatetimeAccessor(self)

    # -- gap filling -------------------------------------------------------------------------
    def ffill(self, dim, limit=None):
        """Propagate the last valid value forward along ``dim`` (at most
        ``limit`` steps past it)."""
        return self._fill_directional(dim, limit, forward=True)

    def bfill(self, dim, limit=None):
        """Propagate the next valid value backward along ``dim``."""
        return self._fill_directional(dim, limit, forward=False)

    def _fill_directional(self, dim, limit, forward):
        kind = _kind(self.data)
        if kind in 'iub':           # no NaN representable: nothing to fill
            return self.copy(deep=False)
        if limit is not None and int(limit) < 1:
            raise ValueError('limit must be >= 1')
        axis = self.dims.index(dim)
        n = self.shape[axis]
        dt_dtype = None
        if kind in 'mM':            # NaT fills run on the host (int64)
            dt_dtype = self.values.dtype
            data = self.values.astype('int64')
            nanmask = np.isnat(self.values)
        else:
            data = self.data
            nanmask = torch.isnan(data)
        if not forward:
            data, nanmask = _flip(data, axis), _flip(nanmask, axis)
        pos, (val,) = _propagate_last_valid(~nanmask, (data,), axis)
        filled = _where_any(pos >= 0, val, data)
        if limit is not None:
            shape = [1] * self.ndim
            shape[axis] = n
            ar = _arange(n, shape, data)
            filled = _where_any(ar - pos <= int(limit), filled, data)
        if not forward:
            filled = _flip(filled, axis)
        if dt_dtype is not None:
            filled = filled.astype(dt_dtype)
        return self._replace(filled)

    def interpolate_na(self, dim=None, method='linear', limit=None,
                       use_coordinate=True, max_gap=None):
        """Fill interior NaN runs along ``dim`` from the nearest valid
        neighbours: 'linear' in the dim's coordinate values (or position,
        ``use_coordinate=False``) or 'nearest'. Leading and trailing NaNs
        stay; ``limit`` caps the fill distance (steps past the previous
        valid point), ``max_gap`` skips gaps wider than that many
        coordinate units (a timedelta for datetime coordinates)."""
        if method not in ('linear', 'nearest'):
            raise ValueError("method must be 'linear' or 'nearest'")
        if dim is None:
            raise ValueError('interpolate_na requires a dim')
        kind = _kind(self.data)
        if kind in 'iub':
            return self.copy(deep=False)
        if limit is not None and int(limit) < 1:
            raise ValueError('limit must be >= 1')
        axis = self.dims.index(dim)
        n = self.shape[axis]
        if use_coordinate and dim in self._coords \
                and self._coords[dim].ndim == 1:
            x = _as_float_index(self._coords[dim].values)
        else:
            x = np.arange(n, dtype=np.float64)
        is_dt = kind in 'mM'
        if is_dt:
            ints = self.values.astype('int64')
            nanmask = np.isnat(self.values)
            data = np.where(nanmask, np.nan, ints.astype('float64'))
            xarr = x
        else:
            data = self.data
            nanmask = torch.isnan(data)
            xarr = torch.as_tensor(x, device=data.device)
        valid = ~nanmask
        shape = [1] * self.ndim
        shape[axis] = n
        ar = _arange(n, shape, data)
        xcol = xarr.reshape(shape)
        xfull = xcol.expand(*data.shape) if isinstance(xcol, torch.Tensor) \
            else np.broadcast_to(xcol, data.shape)
        payloads = (data, xfull) + ((ints,) if is_dt else ())
        prev, fwd = _propagate_last_valid(valid, payloads, axis)
        vp, x_p = fwd[0], fwd[1]
        nxt_f, bwd = _propagate_last_valid(
            _flip(valid, axis), tuple(_flip(a, axis) for a in payloads),
            axis)
        nxt_pos = _flip(nxt_f, axis)
        nxt = _where_any(nxt_pos >= 0, (n - 1) - nxt_pos, np.int32(n))
        vn, x_n = _flip(bwd[0], axis), _flip(bwd[1], axis)
        denom = x_n - x_p
        w = (xcol - x_p) / _where_any(denom != 0, denom, 1.0)
        can = _logical_and(~valid, prev >= 0, nxt <= n - 1)
        if limit is not None:
            can = _logical_and(can, ar - prev <= int(limit))
        if max_gap is not None:
            gap = max_gap
            if np.asarray(gap).dtype.kind == 'm':
                gap = float(np.asarray(gap).astype('timedelta64[ns]')
                            .astype('int64'))
            can = _logical_and(can, abs(denom) <= float(gap))
        if is_dt:
            # exact int64 assembly: epoch counts exceed float64's integer
            # range, so values interpolate as base + round(delta * w)
            vp_i, vn_i = fwd[2], _flip(bwd[2], axis)
            wb = np.broadcast_to(w, ints.shape)
            if method == 'nearest':
                fill_i = np.where(wb <= 0.5, vp_i, vn_i)
            else:
                fill_i = vp_i + np.round((vn_i - vp_i).astype('float64')
                                         * wb).astype('int64')
            out = np.where(can, fill_i, ints).astype(self.values.dtype)
            return self._replace(out)
        if method == 'nearest':
            fill = torch.where(w <= 0.5, vp, vn)
        else:
            # float32 cubes stay float32: the float64 weights would
            # promote the whole payload
            wc = w.to(data.dtype) if data.is_floating_point() else w
            fill = vp + (vn - vp) * wc
        return self._replace(torch.where(can, fill, data))

    # -- regridding --------------------------------------------------------------------------
    def interp(self, coords=None, method='linear', assume_sorted=False,
               **coords_kwargs):
        """Interpolate onto new coordinate values, dim by dim ('linear'
        or 'nearest'); targets outside the source range come back NaN.
        DataArray indexers on other dims interpolate pointwise (a
        transect)."""
        del assume_sorted        # sortedness is detected, not assumed
        indexers = _normalize_indexers(coords, coords_kwargs)
        adv = {d: t for d, t in indexers.items()
               if isinstance(t, DataArray) and t.ndim >= 1
               and t.dims != (d,)}
        if adv:
            if set(adv) != set(indexers):
                rest = {d: t for d, t in indexers.items() if d not in adv}
                return self.interp(rest, method=method).interp(
                    adv, method=method)
            return self._interp_pointwise(adv, method)
        out = self
        for d, t in indexers.items():
            out = out._interp_dim(d, t, method)
        return out

    def interp_like(self, other, method='linear'):
        """Interpolate onto ``other``'s 1-d coordinates (shared dims)."""
        indexers = {d: other._coords[d].values for d in self.dims
                    if d in other._coords and other._coords[d].ndim == 1
                    and d in self._coords}
        return self.interp(indexers, method=method)

    def _interp_pointwise(self, indexers, method):
        """Every indexer is a DataArray on one shared set of new dims; the
        result samples the field at each joint position."""
        if method not in ('linear', 'nearest'):
            raise ValueError("method must be 'linear' or 'nearest'")
        dims_new = None
        for d, t in indexers.items():
            if dims_new is None:
                dims_new = t.dims
            elif t.dims != dims_new:
                raise ValueError('vectorized interp indexers must share one '
                                 'dim set (got %r vs %r)' % (t.dims,
                                                            dims_new))
            if d not in self.dims:
                raise ValueError('dim %r not in %r' % (d, self.dims))
            if d not in self._coords or self._coords[d].ndim != 1:
                raise ValueError('interp needs a 1-d coordinate on %r' % d)
        pshape = next(iter(indexers.values())).shape
        per_dim = {}
        oob = np.zeros(pshape, bool)
        for d, t in indexers.items():
            raw = self._coords[d].values
            tv = to_numpy(t.values)
            if raw.dtype.kind == 'M':
                tv = np.asarray(tv, dtype='datetime64[ns]')
            lo, hi, w, o = _interp_weights(_as_float_index(raw),
                                           _as_float_index(tv).ravel())
            oob |= o.reshape(pshape)
            per_dim[d] = (lo.reshape(pshape), hi.reshape(pshape),
                          w.reshape(pshape))
        data = self.data
        if _kind(data) in 'iub' and method == 'linear':
            data = data.to(torch.float64)
        keep = tuple(d for d in self.dims if d not in indexers)
        perm = [self.dims.index(d) for d in keep] \
            + [self.dims.index(d) for d in indexers]
        data_t = data.permute(*perm)
        names = list(indexers)
        dev = data.device

        def ix(a):
            return torch.as_tensor(a, device=dev)

        if method == 'nearest':
            idx = tuple(ix(np.where(per_dim[d][2] <= 0.5, per_dim[d][0],
                                    per_dim[d][1])) for d in names)
            out = data_t[(Ellipsis,) + idx]
        else:
            out = None
            for corner in itertools.product((0, 1), repeat=len(names)):
                idx = tuple(ix(per_dim[d][c]) for d, c in zip(names, corner))
                wgt = None
                for d, c in zip(names, corner):
                    w = per_dim[d][2]
                    wk = w if c else 1.0 - w
                    wgt = wk if wgt is None else wgt * wk
                wv = torch.as_tensor(wgt, device=dev)
                vals = data_t[(Ellipsis,) + idx]
                if vals.is_floating_point() or vals.is_complex():
                    wv = wv.to(vals.dtype)
                term = vals * wv
                out = term if out is None else out + term
        if oob.any():
            if _kind(out) in 'iub':
                out = out.to(torch.float64)
            out = torch.where(ix(oob), torch.full((), float('nan'),
                                                  dtype=out.dtype,
                                                  device=dev), out)
        dims_out = keep + dims_new
        coords = _reduced_coords(self._coords, set(keep))
        first = next(iter(indexers.values()))
        for ck, cv in first._coords.items():
            if set(cv.dims).issubset(set(dims_new)) and ck not in coords:
                coords[ck] = cv
        for d, t in indexers.items():
            coords[d] = _var(dims_new, to_numpy(t.values),
                             self._coords[d].attrs, self)
        return DataArray._from_parts(Variable(dims_out, out), coords,
                                     self.attrs, self.name)

    def _interp_dim(self, dim, target, method):
        if method not in ('linear', 'nearest'):
            raise ValueError("method must be 'linear' or 'nearest'")
        if dim not in self.dims:
            raise ValueError('dim %r not in %r' % (dim, self.dims))
        if dim not in self._coords or self._coords[dim].ndim != 1:
            raise ValueError('interp needs a 1-d coordinate on %r' % dim)
        raw = self._coords[dim].values
        tv_raw = to_numpy(target.values if isinstance(target, DataArray)
                          else target)
        scalar = tv_raw.ndim == 0
        if raw.dtype.kind == 'M':
            tv_raw = np.asarray(tv_raw, dtype='datetime64[ns]')
        tv = np.atleast_1d(tv_raw)
        lo, hi, w, oob = _interp_weights(_as_float_index(raw),
                                         _as_float_index(tv))
        axis = self.dims.index(dim)
        shape = [1] * self.ndim
        shape[axis] = len(tv)
        if _kind(self.data) in 'mM':
            ints = self.values.astype('int64')
            nat = np.isnat(self.values)
            vlo = np.take(ints, lo, axis=axis)
            vhi = np.take(ints, hi, axis=axis)
            bad = np.take(nat, lo, axis=axis) | np.take(nat, hi, axis=axis)
            if method == 'nearest':
                out_i = np.where(np.broadcast_to((w <= 0.5).reshape(shape),
                                                 vlo.shape), vlo, vhi)
            else:
                out_i = vlo + np.round((vhi - vlo).astype('float64')
                                       * w.reshape(shape)).astype('int64')
            bad = bad | oob.reshape(shape)
            nat_i = np.full(1, 'NaT', dtype=raw.dtype).astype('int64')
            out = np.where(bad, nat_i, out_i).astype(self.values.dtype)
        else:
            data = self.data
            dev = data.device
            if method == 'nearest':
                out = data.index_select(axis, torch.as_tensor(
                    np.where(w <= 0.5, lo, hi), device=dev))
                if oob.any():
                    if _kind(out) in 'iub':
                        out = out.to(torch.float64)
                    out = torch.where(
                        torch.as_tensor(oob.reshape(shape), device=dev),
                        torch.full((), float('nan'), dtype=out.dtype,
                                   device=dev), out)
            else:
                if _kind(data) in 'iub':
                    data = data.to(torch.float64)
                vlo = data.index_select(axis, torch.as_tensor(lo, device=dev))
                vhi = data.index_select(axis, torch.as_tensor(hi, device=dev))
                wv = torch.as_tensor(np.where(oob, np.nan, w).reshape(shape),
                                     device=dev)
                if vlo.is_floating_point() or vlo.is_complex():
                    wv = wv.to(vlo.dtype)
                out = vlo + (vhi - vlo) * wv
        coords = {}
        for ck, cv in self._coords.items():
            if dim not in cv.dims:
                coords[ck] = cv
                continue
            if ck == dim or cv.values.dtype.kind not in 'fiuMm':
                continue
            coords[ck] = _interp_coord(cv, dim, lo, hi, w, oob, scalar, self)
        if scalar:
            out = out.select(axis, 0) if isinstance(out, torch.Tensor) \
                else np.take(out, 0, axis=axis)
            dims = tuple(d for d in self.dims if d != dim)
            coords[dim] = _var((), tv_raw, self._coords[dim].attrs, self)
        else:
            dims = self.dims
            coords[dim] = _var((dim,), tv, self._coords[dim].attrs, self)
        return DataArray._from_parts(Variable(dims, out), coords, self.attrs,
                                     self.name)

    # -- comparison ---------------------------------------------------------------------------
    def equals(self, other):
        """True if dims, coordinates and values (NaN-aware) match."""
        if not isinstance(other, DataArray):
            return False
        if self.dims != other.dims or self.shape != other.shape:
            return False
        return _coords_equiv(self._coords, other._coords) \
            and _array_equiv(self.values, other.values)

    def identical(self, other):
        return self.equals(other) and self.name == other.name \
            and self.attrs == other.attrs

    def broadcast_equals(self, other):
        if not isinstance(other, DataArray):
            return False
        try:
            a, b = broadcast(self, other)
        except ValueError:
            return False
        return a.equals(b)

    # -- calculus along a coordinate ----------------------------------------------------------
    def differentiate(self, coord):
        """d(self)/d(coord) by second-order differences on the (possibly
        non-uniform) coordinate, one-sided at the edges (numpy.gradient's
        formulation)."""
        dim, xv, axis, n = self._calculus_axis(coord)
        if n < 2:
            raise ValueError('differentiate needs at least 2 points')
        data = self.data
        if _kind(data) in 'iub':
            data = data.to(torch.float64)
        dev = data.device

        def sl(lo, hi):
            return data.narrow(axis, lo, hi - lo)

        def col(v):
            shape = [1] * self.ndim
            shape[axis] = len(v)
            return torch.as_tensor(v.reshape(shape), device=dev)

        h_prev = xv[1:-1] - xv[:-2]
        h_next = xv[2:] - xv[1:-1]
        wp = -h_next / (h_prev * (h_prev + h_next))
        wc = (h_next - h_prev) / (h_prev * h_next)
        wn = h_prev / (h_next * (h_prev + h_next))
        interior = col(wp) * sl(0, n - 2) + col(wc) * sl(1, n - 1) \
            + col(wn) * sl(2, n)
        first = (sl(1, 2) - sl(0, 1)) / (xv[1] - xv[0])
        last = (sl(n - 1, n) - sl(n - 2, n - 1)) / (xv[-1] - xv[-2])
        return self._replace(torch.cat([first, interior.to(first.dtype),
                                        last], dim=axis))

    def integrate(self, coord):
        """Trapezoid-rule integral along a coordinate (reduces its
        dimension)."""
        dim, xv, axis, n = self._calculus_axis(coord)
        data = self.data
        if _kind(data) in 'iub':
            data = data.to(torch.float64)
        shape = [1] * self.ndim
        shape[axis] = n - 1
        dx = torch.as_tensor((xv[1:] - xv[:-1]).reshape(shape),
                             device=data.device)
        tot = ((data.narrow(axis, 0, n - 1) + data.narrow(axis, 1, n - 1))
               * 0.5 * dx).sum(dim=axis)
        dims = tuple(d for d in self.dims if d != dim)
        coords = {k: v for k, v in self._coords.items() if dim not in v.dims}
        return DataArray._from_parts(Variable(dims, tot), coords,
                                     self.attrs, self.name)

    def _calculus_axis(self, coord):
        if coord not in self._coords or self._coords[coord].ndim != 1:
            raise ValueError('%r must be a 1-d coordinate' % coord)
        dim = self._coords[coord].dims[0]
        if dim not in self.dims:
            raise ValueError('coordinate %r is not along a dimension of '
                             'this array' % coord)
        return (dim, _as_float_index(self._coords[coord].values),
                self.dims.index(dim), self.sizes[dim])

    # -- pandas bridge (pandas imported on call) --------------------------------------
    def to_index(self):
        import pandas as pd
        if self.ndim != 1:
            raise ValueError('to_index requires a 1-d array')
        return pd.Index(self.values, name=self.name or self.dims[0])

    def _pandas_index(self):
        import pandas as pd
        arrays = [self._coords[d].values
                  if d in self._coords and self._coords[d].dims == (d,)
                  else np.arange(self.sizes[d]) for d in self.dims]
        if len(arrays) == 1:
            return pd.Index(arrays[0], name=self.dims[0])
        return pd.MultiIndex.from_product(arrays, names=self.dims)

    def to_series(self):
        import pandas as pd
        return pd.Series(self.values.ravel(), index=self._pandas_index(),
                         name=self.name)

    def to_dataframe(self, name=None):
        name = name or self.name
        if name is None:
            raise ValueError('cannot convert an unnamed DataArray to a '
                             'DataFrame: pass name=')
        return self.to_series().rename(name).to_frame()

    def get_index(self, dim):
        import pandas as pd
        if dim not in self._coords:
            raise KeyError('no coordinate on dim %r' % dim)
        return pd.Index(self._coords[dim].values)

    # -- host copies and serialisation ------------------------------------------------
    def to_numpy(self):
        return self.values

    def as_numpy(self):
        """A copy whose payload is on the host (CPU)."""
        return self._replace(_host(self.data))

    def load(self):
        """Move the payload to the host in place (the JAX package's
        ``load`` materialises it there) and return self."""
        self.variable = Variable(self.dims, _host(self.data),
                                 self.variable.attrs)
        return self

    def persist(self):
        return self

    def compute(self):
        return self

    def chunk(self, *args, **kwargs):
        return self

    def to_dict(self, data=True):
        """The nested-dict form (xarray's serialisation schema)."""
        d = {'dims': self.dims, 'attrs': dict(self.attrs), 'name': self.name,
             'coords': {k: {'dims': v.dims,
                            'data': v.values.tolist() if data else v.shape,
                            'attrs': dict(v.attrs)}
                        for k, v in self._coords.items()}}
        d['data'] = self.values.tolist() if data else self.shape
        return d

    @classmethod
    def from_dict(cls, d, device=None):
        coords = {k: (tuple(c['dims']), np.asarray(c['data']), c.get('attrs'))
                  for k, c in d.get('coords', {}).items()}
        return cls(np.asarray(d['data']), dims=tuple(d['dims']),
                   coords=coords, attrs=d.get('attrs'), name=d.get('name'),
                   device=device)

    def __repr__(self):
        return '<nd_tpu_torch.DataArray %r %r %s>' % (
            self.name, self.sizes, self.dtype)


def _host(data):
    return data.cpu() if isinstance(data, torch.Tensor) else data


def _logical_and(*masks):
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def _keep(counts, total, how, thresh):
    """Positions dropna keeps from the valid counts per position."""
    if thresh is not None:
        keep = counts >= thresh
    elif how == 'any':
        keep = counts == total
    elif how == 'all':
        keep = counts > 0
    else:
        raise ValueError("how must be 'any' or 'all'")
    return np.nonzero(keep)[0]


def _drop_isel(obj, indexers):
    out = obj
    for d, pos in indexers.items():
        n = out.sizes[d]
        pos = np.atleast_1d(np.asarray(to_numpy(pos), dtype=np.int64))
        pos = np.where(pos < 0, pos + n, pos)
        if (pos < 0).any() or (pos >= n).any():
            raise IndexError('drop_isel positions out of bounds for dim %r '
                             'of size %d' % (d, n))
        out = out.isel({d: np.delete(np.arange(n), pos)})
    return out


def _drop_sel(obj, indexers):
    out = obj
    for d, labels in indexers.items():
        if d not in obj._coords:
            raise KeyError('no coordinate on dim %r' % d)
        cv = obj._coords[d].values
        labels = np.atleast_1d(np.asarray(labels, dtype=cv.dtype))
        pos = []
        for lab in labels:
            hits = np.nonzero(cv == lab)[0]
            if len(hits) == 0:
                raise KeyError('label %r not found in dim %r' % (lab, d))
            pos.extend(hits.tolist())
        out = _drop_isel(out, {d: pos})
    return out


def _sortby(obj, variables, ascending):
    if isinstance(variables, (str, DataArray)):
        variables = [variables]
    out = obj
    for v in variables:
        cv = out._coords[v] if isinstance(v, str) else v.variable
        if cv.ndim != 1:
            raise ValueError('sortby only supports 1-d keys')
        order = np.argsort(cv.values, kind='stable')
        if not ascending:
            order = order[::-1]
        out = out.isel({cv.dims[0]: order})
    return out


def _reindex(obj, indexers, method, fill_value):
    out = obj
    for d, new_labels in indexers.items():
        idx, missing, labels = _reindex_positions(out._coords[d], new_labels,
                                                  method)
        sub = out.isel({d: idx})
        if missing.any():
            tables = [sub._coords]
            if isinstance(sub, Dataset):
                tables.append(sub._variables)
            else:
                sub.variable = _mask_missing(sub.variable, d, missing,
                                             fill_value)
            for table in tables:
                for k in list(table):
                    if k != d and d in table[k].dims:
                        table[k] = _mask_missing(table[k], d, missing,
                                                 fill_value)
        sub._coords[d] = _var((d,), labels, None, obj)
        out = sub
    return out


def _roll_coord(cv, shifts):
    for d, k in shifts.items():
        if d in cv.dims:
            data = cv.data
            ax = cv.dims.index(d)
            data = torch.roll(data, int(k), ax) \
                if isinstance(data, torch.Tensor) \
                else np.roll(data, int(k), axis=ax)
            cv = Variable(cv.dims, data, cv.attrs)
    return cv


def _interp_weights(c, t):
    """(lo, hi, w, out of range) of targets ``t`` on the coordinate
    ``c`` (float64, any order): value = v[lo] + (v[hi] - v[lo]) * w."""
    n = len(c)
    order = np.arange(n)
    cs = c
    if n > 1 and not np.all(np.diff(c) >= 0):
        order = np.argsort(c, kind='stable')
        cs = c[order]
    j = np.searchsorted(cs, t, side='left')
    lo_s = np.clip(j - 1, 0, n - 1)
    hi_s = np.clip(j, 0, n - 1)
    denom = cs[hi_s] - cs[lo_s]
    w = np.where(denom == 0, 0.0,
                 (t - cs[lo_s]) / np.where(denom == 0, 1, denom))
    exact = cs[hi_s] == t
    w = np.where(exact, 1.0, w)
    lo = order[np.where(exact, hi_s, lo_s)]
    hi = order[hi_s]
    oob = (t < cs[0]) | (t > cs[-1]) | np.isnan(t)
    return lo, hi, w, oob


def _interp_coord(cv, dim, lo, hi, w, oob, scalar, like):
    """A numeric or datetime coordinate along ``dim`` interpolated on the
    host as the data is."""
    kind = cv.values.dtype.kind
    cax = cv.dims.index(dim)
    cfl = _as_float_index(cv.values) if kind in 'Mm' \
        else cv.values.astype(np.float64)
    clo = np.take(cfl, lo, axis=cax)
    chi = np.take(cfl, hi, axis=cax)
    cshape = [1] * clo.ndim
    cshape[cax] = len(lo)
    cval = clo + (chi - clo) * np.where(oob, np.nan, w).reshape(cshape)
    if kind in 'Mm':
        cval = np.where(np.isnan(cval),
                        np.full(1, 'NaT', dtype=cv.values.dtype),
                        np.round(np.nan_to_num(cval)).astype('int64')
                        .astype(cv.values.dtype))
    cdims = cv.dims
    if scalar:
        cval = np.take(cval, 0, axis=cax)
        cdims = tuple(d for d in cv.dims if d != dim)
    return _var(cdims, cval, cv.attrs, like)


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
        if device is None and not isinstance(value, (Variable, DataArray)):
            device = _device_of(self)
        var = _coerce_coord(key, value, device)
        _check_sizes(self.sizes, var, 'coordinate %r' % key)
        self._coords[key] = var

    def _coord_dataarray(self, key):
        var = self._coords[key]
        return DataArray._from_parts(
            var, _reduced_coords(self._coords, set(var.dims)), var.attrs,
            key)

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

    @property
    def chunks(self):
        return {}

    @property
    def nbytes(self):
        return sum(self[k].nbytes for k in self._variables)

    @property
    def loc(self):
        return _LocIndexer(self)

    def __getitem__(self, key):
        if isinstance(key, (list, tuple)):
            ds = Dataset(attrs=self.attrs)
            keep = set()
            for k in key:
                if k not in self._variables:
                    raise KeyError(k)
                ds._variables[k] = self._variables[k]
                keep |= set(self._variables[k].dims)
            ds._coords = _reduced_coords(self._coords, keep)
            return ds
        if key in self._variables:
            var = self._variables[key]
            return DataArray._from_parts(
                var, _reduced_coords(self._coords, set(var.dims)), var.attrs,
                key)
        if key in self._coords:
            return self._coord_dataarray(key)
        raise KeyError(key)

    def __setitem__(self, key, value):
        self._assign(key, value)

    def _assign(self, key, value, device=None):
        if device is None:
            device = _device_of(self)
        if isinstance(value, DataArray):
            src = value.variable                 # a lazy view stays lazy
            var = Variable(value.dims, src._data, value.attrs, src._device)
            for ck, cv in value._coords.items():
                self._coords.setdefault(ck, cv)
        elif isinstance(value, Variable):
            var = value
        elif isinstance(value, tuple) and len(value) in (2, 3):
            var = Variable(value[0], value[1],
                           value[2] if len(value) == 3 else None, device)
        elif np.isscalar(value) or np.ndim(value) == 0:
            var = Variable((), as_array(value, device))
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

    def __delitem__(self, key):
        if key in self._variables:
            del self._variables[key]
        elif key in self._coords:
            del self._coords[key]
        else:
            raise KeyError(key)

    def __contains__(self, key):
        return key in self._variables or key in self._coords

    def __iter__(self):
        return iter(self._variables)

    def __len__(self):
        return len(self._variables)

    def keys(self):
        return self._variables.keys()

    def items(self):
        return ((k, self[k]) for k in self._variables)

    def values(self):
        return (self[k] for k in self._variables)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def _new(self, variables=None, coords=None, attrs=None):
        ds = Dataset(attrs=self.attrs if attrs is None else attrs)
        ds._variables = dict(self._variables if variables is None
                             else variables)
        ds._coords = dict(self._coords if coords is None else coords)
        return ds

    # -- structure -------------------------------------------------------------------
    def copy(self, deep=True):
        return self._new({k: v.copy(deep) for k, v in self._variables.items()},
                         {k: v.copy(deep) for k, v in self._coords.items()},
                         dict(self.attrs))

    def isel(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        sizes = self.sizes
        for d in indexers:
            if d not in sizes:
                raise ValueError('dimension %r not in %r' % (d, tuple(sizes)))

        def sub(v):
            ix = {d: i for d, i in indexers.items() if d in v.dims}
            return v.isel(ix) if ix else v
        return self._new({k: sub(v) for k, v in self._variables.items()},
                         {k: sub(v) for k, v in self._coords.items()})

    def sel(self, indexers=None, method=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        isel_kw = {}
        for d, label in indexers.items():
            if d not in self._coords:
                raise KeyError('no coordinate for dimension %r' % d)
            isel_kw[d] = _sel_to_isel(self._coords[d], label, method)
        return self.isel(isel_kw)

    def head(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        return self.isel({d: slice(0, int(n)) for d, n in indexers.items()})

    def tail(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        return self.isel({d: slice(-int(n), None)
                          for d, n in indexers.items()})

    def thin(self, indexers=None, **kwargs):
        indexers = _normalize_indexers(indexers, kwargs)
        return self.isel({d: slice(None, None, int(n))
                          for d, n in indexers.items()})

    def drop_isel(self, indexers=None, **kwargs):
        return _drop_isel(self, _normalize_indexers(indexers, kwargs))

    def drop_sel(self, indexers=None, **kwargs):
        return _drop_sel(self, _normalize_indexers(indexers, kwargs))

    def drop_vars(self, names):
        names = [names] if isinstance(names, str) else names
        ds = self.copy(deep=False)
        for n in names:
            if n in ds._variables:
                del ds._variables[n]
            elif n in ds._coords:
                del ds._coords[n]
        return ds

    drop = drop_vars

    def drop_dims(self, dims):
        dims = {dims} if isinstance(dims, str) else set(dims)
        return self._new(
            {k: v for k, v in self._variables.items()
             if not set(v.dims) & dims},
            {k: v for k, v in self._coords.items() if not set(v.dims) & dims})

    def transpose(self, *dims):
        def order(v):
            if not dims:
                return tuple(reversed(v.dims))
            first = tuple(d for d in dims if d in v.dims)
            return first + tuple(d for d in v.dims if d not in first)
        coords = {k: v.transpose(*order(v)) if v.ndim > 1 else v
                  for k, v in self._coords.items()}
        return self._new({k: v.transpose(*order(v))
                          for k, v in self._variables.items()}, coords)

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
        if isinstance(dim, dict):
            out = Dataset(attrs=self.attrs)
            out._coords = {k: v for k, v in self._coords.items()}
            for k in self._variables:
                da = self[k].expand_dims(dim, axis)
                out._variables[k] = da.variable
                for ck, cv in da._coords.items():
                    out._coords.setdefault(ck, cv)
            return out
        ds = self._new({k: v.expand_dims(dim, axis)
                        for k, v in self._variables.items()})
        if dim in ds._coords and ds._coords[dim].ndim == 0:
            ds._coords[dim] = ds._coords[dim].expand_dims(dim)
        return ds

    def rename(self, mapping=None, **kwargs):
        mapping = _normalize_indexers(mapping, kwargs)
        return self._new(
            {mapping.get(k, k): v.rename_dims(mapping)
             for k, v in self._variables.items()},
            {mapping.get(k, k): v.rename_dims(mapping)
             for k, v in self._coords.items()})

    def rename_vars(self, mapping=None, **kwargs):
        mapping = _normalize_indexers(mapping, kwargs)
        return self._new(
            {mapping.get(k, k): v for k, v in self._variables.items()},
            {mapping.get(k, k): v for k, v in self._coords.items()})

    def rename_dims(self, mapping=None, **kwargs):
        mapping = _normalize_indexers(mapping, kwargs)
        return self._new(
            {k: v.rename_dims(mapping) for k, v in self._variables.items()},
            {k: v.rename_dims(mapping) for k, v in self._coords.items()})

    def swap_dims(self, mapping=None, **kwargs):
        mapping = _normalize_indexers(mapping, kwargs)
        _validate_swap(mapping, self._coords)
        return self.rename_dims(mapping)

    def astype(self, dtype):
        return self.map(lambda da: da.astype(dtype))

    def set_coords(self, names):
        """Promote data variables to coordinates."""
        out = self.copy(deep=False)
        for k in [names] if isinstance(names, str) else names:
            if k not in out._variables:
                raise KeyError('no variable %r' % k)
            out._coords[k] = out._variables.pop(k)
        return out

    def reset_coords(self, names=None, drop=False):
        """Demote non-index coordinates to data variables (or drop)."""
        sizes = self.sizes
        if names is None:
            names = [k for k in self._coords if k not in sizes]
        elif isinstance(names, str):
            names = [names]
        out = self.copy(deep=False)
        for k in names:
            if k in sizes:
                raise ValueError('cannot reset index coordinate %r' % k)
            if k not in out._coords:
                raise KeyError('no coordinate %r' % k)
            cv = out._coords.pop(k)
            if not drop:
                out._variables[k] = cv
        return out

    def update(self, other):
        """Merge ``other``'s variables and coordinates in place (each
        through ``__setitem__``, so that size conflicts raise)."""
        if isinstance(other, Dataset):
            self._coords.update(other._coords)
            for k, v in other._variables.items():
                self[k] = v
        else:
            for k, v in dict(other).items():
                self[k] = v
        return self

    def assign(self, variables=None, **kwargs):
        out = self.copy(deep=False)
        for k, v in {**(variables or {}), **kwargs}.items():
            out[k] = v(out) if callable(v) else v
        return out

    def assign_coords(self, coords=None, **kwargs):
        out = self.copy(deep=False)
        for k, v in {**(coords or {}), **kwargs}.items():
            out._set_coord(k, v)
        return out

    def assign_attrs(self, *args, **kwargs):
        out = self.copy(deep=False)
        out.attrs.update(dict(*args, **kwargs))
        return out

    def merge(self, other):
        ds = self.copy(deep=False)
        ds._variables.update(other._variables)
        for k, v in other._coords.items():
            ds._coords.setdefault(k, v)
        ds.attrs.update(other.attrs)
        return ds

    def combine_first(self, other):
        """Union-aligned NaN fill per variable; variables of only one
        input pass through (reindexed to the union grid)."""
        a, b = _union_align(self, other)
        out = Dataset({}, attrs=dict(a.attrs))
        for k in a._variables:
            if k in b._variables:
                da, db = broadcast(a[k], b[k])
                out[k] = da.where(da.notnull(), db)
            else:
                out[k] = a[k]
        for k in b._variables:
            if k not in a._variables:
                out[k] = b[k]
        for ck, cv in a._coords.items():
            out._coords.setdefault(ck, cv)
        return out

    def stack(self, **kwargs):
        """Stack dims into one on every variable (a variable missing a
        stacked dim is broadcast over it first)."""
        (new_dim, dims), = kwargs.items()
        dims = tuple(dims)
        sizes = self.sizes
        ds = Dataset(attrs=dict(self.attrs))
        ds._coords = {k: v for k, v in self._coords.items()
                      if not set(v.dims) & set(dims)}
        for k in self._variables:
            da = self[k]
            missing = [d for d in dims if d not in da.dims]
            if missing:
                da = DataArray._from_parts(
                    da.variable.broadcast_to(
                        da.dims + tuple(missing),
                        da.shape + tuple(sizes[d] for d in missing)),
                    da._coords, da.attrs, da.name)
            ds._variables[k] = da.stack(**{new_dim: dims}).variable
        ds.attrs[_STACK_ATTR] = {
            'dim': new_dim, 'dims': dims,
            'shape': tuple(sizes[d] for d in dims),
            'coords': {k: v for k, v in self._coords.items()
                       if set(v.dims) & set(dims)}}
        return ds

    def unstack(self, dim=None):
        info = self.attrs.get(_STACK_ATTR)
        if info is None:
            raise ValueError('Dataset was not stacked by nd_tpu_torch')
        new_dim, dims, shape = info['dim'], tuple(info['dims']), \
            tuple(info['shape'])
        ds = Dataset(attrs={k: v for k, v in self.attrs.items()
                            if k != _STACK_ATTR})
        ds._coords = {k: v for k, v in self._coords.items()
                      if new_dim not in v.dims}
        ds._coords.update(info['coords'])
        for k, v in self._variables.items():
            if new_dim not in v.dims:
                ds._variables[k] = v
                continue
            other = tuple(d for d in v.dims if d != new_dim)
            vt = v.transpose(*(other + (new_dim,)))
            ds._variables[k] = Variable(
                other + dims, vt.data.reshape(vt.shape[:-1] + shape), v.attrs)
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

    def to_dataarray(self, dim='variable'):
        return self.to_array(dim)

    def map(self, func, **kwargs):
        """``func(DataArray)`` over every data variable."""
        ds = self._new({})
        for k in self._variables:
            res = func(self[k], **kwargs)
            ds._variables[k] = Variable(res.dims, res.data, res.attrs)
            for ck, cv in res._coords.items():
                ds._coords.setdefault(ck, cv)
        return ds

    def apply(self, func, **kwargs):
        """:meth:`map` by another name."""
        return self.map(func, **kwargs)

    # -- elementwise ------------------------------------------------------------------
    def where(self, cond, other=np.nan):
        return self.map(lambda da: da.where(
            cond if not isinstance(cond, Dataset) else cond[da.name], other))

    def fillna(self, value):
        return self.map(lambda da: da.fillna(value))

    def isnull(self):
        return self.map(lambda da: da.isnull())

    def notnull(self):
        return self.map(lambda da: da.notnull())

    def round(self, decimals=0):
        return self.map(lambda da: da.round(decimals))

    def clip(self, min=None, max=None):
        return self.map(lambda da: da.clip(min, max))

    def isin(self, test_elements):
        return self.map(lambda da: da.isin(test_elements))

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

    # -- reductions -------------------------------------------------------------------
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
            for ck, cv in res._coords.items():
                if ck not in self._coords:
                    ds._coords.setdefault(ck, cv)
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

    def median(self, dim=None, **kw):
        return self._reduce_all('median', dim, **kw)

    def prod(self, dim=None, **kw):
        return self._reduce_all('prod', dim, **kw)

    def all(self, dim=None, **kw):
        return self._reduce_all('all', dim, **kw)

    def any(self, dim=None, **kw):
        return self._reduce_all('any', dim, **kw)

    def count(self, dim=None, **kw):
        return self._reduce_all('count', dim, **kw)

    def argmin(self, dim=None, **kw):
        return self._reduce_all('argmin', dim, **kw)

    def argmax(self, dim=None, **kw):
        return self._reduce_all('argmax', dim, **kw)

    def quantile(self, q, dim=None, **kw):
        return self._reduce_all('quantile', dim, q=q, **kw)

    def reduce(self, func, dim=None, **kw):
        dimset = set(self.sizes) if dim is None else \
            ({dim} if isinstance(dim, str) else set(dim))
        ds = Dataset(attrs=self.attrs)
        ds._coords = {k: v for k, v in self._coords.items()
                      if not set(v.dims) & dimset}
        for k in self._variables:
            da = self[k]
            sub = tuple(d for d in da.dims if d in dimset)
            res = da.reduce(func, dim=sub, **kw) if sub else da
            ds._variables[k] = Variable(res.dims, res.data, res.attrs)
        return ds

    def _per_variable(self, dim, fn):
        """``fn(DataArray)`` on every variable that has ``dim`` (a name or
        a tuple); the others pass through."""
        dims = {dim} if isinstance(dim, str) else set(dim or ())
        ds = self.copy(deep=False)
        for k in list(ds._variables):
            if dim is None or set(ds._variables[k].dims) & dims:
                ds._variables[k] = fn(self[k]).variable
        return ds

    def _accumulate_all(self, name, dim):
        dims = None if dim is None else \
            ({dim} if isinstance(dim, str) else set(dim))
        return self._per_variable(dim, lambda da: getattr(da, name)(
            dim=tuple(d for d in da.dims if dims is None or d in dims)))

    def cumsum(self, dim=None, **kw):
        return self._accumulate_all('cumsum', dim)

    def cumprod(self, dim=None, **kw):
        return self._accumulate_all('cumprod', dim)

    def diff(self, dim, n=1, label='upper'):
        sl = slice(n, None) if label == 'upper' else slice(None, -n)
        ds = self._per_variable(dim, lambda da: da.diff(dim, n=n,
                                                        label=label))
        ds._coords = {k: v.isel({dim: sl}) if dim in v.dims else v
                      for k, v in self._coords.items()}
        return ds

    def shift(self, shifts=None, fill_value=np.nan, **kwargs):
        shifts = _normalize_indexers(shifts, kwargs)
        return self._per_variable(tuple(shifts), lambda da: da.shift(
            {d: s for d, s in shifts.items() if d in da.dims},
            fill_value=fill_value))

    def roll(self, shifts=None, roll_coords=False, **kwargs):
        shifts = _normalize_indexers(shifts, kwargs)
        ds = self._per_variable(tuple(shifts), lambda da: da.roll(
            {d: s for d, s in shifts.items() if d in da.dims}))
        if roll_coords:
            ds._coords = {k: _roll_coord(v, shifts)
                          for k, v in ds._coords.items()}
        return ds

    def pad(self, pad_width=None, mode='constant', constant_values=np.nan,
            **kwargs):
        pad_width = _normalize_indexers(pad_width, kwargs)
        norm = {d: ((w, w) if np.isscalar(w) else tuple(w))
                for d, w in pad_width.items()}
        ds = self._per_variable(tuple(norm), lambda da: da.pad(
            {d: w for d, w in norm.items() if d in da.dims}, mode=mode,
            constant_values=constant_values))
        coords = {}
        for k, v in self._coords.items():
            cw = [norm.get(d, (0, 0)) for d in v.dims]
            coords[k] = _pad_coord(v, cw, self) \
                if any(a or b for a, b in cw) else v
        ds._coords = coords
        return ds

    def sortby(self, variables, ascending=True):
        return _sortby(self, variables, ascending)

    def reindex(self, indexers=None, method=None, fill_value=np.nan,
                **kwargs):
        return _reindex(self, _normalize_indexers(indexers, kwargs), method,
                        fill_value)

    def reindex_like(self, other, method=None, fill_value=np.nan):
        indexers = {d: other._coords[d].values for d in self.sizes
                    if d in other._coords and d in self._coords}
        return self.reindex(indexers, method=method, fill_value=fill_value)

    def dropna(self, dim, how='any', thresh=None):
        counts, total = None, 0
        for k in self._variables:
            da = self[k]
            if dim not in da.dims:
                continue
            other = tuple(d for d in da.dims if d != dim)
            c = np.asarray(da.notnull().sum(dim=other).values
                           if other else da.notnull().values)
            counts = c if counts is None else counts + c
            total += int(np.prod([da.sizes[d] for d in other],
                                 dtype=np.int64)) if other else 1
        if counts is None:
            return self
        return self.isel({dim: _keep(counts, total, how, thresh)})

    # -- grouped and windowed -----------------------------------------------------
    groupby = DataArray.groupby
    resample = DataArray.resample
    rolling = DataArray.rolling
    coarsen = DataArray.coarsen
    weighted = DataArray.weighted

    def ffill(self, dim, limit=None):
        return self._per_variable(dim, lambda da: da.ffill(dim, limit=limit))

    def bfill(self, dim, limit=None):
        return self._per_variable(dim, lambda da: da.bfill(dim, limit=limit))

    def interpolate_na(self, dim=None, method='linear', limit=None,
                       use_coordinate=True, max_gap=None):
        return self._per_variable(dim, lambda da: da.interpolate_na(
            dim, method=method, limit=limit, use_coordinate=use_coordinate,
            max_gap=max_gap))

    def interp(self, coords=None, method='linear', assume_sorted=False,
               **coords_kwargs):
        """Per-variable interpolation onto new coordinate values;
        variables without an interpolated dim pass through."""
        indexers = _normalize_indexers(coords, coords_kwargs)
        out = Dataset({}, attrs=dict(self.attrs))
        for k in self._variables:
            da = self[k]
            sub = {d: t for d, t in indexers.items() if d in da.dims}
            out[k] = da.interp(sub, method=method) if sub else da
        for ck, cv in self._coords.items():
            if ck not in out._coords \
                    and not any(d in indexers for d in cv.dims):
                out._coords[ck] = cv
        return out

    def interp_like(self, other, method='linear'):
        dims = set()
        for v in self._variables.values():
            dims.update(v.dims)
        indexers = {d: other._coords[d].values for d in dims
                    if d in other._coords and other._coords[d].ndim == 1
                    and d in self._coords}
        return self.interp(indexers, method=method)

    def differentiate(self, coord):
        return self.map(lambda da: da.differentiate(coord)
                        if coord in da._coords
                        and da._coords[coord].ndim == 1
                        and da._coords[coord].dims[0] in da.dims else da)

    def integrate(self, coord):
        dim = self._coords[coord].dims[0]
        out = Dataset({}, attrs=dict(self.attrs))
        for k in self._variables:
            da = self[k]
            out[k] = da.integrate(coord) if dim in da.dims else da
        for ck, cv in self._coords.items():
            if dim not in cv.dims:
                out._coords.setdefault(ck, cv)
        return out

    # -- comparison ---------------------------------------------------------------------
    def equals(self, other):
        if not isinstance(other, Dataset) \
                or set(self._variables) != set(other._variables) \
                or not _coords_equiv(self._coords, other._coords):
            return False
        return all(v.dims == other._variables[k].dims
                   and _array_equiv(v.values, other._variables[k].values)
                   for k, v in self._variables.items())

    def identical(self, other):
        return self.equals(other) and self.attrs == other.attrs and all(
            self._variables[k].attrs == other._variables[k].attrs
            for k in self._variables)

    def broadcast_equals(self, other):
        if not isinstance(other, Dataset) \
                or set(self._variables) != set(other._variables):
            return False
        return all(self[k].broadcast_equals(other[k])
                   for k in self._variables)

    # -- host copies, serialisation and pandas ------------------------------------
    def to_dataframe(self):
        import pandas as pd
        union = tuple(self.sizes)
        frames = {}
        for k in self._variables:
            da = self[k]
            missing = [d for d in union if d not in da.dims]
            if missing:
                da = DataArray._from_parts(
                    da.variable.broadcast_to(
                        da.dims + tuple(missing),
                        da.shape + tuple(self.sizes[d] for d in missing)),
                    self._coords, da.attrs, k)
            frames[k] = da.transpose(*union).to_series()
        return pd.DataFrame(frames)

    get_index = DataArray.get_index

    def persist(self):
        return self

    def compute(self):
        return self

    def chunk(self, *args, **kwargs):
        return self

    def load(self):
        for k, v in list(self._variables.items()):
            self._variables[k] = Variable(v.dims, _host(v.data), v.attrs)
        return self

    def as_numpy(self):
        return self.map(lambda da: da.as_numpy())

    def to_dict(self, data=True):
        def entry(v):
            return {'dims': v.dims,
                    'data': v.values.tolist() if data else v.shape,
                    'attrs': dict(v.attrs)}
        return {'dims': dict(self.sizes), 'attrs': dict(self.attrs),
                'coords': {k: entry(v) for k, v in self._coords.items()},
                'data_vars': {k: entry(v)
                              for k, v in self._variables.items()}}

    @classmethod
    def from_dict(cls, d, device=None):
        def parts(table):
            return {k: (tuple(c['dims']), np.asarray(c['data']),
                        c.get('attrs')) for k, c in table.items()}
        return cls(parts(d.get('data_vars', {})),
                   coords=parts(d.get('coords', {})), attrs=d.get('attrs'),
                   device=device)

    def __repr__(self):
        return '<nd_tpu_torch.Dataset %r vars=%r>' % (
            self.sizes, list(self._variables))


# -- module functions ------------------------------------------------------------

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


def broadcast(*objs):
    """Broadcast DataArrays against each other by dimension name."""
    out_dims, sizes = [], {}
    for o in objs:
        for d, s in zip(o.dims, o.shape):
            if d not in out_dims:
                out_dims.append(d)
            if sizes.get(d, s) not in (s, 1) and s != 1:
                raise ValueError('conflicting size for dim %r' % d)
            sizes[d] = max(sizes.get(d, s), s)
    shape = tuple(sizes[d] for d in out_dims)
    return tuple(DataArray._from_parts(o.variable.broadcast_to(out_dims,
                                                                shape),
                                       o._coords, o.attrs, o.name)
                 for o in objs)


def _concat_variables(variables, dim, dim_exists):
    datas = [v.data for v in variables]
    tensor = isinstance(datas[0], torch.Tensor)
    if tensor:
        datas = [torch.as_tensor(d, device=datas[0].device) for d in datas]
    else:
        datas = [to_numpy(d) for d in datas]
    if dim_exists:
        axis = variables[0].dims.index(dim)
        data = torch.cat(datas, axis) if tensor \
            else np.concatenate(datas, axis)
        return Variable(variables[0].dims, data, variables[0].attrs)
    data = torch.stack(datas) if tensor else np.stack(datas)
    return Variable((dim,) + variables[0].dims, data, variables[0].attrs)


def _concat_coord(objs, k, v, dim):
    """A coordinate along ``dim`` joined on the host; inputs without it
    contribute NaN (NaT) so that its length matches the joined dim."""
    axis = v.dims.index(dim)
    parts = []
    for o in objs:
        if k in o._coords:
            parts.append(o._coords[k].values)
            continue
        shape = list(v.shape)
        shape[axis] = o.sizes.get(dim, 1)
        vals0 = v.values
        if vals0.dtype.kind in 'mM':
            parts.append(np.full(shape, 'NaT', dtype=vals0.dtype))
        else:
            parts.append(np.full(shape, np.nan,
                                 vals0.dtype if vals0.dtype.kind in 'fc'
                                 else np.float64))
    return _var(v.dims, np.concatenate(parts, axis=axis), v.attrs, objs[0])


def concat(objs, dim):
    """Concatenate Datasets or DataArrays along a dimension (an existing
    one, or a new one: leading for DataArrays, last for Datasets, as the
    JAX package does)."""
    objs = list(objs)
    if not objs:
        raise ValueError('nothing to concatenate')
    if isinstance(objs[0], DataArray):
        dim_exists = dim in objs[0].dims
        variables = []
        for o in objs:
            v = o.variable
            if dim_exists and dim not in v.dims:
                v = v.expand_dims(dim, objs[0].dims.index(dim))
            elif not dim_exists and dim in v.dims:
                raise ValueError('cannot concatenate along new dim %r: input '
                                 '%r already has it' % (dim, o.name))
            variables.append(v)
        var = _concat_variables(variables, dim, dim_exists)
        coords = {k: _concat_coord(objs, k, v, dim) if dim in v.dims else v
                  for k, v in objs[0]._coords.items()}
        if not dim_exists:
            vals = [o._coords[dim].values for o in objs
                    if dim in o._coords and o._coords[dim].ndim == 0]
            if vals and len(vals) == len(objs):
                coords[dim] = _var((dim,), np.stack(vals), None, objs[0])
        return DataArray._from_parts(var, coords, objs[0].attrs,
                                     objs[0].name)
    first = objs[0]
    dim_exists = dim in first.sizes
    ds = Dataset(attrs=dict(first.attrs))
    for k, v in first._coords.items():
        ds._coords[k] = _concat_coord(objs, k, v, dim) if dim in v.dims \
            else v
    for k, v in first._variables.items():
        if dim in v.dims:
            ds._variables[k] = _concat_variables(
                [o._variables[k] for o in objs], dim, True)
        elif not dim_exists:
            stacked = _concat_variables([o._variables[k] for o in objs],
                                        dim, False)
            ds._variables[k] = stacked.transpose(*(v.dims + (dim,)))
        else:
            ds._variables[k] = v
    if not dim_exists:
        vals = [o._coords[dim].values for o in objs
                if dim in o._coords and o._coords[dim].ndim == 0]
        if vals and len(vals) == len(objs):
            ds._coords[dim] = _var((dim,), np.stack(vals), None, first)
    return ds


def merge(objs):
    """Merge Datasets and named DataArrays into one Dataset."""
    ds = Dataset()
    for o in objs:
        if isinstance(o, DataArray):
            o = o.to_dataset()
        for k, v in o._coords.items():
            ds._coords.setdefault(k, v)
        ds._variables.update(o._variables)
        ds.attrs.update(o.attrs)
    return ds


def expand_variables_da(da, dim='variable'):
    """Inverse of :meth:`Dataset.to_array`."""
    names = [str(n) for n in np.asarray(da[dim].values)]
    axis = da.dims.index(dim)
    ds = Dataset(attrs=dict(da.attrs))
    ds._coords = {k: v for k, v in da._coords.items() if k != dim}
    new_dims = tuple(d for d in da.dims if d != dim)
    for i, n in enumerate(names):
        data = da.data.select(axis, i) if isinstance(da.data, torch.Tensor) \
            else np.take(da.data, i, axis=axis)
        ds._variables[n] = Variable(new_dims, data)
    return ds


def full_like(obj, fill_value, dtype=None):
    """A DataArray of ``obj``'s dims, coordinates and device filled with
    ``fill_value`` (in ``dtype``, default ``obj``'s)."""
    if not isinstance(obj, DataArray):
        raise TypeError(type(obj))
    data = obj.data
    if isinstance(data, torch.Tensor):
        dtype = data.dtype if dtype is None else torch_dtype(dtype)
        return obj._replace(torch.full(data.shape, fill_value, dtype=dtype,
                                       device=data.device))
    return obj._replace(np.full(data.shape, fill_value,
                                dtype=dtype or data.dtype))


def zeros_like(obj, dtype=None):
    return full_like(obj, 0, dtype)


def ones_like(obj, dtype=None):
    return full_like(obj, 1, dtype)


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
