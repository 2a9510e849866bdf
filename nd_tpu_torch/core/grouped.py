"""Grouped and windowed operations: groupby, resample, rolling, coarsen,
weighted, and the ``.dt`` calendar fields.

Counterpart of ``nd_tpu/core/grouped.py``. Group membership and
resampling bins are computed on the host from the coordinate values, in
numpy (the JAX package asks pandas; the card's machine has no pandas, so
``dt_field`` and ``Resample`` bin edges and labels are written out here
and equal pandas' for the frequencies listed under :func:`resample_bins`).
The per-group and per-window reductions run through the payload's own
path, so tensors stay on their device.
"""

from __future__ import annotations

import datetime
import re

import numpy as np
import torch

from . import nanops
from .variable import Variable, to_numpy

__all__ = ['GroupBy', 'Resample', 'Rolling', 'Coarsen', 'Weighted',
           'DatetimeAccessor', 'dt_field', 'resample_bins']

_DT_FIELDS = ('year', 'month', 'day', 'hour', 'minute', 'second',
              'dayofyear', 'dayofweek', 'weekday', 'quarter',
              'season', 'date', 'week', 'weekofyear', 'days_in_month',
              'time')
_SEASON = np.array(['DJF', 'DJF', 'MAM', 'MAM', 'MAM', 'JJA', 'JJA', 'JJA',
                    'SON', 'SON', 'SON', 'DJF'])


def _days(values):
    """Days since 1970-01-01 (floor) of datetime64 values, int64."""
    return values.astype('datetime64[D]').astype(np.int64)


def _ymd(values):
    m = values.astype('datetime64[M]').astype(np.int64)
    year = m // 12 + 1970
    month = m % 12 + 1
    day = _days(values) - _days(values.astype('datetime64[M]')) + 1
    return year, month, day


def dt_field(values, field):
    """A calendar field of a datetime64 array (the ``.dt`` and
    ``'time.month'`` surface), computed in numpy with pandas' conventions:
    Monday is day 0, ISO weeks, seasons DJF/MAM/JJA/SON; a field of NaT is
    NaN (float), ``date`` and ``time`` are ``datetime`` objects."""
    values = np.asarray(values)
    if values.dtype.kind != 'M':
        raise TypeError("'.%s' only works on datetime coordinates (got "
                        'dtype %s)' % (field, values.dtype))
    if field not in _DT_FIELDS:
        raise AttributeError('unknown datetime field %r (choose from %s)'
                             % (field, ', '.join(_DT_FIELDS)))
    nat = np.isnat(values)
    vals = np.where(nat, np.datetime64(0, 'ns'),
                    values.astype('datetime64[ns]'))
    year, month, day = _ymd(vals)
    days = _days(vals)
    ns_of_day = (vals - vals.astype('datetime64[D]')).astype(
        'timedelta64[ns]').astype(np.int64)
    if field in ('date', 'time'):
        out = np.empty(values.shape, dtype=object)
        for i in np.ndindex(values.shape):
            if nat[i]:
                out[i] = None if field == 'time' else np.datetime64('NaT')
            elif field == 'date':
                out[i] = datetime.date(int(year[i]), int(month[i]),
                                       int(day[i]))
            else:
                us, ns = divmod(int(ns_of_day[i]), 1000)
                s, us = divmod(us, 10 ** 6)
                out[i] = datetime.time(s // 3600, s // 60 % 60, s % 60, us)
        return out
    if field == 'season':
        return _SEASON[month - 1].reshape(values.shape)
    dow = (days + 3) % 7                           # 1970-01-01: Thursday
    if field == 'year':
        out = year
    elif field == 'month':
        out = month
    elif field == 'day':
        out = day
    elif field == 'hour':
        out = ns_of_day // 3_600_000_000_000
    elif field == 'minute':
        out = ns_of_day // 60_000_000_000 % 60
    elif field == 'second':
        out = ns_of_day // 1_000_000_000 % 60
    elif field == 'dayofyear':
        out = days - _days(vals.astype('datetime64[Y]')) + 1
    elif field in ('dayofweek', 'weekday'):
        out = dow
    elif field == 'quarter':
        out = (month - 1) // 3 + 1
    elif field == 'days_in_month':
        m = vals.astype('datetime64[M]')
        out = _days(m + np.timedelta64(1, 'M')) - _days(m)
    else:                                          # ISO week
        thursday = (days - dow + 3).astype('datetime64[D]')
        out = (_days(thursday) - _days(thursday.astype('datetime64[Y]'))) \
            // 7 + 1
    out = np.asarray(out, np.int64).reshape(values.shape)
    if nat.any():
        out = np.where(nat, np.nan, out.astype(np.float64))
    return out


class DatetimeAccessor:
    """``da.dt.<field>``: calendar fields of a datetime DataArray."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, field):
        if field.startswith('_'):
            raise AttributeError(field)
        from .dataarray import DataArray, _var
        da = self._obj
        return DataArray._from_parts(
            _var(da.dims, dt_field(da.values, field), None, da),
            dict(da._coords), {}, field)

    def __dir__(self):
        return list(_DT_FIELDS)


class GroupBy:
    """Split an object along one dimension by coordinate value: iterate
    ``(label, subset)`` pairs, ``map`` a function over the groups, or
    reduce each group over the grouped dimension (``mean``, ``sum``,
    ...), the results joined along a dimension named after the group."""

    _REDUCERS = ('mean', 'std', 'var', 'min', 'max', 'sum', 'median',
                 'prod', 'all', 'any', 'count')

    def __init__(self, obj, dim, labels, indices, result_dim,
                 restore_order=None):
        self._obj = obj
        self._dim = dim
        self._labels = labels
        self._indices = indices
        self._result_dim = result_dim
        self._restore_order = restore_order

    @classmethod
    def from_group(cls, obj, group):
        """From a coordinate name, a virtual datetime field
        (``'time.month'``) or a 1-d DataArray of labels."""
        from .dataarray import DataArray
        if isinstance(group, str):
            name = group
            if group not in obj._coords and '.' in group:
                base, _, field = group.partition('.')
                if base not in obj._coords:
                    raise KeyError('no coordinate %r to group by' % base)
                cv = obj._coords[base]
                gvar = Variable(cv.dims, dt_field(cv.values, field),
                                device='cpu')     # labels: host only
                name = field
            elif group not in obj._coords:
                raise KeyError('no coordinate %r to group by' % group)
            else:
                gvar = obj._coords[group]
        elif isinstance(group, DataArray):
            name = group.name or 'group'
            gvar = group.variable
        else:
            raise TypeError('group must be a coordinate name or DataArray')
        if gvar.ndim != 1:
            raise ValueError('can only group by 1-d coordinates')
        values = gvar.values
        labels, inverse = np.unique(values, return_inverse=True)
        inverse = inverse.ravel()
        values_idx = None
        # NaN-labelled elements are left out, as xarray does
        if len(labels) and labels.dtype.kind == 'f' and np.isnan(labels[-1]):
            keep = inverse != len(labels) - 1
            labels = labels[:-1]
            values_idx = np.nonzero(keep)[0]
            inverse = inverse[keep]
        order_all = np.argsort(inverse, kind='stable')
        bounds = np.searchsorted(inverse[order_all],
                                 np.arange(1, len(labels)))
        indices = np.split(order_all, bounds)
        if values_idx is not None:
            indices = [values_idx[i] for i in indices]
        order = np.concatenate(indices) if indices else np.empty(0, int)
        return cls(obj, gvar.dims[0], labels, indices, name,
                   np.argsort(order, kind='stable'))

    def __len__(self):
        return len(self._labels)

    def __iter__(self):
        for label, idx in zip(self._labels, self._indices):
            yield label, self._obj.isel({self._dim: idx})

    def groups(self):
        return dict(zip(self._labels, self._indices))

    def map(self, func, **kwargs):
        """``func`` on each group; results that keep the grouped dim are
        joined along it in the original order, others stacked along the
        group dim."""
        from .dataarray import concat
        results = [func(sub, **kwargs) for _, sub in self]
        if not results:
            raise ValueError('cannot map over zero groups')
        if self._dim in getattr(results[0], 'dims', ()):
            out = concat(results, dim=self._dim)
            if self._restore_order is not None \
                    and out.sizes[self._dim] == len(self._restore_order):
                out = out.isel({self._dim: self._restore_order})
            return out
        return self._stack_results(results)

    apply = map

    def _stack_results(self, results):
        from .dataarray import _var, concat
        out = concat(results, dim=self._result_dim)
        out._coords[self._result_dim] = _var(
            (self._result_dim,), np.asarray(self._labels), None, self._obj)
        return out

    def _reduce(self, name, **kwargs):
        return self._stack_results([getattr(sub, name)(dim=self._dim,
                                                       **kwargs)
                                    for _, sub in self])

    def first(self):
        return self._stack_results([sub.isel({self._dim: 0})
                                    for _, sub in self])

    def last(self):
        return self._stack_results([sub.isel({self._dim: -1})
                                    for _, sub in self])

    def __getattr__(self, name):
        if name in self._REDUCERS:
            def method(**kwargs):
                return self._reduce(name, **kwargs)
            method.__name__ = name
            return method
        raise AttributeError(name)


# offset aliases that pandas 3 spells otherwise
_FREQ_MODERNIZE = {'M': 'ME', 'Q': 'QE', 'A': 'YE', 'Y': 'YE', 'H': 'h',
                   'T': 'min', 'S': 's', 'AS': 'YS', 'BA': 'BYE'}
_TICKS = {'D': 86_400_000_000_000, 'h': 3_600_000_000_000,
          'min': 60_000_000_000, 's': 1_000_000_000, 'ms': 1_000_000,
          'us': 1_000, 'ns': 1}


def _month_index(d):
    """Months since 1970-01 of datetime64 values."""
    return d.astype('datetime64[M]').astype(np.int64)


def _from_month(m, end):
    """The first (or, with ``end``, last) day of month index ``m``."""
    start = np.asarray(m, np.int64).astype('datetime64[M]')
    if end:
        return (start + np.timedelta64(1, 'M')).astype('datetime64[D]') \
            - np.timedelta64(1, 'D')
    return start.astype('datetime64[D]')


def resample_bins(values, freq):
    """The bin label of every datetime64 value under ``freq``, as pandas'
    ``Series.resample(freq)`` labels them with its defaults: fixed
    frequencies ('nD', 'nh', 'nmin', 'ns', ...) count bins from midnight of
    the first day, closed and labelled left; 'nW' (weeks ending Sunday),
    'nME', 'nQE' (quarters ending in December) and 'nYE' are closed and
    labelled right, at midnight of the bin's last day; 'nMS', 'nQS' and
    'nYS' closed and labelled left. The older spellings 'M', 'Q', 'A',
    'Y', 'H', 'T', 'S', 'AS' are read as their modern aliases. Returns
    datetime64[ns] labels, one per value."""
    m = re.fullmatch(r'(\d*)([A-Za-z]+(?:-[A-Z]+)?)', str(freq).strip())
    if m is None:
        raise ValueError('invalid frequency %r' % (freq,))
    n = int(m.group(1) or 1)
    unit = _FREQ_MODERNIZE.get(m.group(2), m.group(2))
    unit = {'W-SUN': 'W', 'QE-DEC': 'QE', 'QS-JAN': 'QS', 'YE-DEC': 'YE',
            'YS-JAN': 'YS'}.get(unit, unit)
    if n < 1:
        raise ValueError('invalid frequency %r' % (freq,))
    t = np.asarray(values).astype('datetime64[ns]')
    first = t.min()
    if unit in _TICKS:
        step = n * _TICKS[unit]
        origin = first.astype('datetime64[D]').astype('datetime64[ns]')
        off = (t - origin).astype(np.int64)
        return origin + (off // step * step).astype('timedelta64[ns]')
    days = t.astype('datetime64[D]')
    if unit == 'W':
        d = _days(days)
        fd = _days(first.astype('datetime64[D]'))
        fdow = (fd + 3) % 7                         # Monday 0, Sunday 6
        # first - n weeks: on a Sunday n weeks back, else back to the
        # Sunday before and n - 1 weeks more
        e0 = fd - 7 * n if fdow == 6 else fd - (fdow + 1) - 7 * (n - 1)
        k = -((e0 - d) // (7 * n))                  # ceil((d - e0) / 7n)
        return (e0 + k * 7 * n).astype('datetime64[D]').astype(
            'datetime64[ns]')
    span = {'ME': 1, 'MS': 1, 'QE': 3, 'QS': 3, 'YE': 12, 'YS': 12}.get(unit)
    if span is None:
        raise ValueError('unsupported resample frequency %r' % (freq,))
    step = n * span
    mi = _month_index(days)
    fm = _month_index(first.astype('datetime64[D]'))
    if unit.endswith('S'):
        # roll back to the period start on or before the first value
        e0 = fm - (fm % span)
        lab = e0 + (mi - e0) // step * step
        return _from_month(lab, False).astype('datetime64[ns]')
    # first - n periods: roll back to the last period end strictly before
    # the first value, then n - 1 more
    fday = first.astype('datetime64[D]')
    last_m = fm - (fm % span) + span - 1            # period end month
    on_end = last_m == fm and fday == _from_month(fm, True)
    e0 = (last_m - span * n) if on_end else (last_m - span - span * (n - 1))
    k = -((e0 - mi) // step)                        # ceil((mi - e0) / step)
    return _from_month(e0 + k * step, True).astype('datetime64[ns]')


class Resample(GroupBy):
    """Time bins along a datetime dimension (bins and labels from
    :func:`resample_bins`); the output keeps the dimension's name. Empty
    bins are left out."""

    @classmethod
    def from_freq(cls, obj, dim, freq):
        if dim not in obj._coords:
            raise KeyError('no coordinate for dimension %r' % dim)
        values = obj._coords[dim].values
        if values.dtype.kind != 'M':
            raise TypeError('resample requires a datetime64 coordinate')
        bins = resample_bins(values, freq)
        labels, inverse = np.unique(bins, return_inverse=True)
        inverse = inverse.ravel()
        order = np.argsort(inverse, kind='stable')
        bounds = np.searchsorted(inverse[order], np.arange(1, len(labels)))
        indices = [i.astype(np.int64) for i in np.split(order, bounds)]
        flat = np.concatenate(indices) if indices else np.empty(0, int)
        return cls(obj, dim, labels.astype('datetime64[ns]'), indices, dim,
                   np.argsort(flat, kind='stable'))


def _pad_window(data, axis, before, after):
    """NaN-pad ``data`` along ``axis`` (integers promoted to float64;
    datetimes with NaT)."""
    if isinstance(data, torch.Tensor):
        if not (data.is_floating_point() or data.is_complex()):
            data = data.to(torch.float64)
        parts = []
        for width in (before, after):
            shape = list(data.shape)
            shape[axis] = width
            parts.append(torch.full(shape, float('nan'), dtype=data.dtype,
                                    device=data.device))
        return torch.cat([parts[0], data, parts[1]], dim=axis)
    if data.dtype.kind in 'mM':
        fill = np.asarray('NaT', dtype=data.dtype)
    else:
        fill = np.nan
        if data.dtype.kind not in 'fc':
            data = data.astype(np.float64)
    widths = [(0, 0)] * data.ndim
    widths[axis] = (before, after)
    if data.dtype.kind in 'mM':
        shape_lo = list(data.shape)
        shape_lo[axis] = before
        shape_hi = list(data.shape)
        shape_hi[axis] = after
        return np.concatenate([np.full(shape_lo, fill, data.dtype), data,
                               np.full(shape_hi, fill, data.dtype)], axis)
    return np.pad(data, widths, mode='constant', constant_values=fill)


class Rolling:
    """Fixed-length rolling windows along one dimension: ``construct``
    materialises the windows as a new last dimension (NaN-padded at the
    edges); the reductions reduce over it NaN-aware and blank positions
    with fewer than ``min_periods`` valid points (default: the window)."""

    def __init__(self, obj, dim, window, min_periods=None, center=False):
        if window < 1:
            raise ValueError('window must be >= 1')
        if min_periods is not None and not \
                1 <= int(min_periods) <= int(window):
            raise ValueError('min_periods %r must be in [1, window=%d]'
                             % (min_periods, int(window)))
        self._obj = obj
        self._dim = dim
        self._window = int(window)
        self._min_periods = int(window) if min_periods is None \
            else int(min_periods)
        self._center = bool(center)

    def _offsets(self):
        w = self._window
        before = w // 2 if self._center else w - 1
        return before, w - 1 - before

    def _each(self, fn):
        from .dataarray import Dataset
        if not isinstance(self._obj, Dataset):
            return fn(self._obj)
        ds = self._obj.copy(deep=False)
        for k in list(ds._variables):
            da = self._obj[k]
            if self._dim in da.dims:
                ds._variables[k] = fn(da).variable
        return ds

    def construct(self, window_dim='window'):
        """The windowed view: the same dims plus ``window_dim``."""
        return self._each(lambda da: self._construct_da(da, window_dim))

    def _construct_da(self, da, window_dim):
        from .dataarray import DataArray
        axis = da.dims.index(self._dim)
        n = da.shape[axis]
        before, after = self._offsets()
        padded = _pad_window(da.data, axis, before, after)
        slices = [padded[(slice(None),) * axis + (slice(j, j + n),)]
                  for j in range(self._window)]
        stacked = torch.stack(slices, dim=da.ndim) \
            if isinstance(padded, torch.Tensor) \
            else np.stack(slices, axis=da.ndim)
        return DataArray._from_parts(Variable(da.dims + (window_dim,),
                                              stacked),
                                     dict(da._coords), da.attrs, da.name)

    def _reduce_da(self, da, name, **kwargs):
        win = self._construct_da(da, '_rolling_window')
        counts = win.notnull().sum(dim='_rolling_window')
        if name == 'count':
            return counts.where(counts >= max(self._min_periods, 1))
        red = getattr(win, name)(dim='_rolling_window', **kwargs)
        if not isinstance(red.data, torch.Tensor):
            nat = np.asarray('NaT', dtype=red.data.dtype)
            return red._replace(np.where(to_numpy(counts.data)
                                         >= self._min_periods, red.data,
                                         nat))
        return red.where(counts >= self._min_periods)

    def _reduce(self, name, **kwargs):
        return self._each(lambda da: self._reduce_da(da, name, **kwargs))

    def mean(self, **kw):
        return self._reduce('mean', **kw)

    def sum(self, **kw):
        return self._reduce('sum', **kw)

    def std(self, **kw):
        return self._reduce('std', **kw)

    def var(self, **kw):
        return self._reduce('var', **kw)

    def min(self, **kw):
        return self._reduce('min', **kw)

    def max(self, **kw):
        return self._reduce('max', **kw)

    def median(self, **kw):
        return self._reduce('median', **kw)

    def count(self, **kw):
        return self._reduce('count', **kw)


_TORCH_REDUCE = {'mean': nanops.nanmean, 'sum': nanops.nansum,
                 'std': nanops.nanstd, 'var': nanops.nanvar,
                 'min': nanops.nanmin, 'max': nanops.nanmax,
                 'median': nanops.nanmedian}
_PLAIN_REDUCE = {'mean': torch.mean, 'sum': torch.sum,
                 'std': lambda x, dim: torch.std(x, dim=dim, correction=0),
                 'var': lambda x, dim: torch.var(x, dim=dim, correction=0),
                 'min': torch.amin, 'max': torch.amax,
                 'median': lambda x, dim: nanops.nanmedian(x, dim).masked_fill(
                     torch.isnan(x).any(dim), float('nan'))}


class Coarsen:
    """Block aggregation along one or more dimensions: each output element
    reduces one ``windows[dim]``-long block per coarsened dim.
    ``boundary`` 'exact' (default) raises on a remainder, 'trim' drops it
    from the ``side`` end, 'pad' NaN-pads to a whole block. Coordinates
    along coarsened dims reduce with ``coord_func`` ('mean' default;
    datetimes average in int64)."""

    _REDUCERS = ('mean', 'sum', 'std', 'var', 'min', 'max', 'median',
                 'count')

    def __init__(self, obj, windows, boundary='exact', side='left',
                 coord_func='mean'):
        if boundary not in ('exact', 'trim', 'pad'):
            raise ValueError("boundary must be 'exact', 'trim' or 'pad'")
        if side not in ('left', 'right'):
            raise ValueError("side must be 'left' or 'right'")
        windows = {d: int(w) for d, w in windows.items()}
        if any(w < 1 for w in windows.values()):
            raise ValueError('window sizes must be >= 1')
        sizes = obj.sizes
        for d in windows:
            if d not in sizes:
                raise ValueError('coarsen dimension %r not in object dims '
                                 '%r' % (d, tuple(sizes)))
            if boundary == 'exact' and sizes[d] % windows[d]:
                raise ValueError(
                    "size %d of dim %r is not divisible by window %d (use "
                    "boundary='trim' or 'pad')" % (sizes[d], d, windows[d]))
        self._obj = obj
        self._windows = windows
        self._boundary = boundary
        self._side = side
        self._coord_func = coord_func

    def _block_values(self, arr, dims):
        """``arr`` with every coarsened axis split into (blocks, window);
        returns (blocked, window axes)."""
        window_axes = []
        axis = 0
        for d in dims:
            if d not in self._windows:
                axis += 1
                continue
            w = self._windows[d]
            n = arr.shape[axis]
            rem = n % w
            if rem and self._boundary == 'trim':
                keep = slice(None, n - rem) if self._side == 'left' \
                    else slice(rem, None)
                arr = arr[(slice(None),) * axis + (keep,)]
                n -= rem
            elif rem:
                lo, hi = (0, w - rem) if self._side == 'left' \
                    else (w - rem, 0)
                arr = _pad_window(arr, axis, lo, hi)
                n += w - rem
            arr = arr.reshape(tuple(arr.shape[:axis]) + (n // w, w)
                              + tuple(arr.shape[axis + 1:]))
            window_axes.append(axis + 1)
            axis += 2
        return arr, tuple(window_axes)

    def _reduce_da(self, da, name, skipna=True):
        from .dataarray import DataArray, _var
        if not any(d in da.dims for d in self._windows):
            return da
        data = da.data
        blocked, axes = self._block_values(data, da.dims)
        if not isinstance(blocked, torch.Tensor):
            red = self._reduce_host(blocked, axes, name)
        elif name == 'count':
            if blocked.is_floating_point() or blocked.is_complex():
                red = (~torch.isnan(blocked)).sum(dim=axes)
            else:
                red = torch.full([s for i, s in enumerate(blocked.shape)
                                  if i not in axes],
                                 int(np.prod([blocked.shape[a]
                                              for a in axes])),
                                 dtype=torch.int64, device=blocked.device)
        else:
            fn = (_TORCH_REDUCE if skipna else _PLAIN_REDUCE)[name]
            red = fn(blocked if blocked.is_floating_point()
                     or name in ('min', 'max', 'sum')
                     else blocked.to(torch.float64), dim=axes)
        coords = {}
        for ck, cv in da._coords.items():
            if not any(d in self._windows for d in cv.dims):
                coords[ck] = cv
                continue
            coords[ck] = _var(cv.dims, self._coarsen_coord(cv.values,
                                                           cv.dims),
                              cv.attrs, da)
        return DataArray._from_parts(Variable(da.dims, red), coords,
                                     da.attrs, da.name)

    @staticmethod
    def _reduce_host(blocked, axes, name):
        """numpy blocks (datetimes, coordinates)."""
        if blocked.dtype.kind in 'mM':
            if name in ('min', 'max'):
                return getattr(np, name)(blocked, axis=axes)
            if name == 'count':
                return (~np.isnat(blocked)).sum(axis=axes)
            if name in ('mean', 'median'):
                base = np.where(np.isnat(blocked), np.nan,
                                blocked.astype('int64'))
                red = getattr(np, 'nan' + name)(base, axis=axes)
                return np.round(red).astype('int64').astype(blocked.dtype)
            raise TypeError('%s() is not defined for datetime blocks' % name)
        if name == 'count':
            return (~np.isnan(blocked)).sum(axis=axes)
        return getattr(np, 'nan' + name)(blocked, axis=axes)

    def _coarsen_coord(self, values, dims):
        blocked, axes = self._block_values(values, dims)
        fn = self._coord_func
        if values.dtype.kind == 'M':
            return self._reduce_host(blocked, axes,
                                     'mean' if fn in ('mean', 'median')
                                     else fn)
        if fn in ('first', 'last'):
            key = [slice(None)] * blocked.ndim
            for a in axes:
                key[a] = 0 if fn == 'first' else -1
            return blocked[tuple(key)]
        return self._reduce_host(blocked, axes, fn)

    def _reduce(self, name, skipna=True):
        from .dataarray import Dataset, _var
        if not isinstance(self._obj, Dataset):
            return self._reduce_da(self._obj, name, skipna)
        ds = self._obj
        out = ds.copy(deep=False)
        done = {}
        for k in list(out._variables):
            da = ds[k]
            sub = Coarsen(da, {d: w for d, w in self._windows.items()
                               if d in da.dims},
                          self._boundary, self._side, self._coord_func)
            red = sub._reduce_da(da, name, skipna)
            out._variables[k] = red.variable
            for ck, cv in red._coords.items():
                done.setdefault(ck, cv)
        for ck in list(out._coords):
            cv = out._coords[ck]
            if any(d in self._windows for d in cv.dims):
                out._coords[ck] = done[ck] if ck in done else _var(
                    cv.dims, self._coarsen_coord(cv.values, cv.dims),
                    cv.attrs, ds)
        return out

    def __getattr__(self, name):
        if name in self._REDUCERS:
            def reducer(skipna=True, **kw):
                if kw:
                    raise TypeError('coarsen reductions accept only skipna=, '
                                    'got %r' % sorted(kw))
                return self._reduce(name, skipna=skipna)
            return reducer
        raise AttributeError(name)


class Weighted:
    """Weighted reductions: ``weights`` is a DataArray without NaNs,
    broadcast against the object; with ``skipna`` (default) NaN data
    points and their weights drop out."""

    def __init__(self, obj, weights):
        from .dataarray import DataArray
        if not isinstance(weights, DataArray):
            raise TypeError('weights must be a DataArray')
        w = weights.data
        if isinstance(w, torch.Tensor) and (w.is_floating_point()
                                            or w.is_complex()) \
                and bool(torch.isnan(w).any()):
            raise ValueError('weights cannot contain NaN (mask or fill them '
                             'first)')
        self._obj = obj
        self._weights = weights

    def _apply(self, fn, dim, skipna):
        from .dataarray import Dataset, broadcast
        if isinstance(self._obj, Dataset):
            ds = self._obj
            return Dataset({k: fn(*broadcast(ds[k], self._weights), dim,
                                  skipna) for k in ds.data_vars},
                           attrs=dict(ds.attrs))
        return fn(*broadcast(self._obj, self._weights), dim, skipna)

    @staticmethod
    def _masked(x, w, skipna):
        if not skipna:
            return x * w, w
        return x.fillna(0) * w, w.where(x.notnull(), 0)

    def sum_of_weights(self, dim=None):
        def fn(x, w, dim, skipna):
            s = self._masked(x, w, True)[1].sum(dim)
            return s.where(s != 0)
        return self._apply(fn, dim, True)

    def sum(self, dim=None, skipna=True):
        def fn(x, w, dim, skipna):
            return self._masked(x, w, skipna)[0].sum(dim)
        return self._apply(fn, dim, skipna)

    def mean(self, dim=None, skipna=True):
        def fn(x, w, dim, skipna):
            xw, sw = self._masked(x, w, skipna)
            denom = sw.sum(dim)
            return xw.sum(dim) / denom.where(denom != 0)
        return self._apply(fn, dim, skipna)

    def var(self, dim=None, skipna=True):
        def fn(x, w, dim, skipna):
            xw, sw = self._masked(x, w, skipna)
            denom = sw.sum(dim)
            denom = denom.where(denom != 0)
            d2 = (x - xw.sum(dim) / denom) ** 2
            if skipna:
                d2 = d2.fillna(0)
            return (d2 * sw).sum(dim) / denom
        return self._apply(fn, dim, skipna)

    def std(self, dim=None, skipna=True):
        return self.var(dim, skipna) ** 0.5
