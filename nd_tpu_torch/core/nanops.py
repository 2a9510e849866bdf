"""NumPy's NaN-skipping reductions and accumulations on tensors.

The JAX package reduces with ``jnp.nan*`` (numpy's semantics); these are
their PyTorch counterparts, each ``fn(x, dim=None | int | tuple)``:

  - ``nanmean``, ``nanvar``/``nanstd`` (ddof 0), ``nansum``, ``nanmin``/
    ``nanmax`` (NaN for an all-NaN slice), ``nanprod``;
  - ``nanquantile`` and ``nanmedian``: a sort along the reduced axes
    (NaN sorts last), a count of the valid values and numpy's 'linear',
    'lower', 'higher', 'midpoint' and 'nearest' methods written out.
    ``torch.quantile`` refuses inputs of more than 2**24 elements and
    ``torch.nanmedian`` returns the lower of two middle values, so
    neither is used;
  - ``nanargmin``/``nanargmax``: -1 for an all-NaN slice (as
    ``jnp.nanargmin``; numpy raises);
  - ``all_``/``any_``: numpy's truthiness (NaN is true);
  - ``nancumsum``/``nancumprod`` along one axis (NaN counts as 0 and 1).

Integer and bool data reduce in float64 where numpy's nanmean does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['nanmean', 'nanvar', 'nanstd', 'nansum', 'nanmin', 'nanmax',
           'nanprod', 'nanquantile', 'nanmedian', 'nanargmin', 'nanargmax',
           'all_', 'any_', 'nancumsum', 'nancumprod']


def floating(x):
    """Integer and bool data reduce in float64, as numpy's nanmean."""
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(torch.float64)


def _axes(x, dim):
    if dim is None:
        return tuple(range(x.ndim))
    if isinstance(dim, int):
        return (dim % x.ndim,)
    return tuple(int(d) % x.ndim for d in dim)


def _to_last(x, dim):
    """``x`` with the reduced axes moved last and flattened into one."""
    axes = _axes(x, dim)
    keep = [d for d in range(x.ndim) if d not in axes]
    xt = x.permute(*keep, *axes)
    return xt.reshape(tuple(x.shape[d] for d in keep) + (-1,))


def nanmean(x, dim=None):
    return torch.nanmean(floating(x), dim=dim)


def nanvar(x, dim=None, ddof=0):
    x = floating(x)
    dev = (x - torch.nanmean(x, dim=dim, keepdim=True)) ** 2
    dof = (~torch.isnan(x)).sum(dim=dim) - ddof
    # numpy and jnp give NaN where no degree of freedom is left
    return (torch.nansum(dev, dim=dim) / dof).masked_fill(dof <= 0,
                                                          float('nan'))


def nanstd(x, dim=None, ddof=0):
    return torch.sqrt(nanvar(x, dim, ddof))


def nansum(x, dim=None):
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


def nanmin(x, dim=None):
    return _nanextreme(x, dim, float('inf'), torch.amin)


def nanmax(x, dim=None):
    return _nanextreme(x, dim, float('-inf'), torch.amax)


def nanprod(x, dim=None):
    xt = _to_last(x, dim)
    if xt.is_floating_point():
        xt = torch.where(torch.isnan(xt), torch.ones((), dtype=xt.dtype,
                                                     device=xt.device), xt)
    return torch.prod(xt, dim=-1)


# numpy's methods that pick or interpolate between the two order
# statistics around the virtual index (q * (n - 1)); numpy's other
# methods (the H&F continuous ones) are not ported
QUANTILE_METHODS = ('linear', 'lower', 'higher', 'midpoint', 'nearest')


def nanquantile(x, q, dim=None, method='linear'):
    """numpy's ``nanquantile`` with ``method`` one of
    :data:`QUANTILE_METHODS`. A scalar ``q`` removes the reduced axes; a
    1-d ``q`` puts a new leading axis in front."""
    if method not in QUANTILE_METHODS:
        raise ValueError('quantile method %r is not supported (the port '
                         'has %s)' % (method, ', '.join(QUANTILE_METHODS)))
    x = floating(x)
    qa = np.asarray(q, np.float64)
    if qa.ndim > 1 or ((qa < 0) | (qa > 1)).any():
        raise ValueError('quantiles must be a scalar or a 1-d array in '
                         '[0, 1]')
    xt = _to_last(x, dim)
    srt = torch.sort(xt, dim=-1).values                # NaN sorts last
    cnt = (~torch.isnan(xt)).sum(-1, keepdim=True)
    last = (cnt - 1).clamp(min=0)
    outs = []
    for qi in np.atleast_1d(qa).tolist():
        pos = (cnt - 1).to(torch.float64) * qi         # the virtual index
        if method in ('lower', 'higher', 'nearest'):
            idx = {'lower': torch.floor, 'higher': torch.ceil,
                   'nearest': torch.round}[method](pos)   # half to even
            out = torch.gather(srt, -1, idx.clamp(min=0).to(torch.int64))
        else:
            lo = pos.floor().clamp(min=0).to(torch.int64)
            hi = torch.minimum(lo + 1, last)
            t = (pos - lo).to(x.dtype)
            if method == 'midpoint':
                t = torch.where(t > 0, 0.5, 0.0).to(x.dtype)
            a = torch.gather(srt, -1, lo)
            b = torch.gather(srt, -1, hi)
            d = b - a
            out = torch.where(t >= 0.5, b - d * (1 - t), a + d * t)
        out = out.masked_fill(cnt == 0, float('nan'))
        outs.append(out[..., 0])
    if qa.ndim == 0:
        return outs[0]
    return torch.stack(outs)


def nanmedian(x, dim=None):
    return nanquantile(x, 0.5, dim)


def _nanarg(x, dim, fill, arg):
    if dim is None:
        x, dim = x.reshape(-1), 0
    if isinstance(dim, tuple):
        if len(dim) != 1:
            raise ValueError('argmin/argmax reduce one dimension')
        dim = dim[0]
    if not x.is_floating_point():
        return arg(x, dim=dim)
    nan = torch.isnan(x)
    out = arg(x.masked_fill(nan, fill), dim=dim)
    return out.masked_fill(nan.all(dim=dim), -1)


def nanargmin(x, dim=None):
    return _nanarg(x, dim, float('inf'), torch.argmin)


def nanargmax(x, dim=None):
    return _nanarg(x, dim, float('-inf'), torch.argmax)


def _truth(x):
    return x if x.dtype == torch.bool else x != 0


def all_(x, dim=None):
    return torch.all(_to_last(_truth(x), dim), dim=-1)


def any_(x, dim=None):
    return torch.any(_to_last(_truth(x), dim), dim=-1)


def nancumsum(x, dim):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.zeros((), dtype=x.dtype,
                                                    device=x.device), x)
    return torch.cumsum(x, dim=dim)


def nancumprod(x, dim):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones((), dtype=x.dtype,
                                                   device=x.device), x)
    return torch.cumprod(x, dim=dim)
