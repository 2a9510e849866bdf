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
Complex data follow numpy: a value is NaN if either part is; ``var``
and ``std`` are real (``|x - mean|^2``); ``min``, ``max``, their
``arg`` forms and the median order by the real parts, then the
imaginary ones (sorted on real keys: PyTorch sorts no complex tensor on
the card); ``nanquantile`` refuses complex data, as numpy's does. A
host numpy payload (datetime64, timedelta64) reduces with numpy's own
function and stays numpy: NaT is skipped where numpy skips it.
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


def _host(x):
    """A host numpy payload (datetime64, timedelta64): it reduces with
    numpy's own function, and a datetime never goes on the device."""
    return isinstance(x, np.ndarray)


def _csum(x, dim, keepdim=False):
    """Sum and count of the values of a complex tensor that have no NaN
    part (numpy's test for a complex NaN)."""
    nan = torch.isnan(x)
    s = torch.sum(x.masked_fill(nan, 0), dim=_axes(x, dim), keepdim=keepdim)
    return s, (~nan).sum(dim=_axes(x, dim), keepdim=keepdim)


def nanmean(x, dim=None, keepdim=False):
    if _host(x):
        return np.nanmean(x, axis=dim, keepdims=keepdim)
    if x.is_complex():
        s, cnt = _csum(x, dim, keepdim)
        return torch.complex(s.real / cnt, s.imag / cnt)
    return torch.nanmean(floating(x), dim=dim, keepdim=keepdim)


def nanvar(x, dim=None, ddof=0):
    if _host(x):
        return np.nanvar(x, axis=dim, ddof=ddof)
    x = floating(x)
    mean = nanmean(x, dim, keepdim=True)
    if x.is_complex():       # real, |x - mean|^2 as numpy
        dev = (x.real - mean.real) ** 2 + (x.imag - mean.imag) ** 2
    else:
        dev = (x - mean) ** 2
    dof = (~torch.isnan(x)).sum(dim=dim) - ddof
    # numpy and jnp give NaN where no degree of freedom is left
    return (torch.nansum(dev, dim=dim) / dof).masked_fill(dof <= 0,
                                                          float('nan'))


def nanstd(x, dim=None, ddof=0):
    if _host(x):
        return np.nanstd(x, axis=dim, ddof=ddof)
    return torch.sqrt(nanvar(x, dim, ddof))


def nansum(x, dim=None):
    if _host(x):
        return np.nansum(x, axis=dim)
    if x.is_complex():
        return _csum(x, dim)[0]
    if x.is_floating_point():
        return torch.nansum(x, dim=dim)
    return torch.sum(x, dim=dim)


def _lex_extreme(xt, largest):
    """numpy's complex maximum (``largest``) or minimum over the last
    axis: the real parts first, then the imaginary ones, values with a
    NaN part skipped. Returns the extreme (keepdim) and where it is."""
    nan = torch.isnan(xt)
    red = torch.amax if largest else torch.amin
    fill = float('-inf') if largest else float('inf')
    re = red(xt.real.masked_fill(nan, fill), dim=-1, keepdim=True)
    tie = ~nan & (xt.real == re)
    im = red(xt.imag.masked_fill(~tie, fill), dim=-1, keepdim=True)
    return torch.complex(re, im), tie & (xt.imag == im)


def _nanextreme(x, dim, fill, reduce, np_reduce):
    if _host(x):
        return np_reduce(x, axis=dim)
    if x.is_complex():
        xt = _to_last(x, dim)
        out = _lex_extreme(xt, reduce is torch.amax)[0][..., 0]
        return out.masked_fill(torch.isnan(xt).all(dim=-1),
                               complex(float('nan'), float('nan')))
    if dim is None:
        x, dim = x.reshape(-1), 0
    if not x.is_floating_point():
        return reduce(x, dim=dim)
    nan = torch.isnan(x)
    out = reduce(x.masked_fill(nan, fill), dim=dim)
    # an all-NaN slice gives NaN, as np.nanmin does
    return out.masked_fill(nan.all(dim=dim), float('nan'))


def nanmin(x, dim=None):
    return _nanextreme(x, dim, float('inf'), torch.amin, np.nanmin)


def nanmax(x, dim=None):
    return _nanextreme(x, dim, float('-inf'), torch.amax, np.nanmax)


def nanprod(x, dim=None):
    if _host(x):
        return np.nanprod(x, axis=dim)
    xt = _to_last(x, dim)
    if xt.is_floating_point() or xt.is_complex():
        xt = xt.masked_fill(torch.isnan(xt), 1)
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
    if _host(x):
        return np.nanquantile(x, q, axis=dim, method=method)
    if x.is_complex():
        raise TypeError('a must be an array of real numbers')   # numpy's
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


def _lex_order(xt):
    """The permutation that sorts the last axis of a complex tensor in
    numpy's order (real parts, then imaginary ones; a value with a NaN
    part last): three stable sorts of real keys, as PyTorch sorts no
    complex tensor on the card."""
    order = torch.sort(xt.imag, dim=-1, stable=True).indices
    for key in (xt.real, torch.isnan(xt).to(torch.uint8)):
        k = torch.gather(key, -1, order)
        order = torch.gather(order, -1,
                             torch.sort(k, dim=-1, stable=True).indices)
    return order


def nanmedian(x, dim=None):
    if _host(x):
        return np.nanmedian(x, axis=dim)
    if not x.is_complex():
        return nanquantile(x, 0.5, dim)
    # numpy: the middle value in complex order, or the mean of the two
    xt = _to_last(x, dim)
    srt = torch.gather(xt, -1, _lex_order(xt))
    cnt = (~torch.isnan(xt)).sum(-1, keepdim=True)
    a = torch.gather(srt, -1, ((cnt - 1) // 2).clamp(min=0))
    b = torch.gather(srt, -1, (cnt // 2).clamp(min=0))
    out = torch.complex((a.real + b.real) / 2, (a.imag + b.imag) / 2)
    return out.masked_fill(cnt == 0, complex(float('nan'),
                                             float('nan')))[..., 0]


def _nanarg(x, dim, fill, arg, np_arg):
    if _host(x):
        return np_arg(x, axis=dim[0] if isinstance(dim, tuple) else dim)
    if dim is None:
        x, dim = x.reshape(-1), 0
    if isinstance(dim, tuple):
        if len(dim) != 1:
            raise ValueError('argmin/argmax reduce one dimension')
        dim = dim[0]
    if x.dtype == torch.bool:               # torch has no bool argmin
        x = x.to(torch.uint8)
    if x.is_complex():
        xt = x.movedim(dim, -1)
        hit = _lex_extreme(xt, arg is torch.argmax)[1]
        out = hit.to(torch.uint8).argmax(dim=-1)     # the first one
        return out.masked_fill(torch.isnan(xt).all(dim=-1), -1)
    if not x.is_floating_point():
        return arg(x, dim=dim)
    nan = torch.isnan(x)
    out = arg(x.masked_fill(nan, fill), dim=dim)
    return out.masked_fill(nan.all(dim=dim), -1)


def nanargmin(x, dim=None):
    return _nanarg(x, dim, float('inf'), torch.argmin, np.nanargmin)


def nanargmax(x, dim=None):
    return _nanarg(x, dim, float('-inf'), torch.argmax, np.nanargmax)


def _truth(x):
    return x if x.dtype == torch.bool else x != 0


def all_(x, dim=None):
    if _host(x):
        return np.all(x, axis=dim)
    return torch.all(_to_last(_truth(x), dim), dim=-1)


def any_(x, dim=None):
    if _host(x):
        return np.any(x, axis=dim)
    return torch.any(_to_last(_truth(x), dim), dim=-1)


def nancumsum(x, dim):
    if _host(x):
        return np.nancumsum(x, axis=dim)
    if x.is_floating_point() or x.is_complex():
        x = x.masked_fill(torch.isnan(x), 0)
    return torch.cumsum(x, dim=dim)


def nancumprod(x, dim):
    if _host(x):
        return np.nancumprod(x, axis=dim)
    if x.is_floating_point() or x.is_complex():
        x = x.masked_fill(torch.isnan(x), 1)
    return torch.cumprod(x, dim=dim)
