"""Method-style accessor API on Dataset/DataArray: ``ds.nd.*`` and
``ds.filter.*``.

Counterpart of ``nd_tpu/accessors.py``: the namespaces are attached as
properties on :class:`nd_tpu_torch.core.Dataset` / :class:`DataArray`
when ``nd_tpu_torch`` is imported, and each method mirrors the
functional API (signature and docstring copied from the wrapped
function).
"""

from __future__ import annotations

import functools
import inspect

from .core import DataArray, Dataset

__all__ = ['NDAccessor', 'FilterAccessor', 'register_accessors']


def patch_doc(func):
    """Copy signature and docstring from the functional form onto an
    accessor method."""

    def decorator(method):
        @functools.wraps(method)
        def wrapper(self, *args, **kwargs):
            return method(self, *args, **kwargs)

        wrapper.__doc__ = func.__doc__
        sig = inspect.signature(func)
        params = list(sig.parameters.values())
        # drop the dataset argument: the accessor supplies it
        if params and params[0].name in ('ds', 'datasets', 'data'):
            params = params[1:]
        params.insert(0, inspect.Parameter(
            'self', inspect.Parameter.POSITIONAL_OR_KEYWORD))
        wrapper.__signature__ = sig.replace(parameters=params)
        return wrapper

    return decorator


class NDAccessor:
    """General datacube operations namespace (``ds.nd``)."""

    def __init__(self, obj):
        self._obj = obj

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        from .utils import get_shape
        return get_shape(self._obj)

    @property
    def dims(self):
        from .utils import get_dims
        return get_dims(self._obj)

    @property
    def crs(self):
        from .warp import get_crs
        return get_crs(self._obj)

    @property
    def bounds(self):
        from .warp import get_bounds
        return get_bounds(self._obj)

    @property
    def extent(self):
        from .warp import get_extent
        return get_extent(self._obj)

    @property
    def resolution(self):
        from .warp import get_resolution
        return get_resolution(self._obj)

    @property
    def transform(self):
        from .warp import get_transform
        return get_transform(self._obj)

    # -- methods --------------------------------------------------------------
    def as_complex(self, inplace=False):
        from .io import assemble_complex
        return assemble_complex(self._obj, inplace=inplace)

    def as_real(self, inplace=False):
        from .io import disassemble_complex
        return disassemble_complex(self._obj, inplace=inplace)

    def reproject(self, *args, **kwargs):
        from .warp import reproject
        return reproject(self._obj, *args, **kwargs)

    def resample(self, *args, **kwargs):
        from .warp import resample
        return resample(self._obj, *args, **kwargs)

    def coregister(self, *args, **kwargs):
        from .warp import coregister
        return coregister(self._obj, *args, **kwargs)

    def change_omnibus(self, *args, **kwargs):
        from .change import omnibus
        return omnibus(self._obj, *args, **kwargs)

    def apply(self, fn, signature=None, njobs=1):
        from .utils import apply
        return apply(self._obj, fn, signature=signature, njobs=njobs)

    def to_netcdf(self, path, *args, **kwargs):
        from .io import to_netcdf
        return to_netcdf(self._obj, path, *args, **kwargs)

    def tile(self, path, *args, **kwargs):
        from .tiling import tile
        return tile(self._obj, path, *args, **kwargs)

    def classify(self, clf, labels=None, **kwargs):
        from .classify import Classifier
        c = Classifier(clf, **kwargs)
        return c.fit_predict(self._obj, labels)

    def to_rgb(self, rgb=None, output=None, vmin=None, vmax=None,
               pmin=2, pmax=98, categorical=False, mask=None, shape=None,
               cmap=None):
        from .visualize import to_rgb
        if rgb is None and isinstance(self._obj, Dataset):
            def rgb(d):
                return [d['C11'], d['C22'], d['C11'] / d['C22']]
        # a user-supplied rgb callable applies to DataArrays too
        data = rgb(self._obj) if rgb is not None else self._obj
        return to_rgb(data, output=output, vmin=vmin, vmax=vmax,
                      pmin=pmin, pmax=pmax, categorical=categorical,
                      mask=mask, shape=shape, cmap=cmap)

    def to_video(self, path, *args, **kwargs):
        from .visualize import write_video
        return write_video(self._obj, path, *args, **kwargs)

    def plot_map(self, *args, **kwargs):
        from .visualize import plot_map
        return plot_map(self._obj, *args, **kwargs)


class FilterAccessor:
    """Noise-reduction filter namespace (``ds.filter``)."""

    def __init__(self, obj):
        self._obj = obj

    @property
    def values(self):
        return self._obj.values

    def nlmeans(self, *args, **kwargs):
        from .filters import nlmeans
        return nlmeans(self._obj, *args, **kwargs)

    def boxcar(self, *args, **kwargs):
        from .filters import boxcar
        return boxcar(self._obj, *args, **kwargs)

    def convolve(self, *args, **kwargs):
        from .filters import convolution
        return convolution(self._obj, *args, **kwargs)

    def gaussian(self, *args, **kwargs):
        from .filters import gaussian
        return gaussian(self._obj, *args, **kwargs)


def _accessor_property(cls):
    name = '_nd_cached_%s' % cls.__name__

    def getter(self):
        acc = getattr(self, name, None)
        if acc is None or acc._obj is not self:
            acc = cls(self)
            setattr(self, name, acc)
        return acc

    return property(getter, doc=cls.__doc__)


def _patch_accessor_docs():
    """Copy signatures/docstrings from the functional API onto the
    accessor methods."""
    from . import change, filters, io, utils, warp

    pairs = [
        (NDAccessor, 'reproject', warp.reproject),
        (NDAccessor, 'resample', warp.resample),
        (NDAccessor, 'coregister', warp.coregister),
        (NDAccessor, 'change_omnibus', change.omnibus),
        (NDAccessor, 'as_complex', io.assemble_complex),
        (NDAccessor, 'as_real', io.disassemble_complex),
        (NDAccessor, 'to_netcdf', io.to_netcdf),
        (NDAccessor, 'apply', utils.apply),
        (FilterAccessor, 'nlmeans', filters.nlmeans),
        (FilterAccessor, 'boxcar', filters.boxcar),
        (FilterAccessor, 'convolve', filters.convolution),
        (FilterAccessor, 'gaussian', filters.gaussian),
    ]
    for cls, name, func in pairs:
        method = getattr(cls, name)
        setattr(cls, name, patch_doc(func)(method))


def register_accessors():
    """Attach .nd and .filter namespaces to Dataset and DataArray."""
    _patch_accessor_docs()
    for holder in (Dataset, DataArray):
        holder.nd = _accessor_property(NDAccessor)
        holder.filter = _accessor_property(FilterAccessor)


register_accessors()
