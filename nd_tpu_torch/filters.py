"""Noise-reduction filters over arbitrary dimension subsets.

Counterpart of ``nd_tpu/filters.py``: the ``Filter`` base,
``ConvolutionFilter`` (any kernel: separable ones through the
``sepconv`` kernel, the others through the ``stencil`` kernel),
``BoxcarFilter``, ``GaussianFilter`` and ``NLMeansFilter`` with the
functional wrappers ``convolution``, ``boxcar``, ``gaussian`` and
``nlmeans``, and ``_expand_kernel``. Tensors stay on the device the
caller put them on. ``apply(ds, njobs=n)`` splits along
``_parallel_dimension`` with the ``_buffer`` halo (see
``algorithm.parallelize``).
"""

from __future__ import annotations

from abc import abstractmethod

import numpy as np
import torch

from .algorithm import Algorithm, parallelize, wrap_algorithm
from .core import DataArray
from .core.variable import Variable
from .io import disassemble_complex
from .ops.conv import convolve as _convolve
from .ops.conv import gaussian_kernel1d, separable_convolve
from .ops.nlmeans import nlmeans as _nlmeans
from .tracing import span
from .utils import expand_variables, get_vars_for_dims, is_complex

__all__ = ['Filter', 'ConvolutionFilter', 'convolution', 'BoxcarFilter',
           'boxcar', 'GaussianFilter', 'gaussian', 'NLMeansFilter',
           'nlmeans', '_expand_kernel']


def _expand_kernel(kernel, kernel_dims, new_dims):
    """Reshape a kernel spanning ``kernel_dims`` to cover ``new_dims``
    (length-1 axes on the others). Raises ValueError if ``kernel_dims``
    does not match the kernel rank or is not a subset of ``new_dims``."""
    if not set(new_dims).issuperset(set(kernel_dims)):
        raise ValueError('`new_dims` must be a superset of `kernel_dims`.')
    if kernel.ndim != len(kernel_dims):
        raise ValueError('The length of `kernel_dims` must match the '
                         'dimension of `kernel`.')
    shape = np.ones(len(new_dims), dtype=int)
    shape[[new_dims.index(d) for d in kernel_dims]] = kernel.shape
    return kernel.reshape(shape)


class Filter(Algorithm):
    """Base class for a generic filter.

    Class attributes
    ----------------
    per_variable : bool
        If True the filter runs independently per variable; otherwise all
        variables jointly determine the filter weights.
    supports_complex : bool
        If False, complex variables are disassembled into re/im pairs
        before filtering (the result stays disassembled).
    dims : tuple of str
        The dimensions the filter operates over.
    """

    per_variable = True
    supports_complex = False
    dims = ()

    @abstractmethod
    def __init__(self, *args, **kwargs):
        return

    @parallelize
    def apply(self, ds, inplace=False):
        """
        Apply the filter to the input dataset.

        Parameters
        ----------
        ds : Dataset or DataArray
            The input dataset
        inplace : bool, optional
            If True, overwrite the input data inplace (default: False).

        Returns
        -------
        Dataset or DataArray
            The filtered dataset
        """
        if inplace:
            raise NotImplementedError('Inplace filtering is not '
                                      'implemented.')
        return self._apply_layout(ds, self._run)

    def _run(self, arr, dims):
        """Filter ``arr``, whose axes are named ``dims``, along
        ``self.dims``."""
        return self._filter(arr, tuple(dims.index(d) for d in self.dims))

    def _apply_layout(self, ds, run):
        """The layout of ``apply``: the tensors of ``ds`` are brought into
        the filter's layout and each goes through ``run(arr, dims)``
        (``dims`` names ``arr``'s axes; a stacking axis is named None).
        ``parallel.apply_sharded`` passes a runner that shards the call,
        so both paths give each kernel the same layout."""
        orig_dims = tuple(ds.sizes)
        ordered_dims = self.dims + tuple(d for d in orig_dims
                                         if d not in self.dims)

        if is_complex(ds) and not self.supports_complex:
            ds = disassemble_complex(ds)

        if isinstance(ds, DataArray):
            if self.per_variable:
                result = ds.copy(deep=False)
                result.data = run(ds.data, ds.dims)
            else:
                # joint-weight filters take the canonical layout
                # (filter dims..., extra dims..., variable)
                da_ordered = ds.transpose(*ordered_dims)
                filtered = run(da_ordered.data[..., None],
                               da_ordered.dims + ('variable',))[..., 0]
                result = da_ordered._replace(filtered).transpose(*ds.dims)
            return result

        variables = get_vars_for_dims(ds, self.dims)
        other_variables = get_vars_for_dims(ds, self.dims, invert=True)
        if self.per_variable:
            result = ds.copy(deep=False)
            # same-layout variables are stacked along a new leading
            # batch axis and filtered in one call
            groups = {}
            for v in variables:
                groups.setdefault((ds[v].dims, ds[v].dtype), []).append(v)
            for (vdims, _), vs in groups.items():
                if len(vs) == 1:
                    filtered = run(ds[vs[0]].data, vdims)
                    result._variables[vs[0]] = Variable(
                        vdims, filtered, ds[vs[0]].attrs)
                    continue
                with span('data.filter_stack'):
                    stacked = torch.stack([ds[v].data for v in vs])
                filtered = run(stacked, (None,) + tuple(vdims))
                for i, v in enumerate(vs):
                    result._variables[v] = Variable(vdims, filtered[i],
                                                    ds[v].attrs)
            return result

        # variables form an extra axis; weights are joint
        joint_dims = ordered_dims + ('variable',)
        with span('data.filter_to_array'):
            da_ordered = ds[variables].to_array().transpose(*joint_dims)
        filtered = run(da_ordered.data, da_ordered.dims)
        result = expand_variables(da_ordered._replace(filtered))
        for v in list(result._variables):
            have = result._variables[v].dims
            order = (tuple(d for d in ds[v].dims if d in have)
                     + tuple(d for d in have if d not in ds[v].dims))
            result._variables[v] = result._variables[v].transpose(*order)
        for v in other_variables:
            result._variables[v] = ds._variables[v]
        result.attrs.update(ds.attrs)
        for ck, cv in ds._coords.items():
            result._coords.setdefault(ck, cv)
        return result

    @abstractmethod
    def _filter(self, arr, axes):
        """Filter a tensor along ``axes``; returns the result."""
        return

    def _parallel_dimension(self, ds):
        """Split along the largest dimension not being filtered."""
        extra_dims = list(set(ds.sizes) - set(self.dims))
        if extra_dims:
            return sorted(extra_dims, key=lambda d: ds.sizes[d],
                          reverse=True)[0]
        return sorted(ds.sizes, key=lambda d: ds.sizes[d], reverse=True)[0]


class ConvolutionFilter(Filter):
    """Kernel convolution of a Dataset.

    Parameters
    ----------
    dims : tuple, optional
        The dataset dimensions corresponding to the kernel axes
        (default: ('y', 'x')). Length must match the kernel rank.
    kernel : ndarray
        The convolution kernel: a rank-1 (separable) kernel runs as 1-d
        passes, any other through the stencil kernel.
    kwargs : dict, optional
        Extra keyword arguments (``mode``, ``cval``) with
        scipy.ndimage.convolve semantics.
    """

    per_variable = True
    supports_complex = True
    kwargs = {}

    def __init__(self, dims=('y', 'x'), kernel=None, **kwargs):
        if kernel is None:
            kernel = np.ones([1] * len(dims))
        self.dims = tuple(dims)
        self.kernel = np.asarray(kernel)
        self.kwargs = kwargs

    def _buffer(self, dim):
        """Halo: half the kernel extent along the split dimension."""
        if dim not in self.dims:
            return 0
        return self.kernel.shape[self.dims.index(dim)] // 2

    def _filter(self, arr, axes):
        return _convolve(arr, self.kernel, axes=axes,
                         mode=self.kwargs.get('mode', 'reflect'),
                         cval=self.kwargs.get('cval', 0.0))


convolution = wrap_algorithm(ConvolutionFilter, 'convolution')


class BoxcarFilter(ConvolutionFilter):
    """Uniform moving-average filter: every tap weighs ``1/w**N``.

    Parameters
    ----------
    dims : tuple of str, optional
        Dimensions the window slides over (default: ('y', 'x')).
    w : int
        Window width per dimension; use an odd value so the window is
        centred on the output pixel.
    kwargs : dict, optional
        Edge-handling options (``mode``, ``cval``).
    """

    def __init__(self, dims=('y', 'x'), w=3, **kwargs):
        self.dims = tuple(dims)
        self.w = w
        self.kernel = np.ones((w,) * len(dims), dtype=np.float64) \
            / w ** len(dims)
        self.kwargs = kwargs


boxcar = wrap_algorithm(BoxcarFilter, 'boxcar')


class GaussianFilter(Filter):
    """A Gaussian filter (separable convolutions).

    Parameters
    ----------
    dims : tuple of str, optional
        The dimensions along which to apply the Gaussian filtering
        (default: ('y', 'x')).
    sigma : float or sequence of float
        Standard deviation for the Gaussian kernel, per dimension if a
        sequence.
    kwargs : dict, optional
        ``truncate`` (default 4.0), ``mode``, ``cval`` with scipy
        semantics.

    Returns
    -------
    Dataset
        The filtered dataset.
    """

    def __init__(self, dims=('y', 'x'), sigma=1, **kwargs):
        if isinstance(sigma, (int, float)):
            sigma = [sigma] * len(dims)
        self.dims = tuple(dims)
        self.sigma = list(sigma)
        self.kwargs = kwargs

    def _buffer(self, dim):
        """Halo: the truncated kernel radius (4 sigma by default)."""
        if dim not in self.dims:
            return 0
        sigma = self.sigma[self.dims.index(dim)]
        return int(self.kwargs.get('truncate', 4.0) * sigma + 0.5)

    def _filter(self, arr, axes):
        truncate = self.kwargs.get('truncate', 4.0)
        kernels = [gaussian_kernel1d(s, truncate) for s in self.sigma]
        return separable_convolve(arr, kernels, axes,
                                  self.kwargs.get('mode', 'reflect'),
                                  self.kwargs.get('cval', 0.0))


gaussian = wrap_algorithm(GaussianFilter, 'gaussian')


class NLMeansFilter(Filter):
    """Non-Local Means denoising (Buades et al. 2011).

    Buades, A., Coll, B., & Morel, J.-M. (2011). Non-Local Means
    Denoising. Image Processing On Line, 1, 208-212.

    Parameters
    ----------
    dims : tuple of str
        The dataset dimensions along which to filter (up to 3).
    r : int or sequence
        Neighborhood search radius (per dim if a sequence).
    sigma : float
        Noise standard deviation.
    h : float
        Filtering strength.
    f : int
        Patch radius.
    n_eff : float, optional
        Desired effective sample size, or -1 to disable (default: -1).
    """

    per_variable = False

    def __init__(self, dims=('y', 'x'), r=1, sigma=1, h=1, f=1, n_eff=-1):
        if isinstance(r, (int, float)):
            r = [r] * len(dims)
        self.dims = tuple(dims)
        self.r = np.array(r, dtype=np.uint32)
        self.f = np.array([f if _ > 0 else 0 for _ in self.r],
                          dtype=np.uint32)
        self.sigma = sigma
        self.h = h
        self.n_eff = n_eff

    def _buffer(self, dim):
        """Halo: r + f along split dimensions."""
        if dim not in self.dims:
            return 0
        axis = self.dims.index(dim)
        return int(self.r[axis] + self.f[axis])

    def _filter(self, arr, axes):
        # pad r and f to three dims (leading), as the 4-D
        # (d0, d1, d2, var) layout needs
        ndim = arr.ndim
        pad_before = np.zeros(4 - ndim, dtype=self.r.dtype)
        pad_after = np.zeros(ndim - len(self.r) - 1, dtype=self.r.dtype)
        r = np.concatenate([pad_before, self.r, pad_after])
        f = np.concatenate([pad_before, self.f, pad_after])
        values = arr.reshape((1,) * (4 - ndim) + tuple(arr.shape))
        if r[0] == 0 and f[0] == 0 and (r[1] > 0 or r[2] > 0):
            # filtered axes within (1, 2) (d0 is often a singleton from
            # the 4-D padding): rotate them to the front so the spatial
            # kernel takes them, d0 batched
            out = _nlmeans(values.permute(1, 2, 0, 3),
                           (int(r[1]), int(r[2]), 0),
                           (int(f[1]), int(f[2]), 0), self.sigma, self.h,
                           self.n_eff).permute(2, 0, 1, 3)
        else:
            out = _nlmeans(values, tuple(int(v) for v in r),
                           tuple(int(v) for v in f), self.sigma, self.h,
                           self.n_eff)
        return out.reshape(arr.shape)


nlmeans = wrap_algorithm(NLMeansFilter, 'nlmeans')
