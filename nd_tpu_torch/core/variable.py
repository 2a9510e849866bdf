"""Low-level n-dimensional variable: (dims, data, attrs).

Counterpart of ``nd_tpu/core/variable.py``. A ``Variable`` pairs a
``torch.Tensor`` with named dimensions. Numeric numpy input becomes a
tensor on the card (``cuda``) unless the caller names another ``device``,
as the JAX package puts such input on its default device, the
accelerator; non-numeric coordinate arrays (datetimes, strings) stay
numpy. A tensor stays on the device its caller put it on, and
``.values`` is the only API that copies to the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['Variable', 'as_array', 'as_tensor', 'torch_dtype']

DEFAULT_DEVICE = 'cuda'


def torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def as_tensor(data, device=None):
    """``data`` as a tensor: a tensor stays on its device; anything else
    (numpy, scalars, lists) lands on ``device``, by default ``cuda``.
    There is no check for a card: without one the default raises
    PyTorch's own error, and nothing falls back to the CPU."""
    if isinstance(data, torch.Tensor):
        return data
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if device.type == 'cpu' and isinstance(data, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(data))   # no copy
    return torch.as_tensor(np.asarray(data), device=device)


def as_array(data, device=None):
    """Coerce input to a tensor (numeric data, on ``device``: see
    :func:`as_tensor`) or a numpy array (other data), without copying
    tensors."""
    if isinstance(data, torch.Tensor):
        return data
    if isinstance(data, Variable):
        return data.data
    arr = np.asarray(data)
    if arr.dtype.kind in 'biufc':
        return as_tensor(arr, device)
    if arr.dtype == object:
        try:
            arr = np.asarray(data, dtype='datetime64[ns]')
        except (ValueError, TypeError):
            arr = np.asarray([str(x) for x in arr.ravel()]).reshape(arr.shape)
    return arr


def to_numpy(data):
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class Variable:
    """A named-dimension array (no coordinates).

    Parameters
    ----------
    dims : tuple of str
    data : torch.Tensor or array-like
    attrs : dict, optional
    device : torch.device or str, optional
        Where numeric non-tensor ``data`` lands (default ``cuda``).
    """

    __slots__ = ('dims', 'data', 'attrs')

    def __init__(self, dims, data, attrs=None, device=None):
        if isinstance(dims, str):
            dims = (dims,)
        data = as_array(data, device)
        dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError('dimensions %r do not match array of shape %r'
                             % (dims, tuple(data.shape)))
        self.dims = dims
        self.data = data
        self.attrs = dict(attrs) if attrs else {}

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def values(self):
        """Host numpy copy of the data."""
        return to_numpy(self.data)

    def astype(self, dtype):
        return Variable(self.dims, self.data.to(torch_dtype(dtype)),
                        self.attrs)

    def copy(self, deep=True):
        data = self.data
        if deep:
            data = data.clone() if isinstance(data, torch.Tensor) \
                else data.copy()
        return Variable(self.dims, data, dict(self.attrs))

    def transpose(self, *dims):
        if not dims:
            dims = self.dims[::-1]
        if set(dims) != set(self.dims):
            raise ValueError('transpose dims %r != variable dims %r'
                             % (dims, self.dims))
        order = [self.dims.index(d) for d in dims]
        data = self.data.permute(*order) \
            if isinstance(self.data, torch.Tensor) \
            else np.transpose(self.data, order)
        return Variable(dims, data, self.attrs)

    def broadcast_to(self, target_dims, target_shape):
        missing = [d for d in target_dims if d not in self.dims]
        data = self.data.reshape(tuple(self.data.shape) + (1,) * len(missing))
        dims = self.dims + tuple(missing)
        order = [dims.index(d) for d in target_dims]
        if isinstance(data, torch.Tensor):
            return Variable(tuple(target_dims),
                            data.permute(*order).expand(*target_shape),
                            self.attrs)
        return Variable(tuple(target_dims),
                        np.broadcast_to(np.transpose(data, order),
                                        tuple(target_shape)), self.attrs)

    def __repr__(self):
        return '<nd_tpu_torch.Variable %r %s %s>' % (
            self.dims, self.shape, self.dtype)
