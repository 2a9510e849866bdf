"""Low-level n-dimensional variable: (dims, data, attrs).

Counterpart of ``nd_tpu/core/variable.py``. A ``Variable`` pairs a
``torch.Tensor`` with named dimensions. Numeric numpy input becomes a
tensor on the card (``cuda``) unless the caller names another ``device``,
as the JAX package puts such input on its default device, the
accelerator; non-numeric coordinate arrays (datetimes, strings) stay
numpy. A tensor stays on the device its caller put it on, and
``.values`` is the only API that copies to the host.

A lazily read file view (``io.lazy.LazyArray``, from an open with
``chunks=``) stays a view: ``isel``, ``shape``, ``dtype``, ``sizes`` and
``nbytes`` read nothing, ``.values`` reads the selected slab into host
numpy, and the first access to ``.data`` (any computation) reads it onto
the variable's device, where the variable keeps it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ['Variable', 'as_array', 'as_tensor', 'torch_dtype',
           'is_lazy_array']

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
    if isinstance(data, np.ndarray) and not data.dtype.isnative:
        # tensors have the machine's byte order only (big-endian files)
        data = data.astype(data.dtype.newbyteorder('='))
    if device.type == 'cpu' and isinstance(data, np.ndarray):
        # no copy (np.ascontiguousarray would make a 0-d array 1-d)
        return torch.from_numpy(np.require(data, requirements='C'))
    return torch.as_tensor(np.asarray(data), device=device)


def is_lazy_array(x):
    """True for a lazily read file view (kept as it is, so that indexing
    reads only the slab it touches)."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return False
    from ..io.lazy import LazyArray
    return isinstance(x, LazyArray)


def as_array(data, device=None):
    """Coerce input to a tensor (numeric data, on ``device``: see
    :func:`as_tensor`) or a numpy array (other data), without copying
    tensors. A lazy file view stays a view."""
    if isinstance(data, torch.Tensor) or is_lazy_array(data):
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


def _expand_dims_to(data, dims, target_dims):
    """Reshape+permute ``data`` with ``dims`` to cover ``target_dims``
    (size-1 axes where ``dims`` lacks one)."""
    missing = [d for d in target_dims if d not in dims]
    if missing:
        data = data.reshape(tuple(data.shape) + (1,) * len(missing))
        dims = tuple(dims) + tuple(missing)
    order = [dims.index(d) for d in target_dims]
    if order != list(range(len(order))):
        data = data.permute(*order) if isinstance(data, torch.Tensor) \
            else np.transpose(data, order)
    return data


def _operand(value, like):
    """A numpy array as a tensor on ``like``'s device (scalars and
    tensors pass through)."""
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=like.device)
    return value


def to_numpy(data):
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


# -- numpy's type promotion ---------------------------------------------------
_SKIP = object()


def _strong_dtype(v):
    """The torch dtype of an operand whose type decides the result (a
    tensor, a numeric numpy array or scalar); None for a Python number,
    which is weak (NEP 50); ``_SKIP`` for anything else."""
    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(v, (np.ndarray, np.generic)):
        return torch_dtype(v.dtype) if v.dtype.kind in 'biufc' else _SKIP
    if isinstance(v, (bool, int, float, complex)):
        return None
    return _SKIP


@functools.lru_cache(maxsize=None)          # over pairs of dtypes: small
def _strong_result(da, db):
    """numpy's result dtype of two torch dtypes (PyTorch's where one has
    no numpy twin: bfloat16, complex32)."""
    if da == db:
        return da
    try:
        na, nb = (torch.empty((), dtype=d).numpy().dtype for d in (da, db))
    except TypeError:
        return torch.promote_types(da, db)
    return torch_dtype(np.result_type(na, nb))


def _weak_result(dtype, scalar):
    """numpy 2's result dtype of an array of ``dtype`` and a Python
    ``scalar``: the scalar's kind counts, its precision does not."""
    exact = dtype == torch.bool or not (dtype.is_floating_point
                                        or dtype.is_complex)
    if isinstance(scalar, bool):
        return dtype
    if isinstance(scalar, int):
        return torch.int64 if dtype == torch.bool else dtype
    if isinstance(scalar, float):
        return torch.float64 if exact else dtype
    if dtype.is_complex:
        return dtype
    return torch.complex128 if exact or dtype == torch.float64 \
        else torch.complex64


def result_dtype(a, b):
    """numpy 2's ``np.result_type`` of two operands, as a torch dtype:
    tensors and numpy values by their dtype, Python numbers weakly
    (int32 + 1.5 and int32 + float32 are float64, float32 + 1.5 and
    int16 + float32 float32, int32 + 2 int32). None where numpy's rule
    does not apply (two Python numbers, datetimes, other objects)."""
    da, db = _strong_dtype(a), _strong_dtype(b)
    if da is _SKIP or db is _SKIP or (da is None and db is None):
        return None
    if da is None or db is None:
        return _weak_result(da if db is None else db, b if db is None else a)
    return _strong_result(da, db)


def promote(a, b, true_divide=False):
    """``a`` and ``b`` with their tensors cast to :func:`result_dtype`
    (Python numbers stay weak); ``true_divide`` gives an integer or bool
    result float64, as numpy's true division."""
    dtype = result_dtype(a, b)
    if dtype is None:
        return a, b
    if true_divide and not (dtype.is_floating_point or dtype.is_complex):
        dtype = torch.float64

    def cast(v):
        if isinstance(v, torch.Tensor) and v.dtype != dtype:
            return v.to(dtype)
        if isinstance(v, bool) and dtype != torch.bool:
            return int(v)          # PyTorch takes a bool as a bool tensor
        return v
    return cast(a), cast(b)


def _parts(v):
    """The real and imaginary parts of a complex tensor or a number."""
    v = v if isinstance(v, torch.Tensor) else complex(v)
    return v.real, v.imag


def _by_parts(a, b, op):
    """``op`` on complex operands part by part, as numpy adds and
    subtracts (PyTorch scales the second operand by a complex 1 first,
    so a NaN in one part spreads to both)."""
    (ar, ai), (br, bi) = _parts(a), _parts(b)
    return torch.complex(op(ar, br), op(ai, bi))


def _is_complex(v):
    return v.is_complex() if isinstance(v, torch.Tensor) \
        else isinstance(v, (complex, np.complexfloating))


def add(a, b):
    """``a + b`` with numpy's promotion, complex part by part."""
    a, b = promote(a, b)
    if _is_complex(a) or _is_complex(b):
        return _by_parts(a, b, lambda x, y: x + y)
    return a + b


def sub(a, b):
    """``a - b`` with numpy's promotion, complex part by part."""
    a, b = promote(a, b)
    if _is_complex(a) or _is_complex(b):
        return _by_parts(a, b, lambda x, y: x - y)
    return a - b


def truediv(a, b):
    """``a / b`` with numpy's promotion; integer and bool operands
    divide in float64, as numpy."""
    a, b = promote(a, b, true_divide=True)
    return a / b


def _lex(a, b, strict):
    """numpy's order of complex numbers: the real parts, then the
    imaginary ones; a NaN part compares false."""
    like = a if isinstance(a, torch.Tensor) else b
    a, b = (v if isinstance(v, torch.Tensor) else
            torch.as_tensor(v, dtype=like.dtype, device=like.device)
            for v in (a, b))
    (ar, ai), (br, bi) = _parts(a), _parts(b)
    ordered = (ar < br) & ~torch.isnan(ai) & ~torch.isnan(bi)
    return ordered | ((ar == br) & ((ai < bi) if strict else (ai <= bi)))


def less(a, b):
    """``a < b`` with numpy's promotion and order of complex numbers."""
    a, b = promote(a, b)
    return _lex(a, b, True) if _is_complex(a) or _is_complex(b) else a < b


def less_equal(a, b):
    """``a <= b`` with numpy's promotion and order of complex numbers."""
    a, b = promote(a, b)
    return _lex(a, b, False) if _is_complex(a) or _is_complex(b) \
        else a <= b


# unsigned dtypes PyTorch stores but has no arithmetic for: an operation
# runs in the wider signed dtype and a result of that dtype is narrowed
# back, wrapping as numpy's
_WIDER = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def _apply(op, a, b):
    """``op(a, b)`` on operands cast to numpy's result dtype."""
    a, b = promote(a, b)
    narrow = next((v.dtype for v in (a, b) if isinstance(v, torch.Tensor)),
                  None)
    wide = _WIDER.get(narrow)
    if wide is None:
        return op(a, b)
    out = op(*(v.to(wide) if isinstance(v, torch.Tensor) else v
               for v in (a, b)))
    return out.to(narrow) if out.dtype == wide else out


class Variable:
    """A named-dimension array (no coordinates).

    Parameters
    ----------
    dims : tuple of str
    data : torch.Tensor, array-like or a lazy file view
    attrs : dict, optional
    device : torch.device or str, optional
        Where numeric non-tensor ``data`` lands (default ``cuda``); for a
        lazy view, where it lands when it is read.
    """

    __slots__ = ('dims', '_data', 'attrs', '_device')

    def __init__(self, dims, data, attrs=None, device=None):
        if isinstance(dims, str):
            dims = (dims,)
        data = as_array(data, device)
        dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError('dimensions %r do not match array of shape %r'
                             % (dims, tuple(data.shape)))
        self.dims = dims
        self._data = data
        self._device = device
        self.attrs = dict(attrs) if attrs else {}

    @property
    def data(self):
        """The payload; a lazy view is read onto the variable's device
        here, once, and kept."""
        data = self._data
        if is_lazy_array(data):
            data = as_array(data.values, self._device)
            self._data = data
        return data

    @property
    def is_lazy(self):
        """True while the payload is a lazy file view not yet read."""
        return is_lazy_array(self._data)

    @property
    def device(self):
        """The device of a tensor payload, or the one a lazy numeric
        view will be read onto; None for host numpy."""
        data = self._data
        if isinstance(data, torch.Tensor):
            return data.device
        if is_lazy_array(data) and data.dtype.kind in 'biufc':
            return torch.device(DEFAULT_DEVICE if self._device is None
                                else self._device)
        return None

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def dtype(self):
        data = self._data
        if is_lazy_array(data) and data.dtype.kind in 'biufc':
            return torch_dtype(data.dtype)       # the dtype once read
        return data.dtype

    @property
    def size(self):
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def nbytes(self):
        data = self._data
        if isinstance(data, torch.Tensor):
            return data.numel() * data.element_size()
        return data.nbytes

    @property
    def sizes(self):
        return dict(zip(self.dims, self.shape))

    @property
    def values(self):
        """Host numpy copy of the data (a lazy view reads its slab into
        host memory, never through the device)."""
        if is_lazy_array(self._data):
            return self._data.values
        return to_numpy(self.data)

    def astype(self, dtype):
        return Variable(self.dims, self.data.to(torch_dtype(dtype)),
                        self.attrs)

    def copy(self, deep=True):
        data = self._data
        if deep and not is_lazy_array(data):        # views are read-only
            data = data.clone() if isinstance(data, torch.Tensor) \
                else data.copy()
        return Variable(self.dims, data, dict(self.attrs), self._device)

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

    def isel(self, indexers):
        """Integer, slice and array indexing by dimension name (one array
        indexer at most; boolean arrays select their true positions).
        Slices with a negative step and array indexers gather by index on
        the data's device, after the basic indexing, so that an array
        indexer never moves its axis."""
        key = []
        new_dims = []
        adv = {}
        for d, n in zip(self.dims, self.shape):
            if d not in indexers:
                key.append(slice(None))
                new_dims.append(d)
                continue
            idx = indexers[d]
            if isinstance(idx, slice) and (idx.step or 1) > 0:
                key.append(idx)
                new_dims.append(d)
            elif isinstance(idx, slice):
                key.append(slice(None))
                new_dims.append(d)
                adv[d] = np.ascontiguousarray(np.arange(n)[idx])
            elif np.isscalar(idx) or np.ndim(to_numpy(idx)) == 0:
                i = int(to_numpy(idx))
                if not -n <= i < n:
                    raise IndexError('index %d is out of bounds for dim %r '
                                     'of size %d' % (i, d, n))
                key.append(i)
            else:
                idx = to_numpy(idx)
                if idx.dtype == bool:
                    idx = np.nonzero(idx)[0]
                idx = idx.astype(np.int64)
                if idx.size and (idx.min() < -n or idx.max() >= n):
                    raise IndexError('index out of bounds for dim %r of '
                                     'size %d' % (d, n))
                key.append(slice(None))
                new_dims.append(d)
                adv[d] = np.where(idx < 0, idx + n, idx)
        if len(adv) > 1:
            raise NotImplementedError(
                'fancy indexing over multiple dims is not supported')
        data = self._data[tuple(key)]       # a lazy view stays lazy
        if adv and is_lazy_array(data):
            data = as_array(data.values, self._device)
        for d, idx in adv.items():
            axis = new_dims.index(d)
            if isinstance(data, torch.Tensor):
                data = data.index_select(
                    axis, torch.as_tensor(idx, device=data.device))
            else:
                data = np.take(data, idx, axis=axis)
        return Variable(tuple(new_dims), data, self.attrs, self._device)

    def rename_dims(self, mapping):
        return Variable(tuple(mapping.get(d, d) for d in self.dims),
                        self._data, self.attrs, self._device)

    def squeeze(self, dim=None):
        if dim is not None and dim not in self.dims:
            raise KeyError('cannot squeeze unknown dim %r (dims %r)'
                           % (dim, self.dims))
        dims = []
        key = []
        for d, s in zip(self.dims, self.shape):
            if (dim is None and s == 1) or d == dim:
                if s != 1:
                    raise ValueError('cannot squeeze dim %r of size %d'
                                     % (d, s))
                key.append(0)
            else:
                key.append(slice(None))
                dims.append(d)
        return Variable(tuple(dims), self.data[tuple(key)], self.attrs)

    def expand_dims(self, dim, axis=0):
        # a negative axis appends as in numpy (-1 is the end), where
        # list.insert(-1, ...) would insert before the last entry
        if axis < 0:
            axis = self.ndim + 1 + axis
        data = self.data.unsqueeze(axis) \
            if isinstance(self.data, torch.Tensor) \
            else np.expand_dims(self.data, axis)
        dims = list(self.dims)
        dims.insert(axis, dim)
        return Variable(tuple(dims), data, self.attrs)

    def broadcast_to(self, target_dims, target_shape):
        data = _expand_dims_to(self.data, self.dims, target_dims)
        data = data.expand(tuple(target_shape)) \
            if isinstance(data, torch.Tensor) \
            else np.broadcast_to(data, tuple(target_shape))
        return Variable(tuple(target_dims), data, self.attrs)

    # -- arithmetic ---------------------------------------------------------
    def _binary_op(self, other, op, reflexive=False):
        """``op`` elementwise, on operands cast to numpy's result dtype
        (:func:`promote`); against a Variable aligned by dimension name
        (the union of dims, self's first; size-1 axes broadcast)."""
        if isinstance(other, Variable):
            out_dims = list(self.dims)
            for d in other.dims:
                if d not in out_dims:
                    out_dims.append(d)
            sizes = dict(zip(self.dims, self.shape))
            for d, s in zip(other.dims, other.shape):
                if sizes.get(d, s) not in (s, 1) and s != 1:
                    raise ValueError('conflicting size for dim %r' % d)
            a = _expand_dims_to(self.data, self.dims, out_dims)
            b = _expand_dims_to(other.data, other.dims, out_dims)
        else:
            out_dims, a, b = self.dims, self.data, _operand(other,
                                                            self.data)
        data = _apply(op, b, a) if reflexive else _apply(op, a, b)
        return Variable(tuple(out_dims), data)

    # -- reductions ----------------------------------------------------------
    def reduce(self, func, dim=None, **kwargs):
        """``func(data, axis=axes, **kwargs)`` over the named dims (all
        of them for ``None``), as numpy's reducers take it; ``axes`` is
        None, an int or a tuple. A result that is not a tensor lands on
        the data's device."""
        axes, dims = self._reduction_axes(dim)
        return self._reduced(func(self.data, axis=axes, **kwargs), dims)

    def _reduce(self, func, dim=None, **kwargs):
        """The port's own reducers (``core.nanops``): ``func(data,
        dim=axes)``."""
        axes, dims = self._reduction_axes(dim)
        return self._reduced(func(self.data, dim=axes, **kwargs), dims)

    def _reduction_axes(self, dim):
        """(axes, the dims that remain) of a reduction over ``dim``."""
        if dim is None:
            return None, ()
        if isinstance(dim, str):
            dim = (dim,)
        axes = tuple(self.dims.index(d) for d in dim)
        return (axes[0] if len(axes) == 1 else axes,
                tuple(d for d in self.dims if d not in dim))

    def _reduced(self, data, dims):
        if not isinstance(data, torch.Tensor):
            # a host payload's numeric result (an index, a truth value)
            # stays on the host
            device = self.data.device \
                if isinstance(self.data, torch.Tensor) else 'cpu'
            data = as_array(data, device)
        # keepdims-style reducers preserve rank; otherwise trust `dims`
        if data.ndim == self.ndim:
            dims = self.dims
        elif data.ndim != len(dims):
            raise ValueError('reduction produced rank %d, expected %d'
                             % (data.ndim, len(dims)))
        return Variable(dims, data)

    # scalar conversion (works on any size-1 array)
    def __bool__(self):
        return bool(self.values)

    def __float__(self):
        return float(self.values)

    def __int__(self):
        return int(self.values)

    def __complex__(self):
        return complex(self.values)

    def __repr__(self):
        return '<nd_tpu_torch.Variable %r %s %s>' % (
            self.dims, self.shape, self.dtype)
