"""Exact comparison of an nd_tpu_torch object with an nd_tpu object (or
two files' bytes) for the I/O parity tests: dims, coordinates, attrs
and dtypes equal, values bit-equal (NaN and NaT included)."""

import os

import numpy as np
import torch


def host(data):
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def same_array(got, want, what=''):
    """Bit-equal arrays of one dtype. Byte order is not compared: a
    tensor has the machine's only, where numpy may keep a file's."""
    a, b = host(got), host(want)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind in 'biufcM':
        assert a.dtype.newbyteorder('=') == b.dtype.newbyteorder('='), \
            (what, a.dtype, b.dtype)
        a = np.ascontiguousarray(a.astype(a.dtype.newbyteorder('=')))
        b = np.ascontiguousarray(b.astype(b.dtype.newbyteorder('=')))
        assert a.tobytes() == b.tobytes(), (what, a, b)
    else:
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, a, b)


def same_value(a, b):
    if isinstance(a, (np.ndarray, list, tuple)) or \
            isinstance(b, (np.ndarray, list, tuple)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b and type(a) is type(b)


def same_attrs(got, want, what=''):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in got:
        assert same_value(got[k], want[k]), (what, k, got[k], want[k])


def _var(obj, name, coord):
    return (obj._coords if coord else obj._variables)[name]


def same_dataset(got, want):
    """An nd_tpu_torch Dataset (or DataArray) equal to an nd_tpu one, or
    to another nd_tpu_torch one."""
    if hasattr(want, '_variables'):
        assert dict(got.sizes) == dict(want.sizes)
        assert set(got._variables) == set(want._variables)
        names = [(n, False) for n in want._variables]
    else:
        assert got.dims == want.dims and got.name == want.name
        same_array(got.data, want.data, 'data')
        names = []
    assert set(got._coords) == set(want._coords)
    same_attrs(got.attrs, want.attrs, 'attrs')
    for name, coord in names + [(n, True) for n in want._coords]:
        g, w = _var(got, name, coord), _var(want, name, coord)
        assert g.dims == w.dims, (name, g.dims, w.dims)
        same_array(g.data, w.data, name)
        same_attrs(g.attrs, w.attrs, name)


def tree_bytes(path):
    """{relative path: bytes} of a file or of every file under a
    directory."""
    if os.path.isfile(path):
        with open(path, 'rb') as fh:
            return {'': fh.read()}
    out = {}
    for root, _, files in os.walk(path):
        for fn in files:
            full = os.path.join(root, fn)
            with open(full, 'rb') as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out
