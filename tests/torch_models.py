"""Twin cubes for the data-model parity tests: the same numpy values as
an nd_tpu object (numpy payload) and an nd_tpu_torch object (CPU
tensors), and the comparison of two results."""

import numpy as np
import torch

from nd_tpu.core import DataArray as JDataArray
from nd_tpu.core import Dataset as JDataset
from nd_tpu_torch.core import DataArray, Dataset


def cube_values(shape=(6, 5, 8), seed=0, nan_frac=0.15):
    rng = np.random.RandomState(seed)
    v = rng.rand(*shape) * 4 - 1
    v[rng.rand(*shape) < nan_frac] = np.nan
    return v


def coords(shape=(6, 5, 8)):
    ny, nx, nt = shape
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(nt) * np.timedelta64(6, 'D')
    return {'y': np.linspace(50.0, 45.0, ny), 'x': np.arange(nx) * 2.0 + 1,
            'time': times,
            'lat': (('y', 'x'), np.add.outer(np.arange(ny), np.arange(nx))
                    * 0.5)}


def pair_da(values=None, dims=('y', 'x', 'time'), crd=None, name='C11'):
    values = cube_values() if values is None else values
    crd = coords(values.shape) if crd is None else crd
    j = JDataArray(values.copy(), coords=crd, dims=dims, name=name)
    t = DataArray(torch.from_numpy(values.copy()), coords=crd, dims=dims,
                  name=name, device='cpu')
    return j, t


def pair_ds(shape=(6, 5, 8), names=('C11', 'C22'), seed=0):
    crd = coords(shape)
    vals = {n: cube_values(shape, seed + i) for i, n in enumerate(names)}
    j = JDataset({n: (('y', 'x', 'time'), v.copy())
                  for n, v in vals.items()}, coords=crd)
    t = Dataset({n: (('y', 'x', 'time'), torch.from_numpy(v.copy()))
                 for n, v in vals.items()}, coords=crd, device='cpu')
    return j, t


def _values(x):
    v = x.values if hasattr(x, 'values') and not isinstance(x, np.ndarray) \
        else x
    return np.asarray(v)


def same(got, ref, rtol=1e-12, atol=0.0, check_coords=True):
    """``got`` (nd_tpu_torch) against ``ref`` (nd_tpu): dims, values
    (NaN and NaT where NaN and NaT), coordinates, all on the CPU."""
    if isinstance(ref, JDataset):
        assert isinstance(got, Dataset)
        assert sorted(got.data_vars) == sorted(ref.data_vars)
        for v in ref.data_vars:
            same(got[v], ref[v], rtol, atol, check_coords)
        if check_coords:
            assert sorted(got.coords) == sorted(ref.coords)
        return
    if isinstance(ref, JDataArray):
        assert isinstance(got, DataArray), type(got)
        assert got.dims == ref.dims, (got.dims, ref.dims)
        if isinstance(got.data, torch.Tensor):
            assert got.data.device.type == 'cpu'
        if check_coords:
            assert sorted(got.coords) == sorted(ref.coords), \
                (sorted(got.coords), sorted(ref.coords))
            for c in ref.coords:
                same_array(got[c].values, np.asarray(ref[c].values), rtol,
                           atol)
    same_array(_values(got), _values(ref), rtol, atol)


def same_array(got, ref, rtol=1e-12, atol=0.0):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.dtype.kind in 'mM':
        np.testing.assert_array_equal(got, ref)
    elif ref.dtype.kind in 'fc':
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(got, ref)
