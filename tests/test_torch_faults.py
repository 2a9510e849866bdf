"""Faults F4-F8 of the port against nd_tpu, each held to nd_tpu on the
CPU: ``var``/``std`` with no degree of freedom left (F4), ``quantile``'s
``method`` (F5), ``reduce`` with numpy's ``axis=`` reducers (F6), the
names nd_tpu exports (F7) and the date forms ``str2date`` reads (F8)."""

import warnings

import numpy as np
import pytest
import torch

import nd_tpu
import nd_tpu.core
import nd_tpu_torch as ndt
import nd_tpu_torch.core
from nd_tpu import utils as jutils
from nd_tpu.ops import change as jchange
from nd_tpu.ops import conv as jconv
from nd_tpu_torch import utils as tutils
from torch_models import pair_ds, same


def _nan_series_pair():
    """Two variables; the all-NaN series and the one-valid-sample series
    are in the second, whose statistics the tests read."""
    j, t = pair_ds(shape=(4, 5, 8))
    for ds, wrap in ((j, np.asarray), (t, torch.from_numpy)):
        vals = np.array(ds['C22'].values)
        vals[0, 0, :] = np.nan
        vals[1, 2, 1:] = np.nan
        ds['C22'] = (('y', 'x', 'time'), wrap(vals))
    return j, t


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        return fn()


@pytest.mark.parametrize('name', ['std', 'var'])
@pytest.mark.parametrize('ddof', [1, 2])
def test_f4_no_degree_of_freedom_gives_nan(name, ddof):
    j, t = _nan_series_pair()
    got = getattr(t, name)('time', ddof=ddof)
    same(got, _quiet(lambda: getattr(j, name)('time', ddof=ddof)))
    assert np.isnan(got['C22'].values[0, 0])
    assert np.isnan(got['C22'].values[1, 2])


def test_f4_grouped_reduction_with_ddof():
    j, t = _nan_series_pair()
    got = t.groupby('time.month').std(ddof=1)
    same(got, _quiet(lambda: j.groupby('time.month').std(ddof=1)))
    assert np.isnan(got['C22'].values[..., 0][0, 0])


@pytest.mark.parametrize('method', ['linear', 'lower', 'higher',
                                    'midpoint', 'nearest'])
@pytest.mark.parametrize('q', [0.15, 0.5, [0.15, 0.85], [0.0, 0.3, 1.0]])
def test_f5_quantile_methods(method, q):
    j, t = pair_ds(shape=(4, 5, 8))
    for dim in ('time', ('y', 'x')):
        same(t['C11'].quantile(q, dim, method=method),
             _quiet(lambda: j['C11'].quantile(q, dim, method=method)))
    # nd_tpu's Dataset drops a vector q's 'quantile' coordinate, which
    # its DataArray keeps and the port keeps on both
    same(t.quantile(q, 'time', method=method),
         _quiet(lambda: j.quantile(q, 'time', method=method)),
         check_coords=np.ndim(q) == 0)


def test_f5_quantile_method_not_ported_raises_naming_it():
    _, t = pair_ds(shape=(4, 5, 8))
    for q in (0.5, [0.25, 0.5]):
        with pytest.raises(ValueError, match="'hazen'"):
            t['C11'].quantile(q, 'time', method='hazen')


@pytest.mark.parametrize('func', [np.nanmax, np.nanmean, np.nanstd])
def test_f6_reduce_passes_axis(func):
    j, t = pair_ds(shape=(4, 5, 8))
    for dim in ('time', ('y', 'x'), None):
        got = t['C11'].reduce(func, dim=dim)
        same(got, _quiet(lambda: j['C11'].reduce(func, dim=dim)))
        assert isinstance(got.data, torch.Tensor)
        assert got.data.device.type == 'cpu'
    same(t.reduce(func, dim='time'),
         _quiet(lambda: j.reduce(func, dim='time')))


def test_f6_torch_reducers_take_axis_too():
    j, t = pair_ds(shape=(4, 5, 8))
    same(t['C11'].fillna(0).reduce(torch.sum, 'time'),
         j['C11'].fillna(0).reduce(np.sum, 'time'))


def test_f7_exported_names():
    for name in nd_tpu.core.__all__:
        if name not in ('is_device_array', 'get_xp'):
            assert hasattr(nd_tpu_torch.core, name), name
            assert name in nd_tpu_torch.core.__all__, name
    for name in ('concat', 'merge', 'open_dataset', 'to_netcdf'):
        assert getattr(ndt, name) is not None and name in ndt.__all__
    assert 'uniform_sums' in ndt.ops.conv.__all__
    assert 'omnibus_z' in ndt.ops.change.__all__


def test_f7_uniform_sums():
    x = np.random.RandomState(3).randint(0, 50, (9, 8, 5)).astype(np.float64)
    for sizes, axes in (((3, 2), (0, 1)), ((4,), (2,)), ((2, 3, 2),
                                                        (0, 1, 2))):
        got = ndt.ops.conv.uniform_sums(x, sizes, axes, device='cpu')
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jconv.uniform_sums(x, sizes, axes)))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_f7_omnibus_z(dtype):
    from torch_cubes import sar_cube
    cube = sar_cube(1, 1, 12, seed=8, special=False)[0, 0].astype(dtype)
    got = ndt.ops.change.omnibus_z(cube, 9, device='cpu')
    want = np.asarray(jchange.omnibus_z(cube, 9))
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


@pytest.mark.parametrize('text', [
    '03-Jan-2023 10:00:00.000000', '03-Jan-2023 10:00:00', '03-JAN-2023',
    '2023/01/03', '2023/01/03 04:05:06', 'Jan 3 2023', 'Jan 03 2023',
    '1970-1-1', '1970-1-1 0:0:0', '2000-01-01 00:00:00 UTC',
    '2015-06-30T12:00:00Z', '2023-01-03T10:00:00.123456',
])
def test_f8_str2date_reads_what_nd_tpu_reads(text):
    assert tutils.str2date(text) == jutils.str2date(text)
    assert tutils.str2date(text, tz=True) == jutils.str2date(text, tz=True)


@pytest.mark.parametrize('text', ['03.01.2023', '03/01/2023', '3-1-23'])
def test_f8_ambiguous_dates_raise_saying_why(text):
    with pytest.raises(ValueError, match='either way round'):
        tutils.str2date(text)


def test_f8_unparseable_date_raises():
    with pytest.raises(ValueError, match='unrecognised date'):
        tutils.str2date('sometime in spring')
