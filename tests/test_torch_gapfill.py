"""Missing data and regridding: ``fillna``, ``ffill``/``bfill``,
``dropna``, ``interpolate_na`` and ``interp``/``interp_like`` of
nd_tpu_torch against nd_tpu on the same float64 cube with NaNs, a
descending ``y``, an uneven datetime ``time`` and a 2-D ``lat``.

Tolerances: fills move values and are exact; linear interpolation
agrees within rtol 1e-12, atol 1e-12 (the same formula; the weights
round alike). ``interpolate_na`` interpolates against the ``time``
coordinate's values (the uneven gaps below make that visible).
"""

import numpy as np
import pytest
import torch

from torch_models import coords, cube_values, pair_da, pair_ds, same


def _uneven():
    c = coords()
    c['time'] = np.datetime64('2023-01-03', 'ns') + np.array(
        [0, 6, 12, 30, 36, 42, 60, 66]) * np.timedelta64(1, 'D')
    vals = cube_values(nan_frac=0.3)
    vals[0, 0, :] = np.nan                  # an all-NaN series
    vals[1, 1, 2:7] = np.nan                # a long gap
    return pair_da(vals, crd=c)


CASES = {
    'fillna': lambda d: d.fillna(-1.0),
    'ffill': lambda d: d.ffill('time'),
    'ffill_limit': lambda d: d.ffill('time', limit=2),
    'bfill': lambda d: d.bfill('time'),
    'bfill_limit_x': lambda d: d.bfill('x', limit=1),
    'dropna_any': lambda d: d.dropna('x', how='any'),
    'dropna_all': lambda d: d.where(d['x'] < 6).dropna('x', how='all'),
    'dropna_thresh': lambda d: d.dropna('time', thresh=20),
    'interpolate_na': lambda d: d.interpolate_na(dim='time'),
    'interpolate_na_limit': lambda d: d.interpolate_na(dim='time', limit=2),
    'interpolate_na_max_gap': lambda d: d.interpolate_na(
        dim='time', max_gap=np.timedelta64(20, 'D')),
    'interpolate_na_nearest': lambda d: d.interpolate_na(dim='time',
                                                         method='nearest'),
    'interpolate_na_positions': lambda d: d.interpolate_na(
        dim='time', use_coordinate=False),
    'interpolate_na_y': lambda d: d.interpolate_na(dim='y'),
    'interp_x': lambda d: d.interp(x=[1.5, 2.0, 8.9, 20.0]),
    'interp_scalar': lambda d: d.interp(x=4.25),
    'interp_descending': lambda d: d.interp(y=[49.3, 46.1, 45.0]),
    'interp_nearest': lambda d: d.interp(x=[1.2, 6.7], method='nearest'),
    'interp_time': lambda d: d.interp(time=np.datetime64('2023-01-03')
                                      + np.array([1, 20, 50], 'timedelta64[D]')),
    'interp_two_dims': lambda d: d.interp(x=[2.0, 3.5], y=[48.0, 46.5]),
    'interp_like': lambda d: d.interp_like(d.isel(x=[1, 3]).assign_coords(
        x=[2.5, 6.5])),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_dataarray_matches_jax(name):
    j, t = _uneven()
    same(CASES[name](t), CASES[name](j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('name', ['ffill', 'bfill_limit_x', 'interpolate_na',
                                  'interpolate_na_limit', 'interp_x',
                                  'dropna_any'])
def test_dataset_matches_jax(name):
    j, t = pair_ds()
    same(CASES[name](t), CASES[name](j), rtol=1e-12, atol=1e-12)


def test_interp_pointwise_matches_jax():
    j, t = _uneven()
    import nd_tpu.core as jcore
    import nd_tpu_torch.core as tcore
    xs, ys = [1.5, 7.0, 3.3], [49.0, 46.2, 45.5]
    jx = jcore.DataArray(np.array(xs), dims=('points',))
    jy = jcore.DataArray(np.array(ys), dims=('points',))
    tx = tcore.DataArray(np.array(xs), dims=('points',), device='cpu')
    ty = tcore.DataArray(np.array(ys), dims=('points',), device='cpu')
    same(t.interp(x=tx, y=ty), j.interp(x=jx, y=jy), rtol=1e-12, atol=1e-12)
    same(t.interp(x=tx, y=ty, method='nearest'),
         j.interp(x=jx, y=jy, method='nearest'))


def test_datetime_payload_fills_match_jax():
    times = np.array(['2020-01-01', 'NaT', 'NaT', '2020-01-07', 'NaT'],
                     dtype='datetime64[ns]')
    import nd_tpu.core as jcore
    import nd_tpu_torch.core as tcore
    j = jcore.DataArray(times, dims=('t',), coords={'t': np.arange(5.0)})
    t = tcore.DataArray(times, dims=('t',), coords={'t': np.arange(5.0)},
                        device='cpu')
    for fn in (lambda d: d.ffill('t'), lambda d: d.bfill('t', limit=1),
               lambda d: d.interpolate_na('t')):
        same(fn(t), fn(j))


def test_integer_payloads_pass_through():
    import nd_tpu_torch.core as tcore
    da = tcore.DataArray(torch.arange(6).reshape(2, 3), dims=('y', 'time'))
    for fn in (lambda d: d.ffill('time'), lambda d: d.interpolate_na('time')):
        assert torch.equal(fn(da).data, da.data)
    with pytest.raises(ValueError):
        da.astype('float64').ffill('time', limit=0)


def test_interpolate_na_uses_the_coordinate_values():
    """A gap of uneven dates filled in proportion to the dates."""
    import nd_tpu_torch.core as tcore
    t = np.datetime64('2023-01-01', 'ns') + np.array(
        [0, 1, 10], 'timedelta64[D]')
    da = tcore.DataArray(torch.tensor([0.0, np.nan, 10.0]), dims=('time',),
                         coords={'time': t}, device='cpu')
    assert float(da.interpolate_na('time')[1]) == 1.0
    assert float(da.interpolate_na('time', use_coordinate=False)[1]) == 5.0
