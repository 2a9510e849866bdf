"""Grouped and windowed reductions: ``groupby``, ``resample``,
``rolling``, ``coarsen``, ``weighted`` and the ``.dt`` fields of
nd_tpu_torch against nd_tpu on the same float64 cube with NaNs and a
one-year datetime axis (56 dates at a 6-day revisit from 2023-01-03);
the numpy resampling bins against pandas' own.

Tolerances: the groups and bins are exact (labels and members); the
reductions within rtol 1e-12, atol 1e-12 (sums in another order);
medians within rtol 1e-12 (the port interpolates at 0.5 where numpy
averages the middle pair).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import nd_tpu.core as jcore
import nd_tpu_torch.core as tcore
from nd_tpu_torch.core.grouped import dt_field, resample_bins
from torch_models import coords, cube_values, same

YEAR = np.datetime64('2023-01-03', 'ns') \
    + np.arange(56) * np.timedelta64(6, 'D')


def _pair(shape=(4, 3, 56), times=YEAR, seed=0):
    c = coords(shape)
    c['time'] = times
    vals = cube_values(shape, seed)
    j = jcore.DataArray(vals.copy(), coords=c, dims=('y', 'x', 'time'),
                        name='C11')
    t = tcore.DataArray(torch.from_numpy(vals.copy()), coords=c,
                        dims=('y', 'x', 'time'), name='C11', device='cpu')
    return j, t


def _pair_ds(shape=(4, 3, 56)):
    c = coords(shape)
    c['time'] = YEAR[:shape[2]]
    vals = {n: cube_values(shape, i) for i, n in enumerate(('C11', 'C22'))}
    j = jcore.Dataset({n: (('y', 'x', 'time'), v.copy())
                       for n, v in vals.items()}, coords=c)
    t = tcore.Dataset({n: (('y', 'x', 'time'), torch.from_numpy(v.copy()))
                       for n, v in vals.items()}, coords=c, device='cpu')
    return j, t


CASES = {
    'groupby_month_mean': lambda d: d.groupby('time.month').mean(),
    'groupby_season_max': lambda d: d.groupby('time.season').max(),
    'groupby_month_median': lambda d: d.groupby('time.month').median(),
    'groupby_coord_sum': lambda d: d.groupby('x').sum(),
    'groupby_first': lambda d: d.groupby('time.quarter').first(),
    'groupby_last': lambda d: d.groupby('time.quarter').last(),
    'groupby_map_anomaly': lambda d: d.groupby('time.month').map(
        lambda g: g - g.mean('time')),
    'groupby_count': lambda d: d.groupby('time.month').count(),
    'resample_1MS_mean': lambda d: d.resample(time='1MS').mean(),
    'resample_ME_max': lambda d: d.resample(time='ME').max(),
    'resample_M_alias': lambda d: d.resample(time='M').mean(),
    'resample_10D_sum': lambda d: d.resample(time='10D').sum(),
    'resample_W_min': lambda d: d.resample(time='W').min(),
    'resample_QS_median': lambda d: d.resample(time='QS').median(),
    'resample_YS_mean': lambda d: d.resample(time='YS').mean(),
    'rolling_mean': lambda d: d.rolling(time=3).mean(),
    'rolling_center_median': lambda d: d.rolling(time=3, center=True)
    .median(),
    'rolling_even_center': lambda d: d.rolling(time=4, center=True,
                                               min_periods=2).sum(),
    'rolling_min_periods': lambda d: d.rolling(time=5, min_periods=1).max(),
    'rolling_std': lambda d: d.rolling(x=2).std(),
    'rolling_count': lambda d: d.rolling(time=3, min_periods=2).count(),
    'rolling_construct': lambda d: d.rolling(time=3).construct('w'),
    'coarsen_mean': lambda d: d.coarsen(time=4).mean(),
    'coarsen_two_dims': lambda d: d.coarsen(y=2, time=7).max(),
    'coarsen_trim': lambda d: d.coarsen(time=5, boundary='trim').sum(),
    'coarsen_trim_right': lambda d: d.coarsen(time=5, boundary='trim',
                                              side='right').min(),
    'coarsen_pad': lambda d: d.coarsen(x=2, boundary='pad').mean(),
    'coarsen_count': lambda d: d.coarsen(time=8).count(),
    'coarsen_median': lambda d: d.coarsen(time=4).median(),
    'coarsen_median_nan': lambda d: d.coarsen(time=4).median(skipna=False),
    'coarsen_std_nan': lambda d: d.coarsen(time=7).std(skipna=False),
    'coarsen_first': lambda d: d.coarsen(y=2, coord_func='first').var(),
    'coarsen_last': lambda d: d.coarsen(y=2, coord_func='last').std(),
    'weighted_mean': lambda d: d.weighted(d['x'] * 0 + d['x']).mean('x'),
    'weighted_sum': lambda d: d.weighted(d['y'] - 40.0).sum(('y', 'x')),
    'weighted_var': lambda d: d.weighted(d['x']).var('x'),
    'weighted_std': lambda d: d.weighted(d['lat'] + 1).std(('y', 'x')),
    'weighted_sum_of_weights': lambda d: d.weighted(d['x']).sum_of_weights(
        'x'),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_dataarray_matches_jax(name):
    j, t = _pair()
    same(CASES[name](t), CASES[name](j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('name', ['groupby_month_mean', 'resample_1MS_mean',
                                  'rolling_center_median', 'coarsen_mean',
                                  'weighted_mean'])
def test_dataset_matches_jax(name):
    j, t = _pair_ds()
    same(CASES[name](t), CASES[name](j), rtol=1e-12, atol=1e-12)


def test_groupby_iteration_and_groups_match_jax():
    j, t = _pair()
    jg, tg = j.groupby('time.month'), t.groupby('time.month')
    assert len(jg) == len(tg) == 11
    for (jl, jsub), (tl, tsub) in zip(jg, tg):
        assert jl == tl
        same(tsub, jsub)
    for (jl, ji), (tl, ti) in zip(jg.groups().items(), tg.groups().items()):
        assert jl == tl and np.array_equal(ji, ti)


def test_groupby_dataarray_labels_and_nan_labels():
    j, t = _pair()
    labels = np.where(np.arange(56) % 5 == 0, np.nan, np.arange(56) % 3)
    jl = jcore.DataArray(labels, dims=('time',), name='cls')
    tl = tcore.DataArray(labels, dims=('time',), name='cls', device='cpu')
    same(t.groupby(tl).mean(), j.groupby(jl).mean(), 1e-12, 1e-12)


FREQS = ['D', '10D', 'W', '2W', 'M', 'ME', '2ME', 'MS', '3MS', 'QS', 'Q',
         'QE', 'YS', 'A', 'YE', 'h', '6h']


@pytest.mark.parametrize('seed', range(6))
def test_resample_bins_equal_pandas(seed):
    rng = np.random.RandomState(seed)
    start = np.datetime64('2020-01-01', 'ns') \
        + np.timedelta64(int(rng.randint(0, 1500)), 'D') \
        + np.timedelta64(int(rng.randint(0, 86400)) * (seed % 2), 's')
    t = np.sort(start + (rng.rand(40) * 700 * 86400).astype(
        'timedelta64[s]')).astype('datetime64[ns]')
    s = pd.Series(np.arange(len(t)), index=pd.DatetimeIndex(t))
    for freq in FREQS:
        modern = {'M': 'ME', 'Q': 'QE', 'A': 'YE'}.get(freq, freq)
        want = np.empty(len(t), 'datetime64[ns]')
        for label, group in s.resample(modern):
            want[group.values] = np.datetime64(label, 'ns')
        np.testing.assert_array_equal(resample_bins(t, freq), want)


def test_dt_fields_equal_pandas():
    t = np.array(['2023-01-03T13:45:12.5', '2024-02-29', '2020-12-31T23:59',
                  'NaT', '2021-01-03', '2019-12-30'], dtype='datetime64[ns]')
    idx = pd.DatetimeIndex(t)
    for field in ('year', 'month', 'day', 'hour', 'minute', 'second',
                  'dayofyear', 'dayofweek', 'quarter', 'days_in_month'):
        np.testing.assert_array_equal(dt_field(t, field),
                                      np.asarray(getattr(idx, field), float))
    np.testing.assert_array_equal(
        dt_field(t, 'week'), np.asarray(idx.isocalendar().week, float))
    ok = t[~np.isnat(t)]
    okx = pd.DatetimeIndex(ok)
    assert list(dt_field(ok, 'date')) == list(okx.date)
    assert list(dt_field(ok, 'time')) == list(okx.time)
    assert list(dt_field(ok, 'season')) == ['DJF', 'DJF', 'DJF', 'DJF',
                                            'DJF']


def test_window_arguments_are_checked():
    _, t = _pair()
    with pytest.raises(ValueError):
        t.rolling(time=0)
    with pytest.raises(ValueError):
        t.rolling(time=3, min_periods=5)
    with pytest.raises(ValueError):
        t.coarsen(time=5)
    with pytest.raises(ValueError):
        t.weighted(t['x'] * np.nan)
    with pytest.raises(TypeError):
        t.resample(x='1D')
