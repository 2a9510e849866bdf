"""The data model's indexing, combining, reshaping, reductions and
accumulations: nd_tpu_torch against nd_tpu (numpy payloads, so numpy's
nan* semantics) on the same float64 cube with NaNs, a descending ``y``,
a datetime ``time`` and a 2-D ``lat`` coordinate.

Tolerances: indexing and reshaping move values and must be exact; sums,
means and accumulations agree within rtol 1e-12 (atol 1e-12 for results
near zero): PyTorch and numpy sum in other orders; quantiles and
medians within rtol 1e-12 (numpy's 'linear' interpolation, written out
the same way, but ``np.nanmedian`` averages the two middle values where
the port interpolates at 0.5).
"""

import numpy as np
import pytest
import torch

from nd_tpu.core import concat as jconcat
from nd_tpu.core import merge as jmerge
from nd_tpu.core.dataarray import broadcast as jbroadcast
from nd_tpu.core.dataarray import full_like as jfull_like
from nd_tpu.core.dataarray import ones_like as jones_like
from nd_tpu.core.dataarray import zeros_like as jzeros_like
from nd_tpu_torch.core import DataArray, Dataset
from nd_tpu_torch.core.dataarray import (broadcast, concat, full_like,
                                         merge, ones_like, zeros_like)
from torch_models import pair_da, pair_ds, same

T3 = np.datetime64('2023-01-15', 'ns')

# name -> f(obj) applied to both packages' DataArrays
DA_CASES = {
    'getitem_int': lambda d: d[2],
    'getitem_slices': lambda d: d[1:4, ::2],
    'getitem_neg': lambda d: d[-1, :, -2],
    'getitem_array': lambda d: d[:, [0, 3, 1]],
    'isel_dict': lambda d: d.isel({'time': slice(2, 6), 'x': 1}),
    'isel_bool': lambda d: d.isel(y=np.array([1, 0, 1, 1, 0, 1], bool)),
    'isel_reverse': lambda d: d.isel(time=slice(None, None, -1)),
    'sel_label': lambda d: d.sel(x=5.0),
    'sel_labels': lambda d: d.sel(x=[7.0, 1.0]),
    'sel_slice_descending': lambda d: d.sel(y=slice(49.0, 46.0)),
    'sel_date_string': lambda d: d.sel(time='2023-01-15'),
    'sel_date_slice': lambda d: d.sel(time=slice('2023-01-08',
                                                 '2023-01-30')),
    'sel_nearest': lambda d: d.sel(x=4.2, method='nearest'),
    'sel_nearest_date': lambda d: d.sel(time=T3 + np.timedelta64(2, 'D'),
                                        method='nearest'),
    'head': lambda d: d.head(time=3, y=2),
    'tail': lambda d: d.tail(time=2),
    'thin': lambda d: d.thin(time=3),
    'drop_vars': lambda d: d.drop_vars('lat'),
    'drop_isel': lambda d: d.drop_isel(time=[0, -1]),
    'drop_sel': lambda d: d.drop_sel(x=[3.0, 9.0]),
    'reindex': lambda d: d.reindex(x=[1.0, 2.0, 5.0, 11.0]),
    'reindex_nearest': lambda d: d.reindex(x=[1.2, 4.9], method='nearest'),
    'reindex_like': lambda d: d.reindex_like(d.isel(x=[4, 0])),
    'sortby': lambda d: d.sortby('y'),
    'sortby_desc': lambda d: d.sortby('x', ascending=False),
    'transpose': lambda d: d.transpose('time', 'y', 'x'),
    'stack': lambda d: d.stack(pix=('y', 'x')),
    'unstack': lambda d: d.stack(pix=('y', 'x')).unstack(),
    'expand_dims_dict': lambda d: d.expand_dims({'band': [1, 2]}),
    'rename': lambda d: d.rename({'x': 'col', 'lat': 'latitude'}),
    'rename_name': lambda d: d.rename('other'),
    'swap_dims': lambda d: d.assign_coords(
        lon=('x', np.arange(5) * 0.1)).swap_dims(x='lon'),
    'assign_coords': lambda d: d.assign_coords(band=('time', np.arange(8))),
    'assign_attrs': lambda d: d.assign_attrs(units='dB'),
    'reset_coords_drop': lambda d: d.reset_coords(drop=True),
    'broadcast_like': lambda d: d.isel(time=0).broadcast_like(d),
    'combine_first': lambda d: d.isel(x=[0, 1, 2]).combine_first(
        d.isel(x=[2, 3]) * 10),
    'where_scalar': lambda d: d.where(d > 0.5, -1.0),
    'where_da': lambda d: d.where(d.isel(time=0) > 0, d.isel(time=1)),
    'clip': lambda d: d.clip(0.0, 2.0),
    'round': lambda d: (d * 10).round(),
    'isin': lambda d: (d * 0 + d.isel(time=0).round()).isin([0.0, 1.0]),
    'fillna': lambda d: d.fillna(9.0),
    'median': lambda d: d.median('time'),
    'median_all': lambda d: d.median(),
    'prod': lambda d: d.prod('time'),
    'quantile': lambda d: d.quantile(0.9, dim='time'),
    'quantile_two_dims': lambda d: d.quantile(0.3, dim=('y', 'x')),
    'quantile_vector': lambda d: d.quantile([0.1, 0.5, 0.9], dim='time'),
    'all': lambda d: (d > 0).all('time'),
    'any': lambda d: (d > 2.5).any(('y', 'x')),
    'argmin': lambda d: d.fillna(5.0).argmin('time'),
    'argmax': lambda d: d.fillna(-5.0).argmax('x'),
    'idxmin': lambda d: d.fillna(5.0).idxmin('time'),
    'idxmax': lambda d: d.fillna(-5.0).idxmax('x'),
    'cumsum': lambda d: d.cumsum('time'),
    'cumprod': lambda d: (d * 0.5).cumprod('time'),
    'diff': lambda d: d.diff('time'),
    'diff_lower2': lambda d: d.diff('x', n=2, label='lower'),
    'differentiate': lambda d: d.differentiate('x'),
    'integrate': lambda d: d.fillna(0).integrate('x'),
    'shift': lambda d: d.shift(time=2),
    'shift_back': lambda d: d.shift(time=-3, fill_value=0.0),
    'roll': lambda d: d.roll(x=2),
    'roll_coords': lambda d: d.roll(x=-1, roll_coords=True),
    'pad_constant': lambda d: d.pad(time=(1, 2)),
    'pad_edge': lambda d: d.pad(x=1, mode='edge'),
    'pad_reflect': lambda d: d.pad(y=(2, 1), mode='reflect'),
    'pad_symmetric': lambda d: d.pad(y=2, mode='symmetric'),
    'pad_wrap': lambda d: d.pad(x=(1, 3), mode='wrap'),
    'reduce': lambda d: d.fillna(0).reduce(np.sum if isinstance(
        d.data, np.ndarray) else torch.sum, 'time'),
    'real': lambda d: d.real,
    'conj': lambda d: d.conj(),
}


@pytest.mark.parametrize('name', sorted(DA_CASES))
def test_dataarray_method_matches_jax(name):
    j, t = pair_da()
    same(DA_CASES[name](t), DA_CASES[name](j), rtol=1e-12, atol=1e-12)


DS_CASES = {
    'isel': lambda d: d.isel(time=[1, 3], x=slice(1, None)),
    'sel': lambda d: d.sel(time=slice('2023-01-09', '2023-01-27')),
    'loc_like_sel': lambda d: d.sel(x=3.0),
    'head': lambda d: d.head(y=2),
    'drop_dims': lambda d: d.assign(z=(('band',), np.ones(3))).drop_dims(
        'band'),
    'drop_vars': lambda d: d.drop_vars('C22'),
    'drop_sel': lambda d: d.drop_sel(time=np.datetime64('2023-01-09')),
    'rename': lambda d: d.rename({'C11': 'vv'}),
    'rename_vars': lambda d: d.rename_vars(C22='vh'),
    'rename_dims': lambda d: d.rename_dims(time='t'),
    'set_coords': lambda d: d.set_coords('C22'),
    'reset_coords': lambda d: d.reset_coords('lat'),
    'assign': lambda d: d.assign(ratio=lambda ds: ds['C11'] / ds['C22']),
    'stack': lambda d: d.stack(pix=('y', 'x')),
    'unstack': lambda d: d.stack(pix=('y', 'x')).unstack(),
    'expand_dims': lambda d: d.expand_dims('band'),
    'to_array': lambda d: d.to_dataarray('var'),
    'median': lambda d: d.median('time'),
    'quantile': lambda d: d.quantile(0.25, dim='time'),
    'cumsum': lambda d: d.cumsum('time'),
    'diff': lambda d: d.diff('time'),
    'shift': lambda d: d.shift(x=1),
    'roll': lambda d: d.roll(y=1, roll_coords=True),
    'pad': lambda d: d.pad(time=1),
    'sortby': lambda d: d.sortby('y'),
    'reindex': lambda d: d.reindex(x=[1.0, 4.0]),
    'combine_first': lambda d: d.isel(y=[0, 1]).combine_first(
        d.isel(y=[1, 2]) + 1),
    'where': lambda d: d.where(d > 0),
    'argmin': lambda d: d.fillna(0).argmin('time'),
    'count': lambda d: d.count('time'),
    'differentiate': lambda d: d.differentiate('x'),
    'integrate': lambda d: d.fillna(0).integrate('time'),
}


@pytest.mark.parametrize('name', sorted(DS_CASES))
def test_dataset_method_matches_jax(name):
    j, t = pair_ds()
    same(DS_CASES[name](t), DS_CASES[name](j), rtol=1e-12, atol=1e-12)


def test_update_and_merge_match_jax():
    j, t = pair_ds()
    j2, t2 = pair_ds(names=('C12',), seed=5)
    same(merge([t, t2]), jmerge([j, j2]))
    same(t.merge(t2), j.merge(j2))
    t.update(t2)
    j.update(j2)
    same(t, j)
    with pytest.raises(ValueError):
        t.update({'bad': (('y',), torch.zeros(3))})


@pytest.mark.parametrize('dim', ['time', 'x', 'new'])
def test_concat_matches_jax(dim):
    j, t = pair_da()
    jparts = [j.isel(time=slice(0, 3)), j.isel(time=slice(3, None))] \
        if dim == 'time' else [j.isel(x=[0]), j.isel(x=[1, 2])] \
        if dim == 'x' else [j.isel(time=0), j.isel(time=1)]
    tparts = [t.isel(time=slice(0, 3)), t.isel(time=slice(3, None))] \
        if dim == 'time' else [t.isel(x=[0]), t.isel(x=[1, 2])] \
        if dim == 'x' else [t.isel(time=0), t.isel(time=1)]
    same(concat(tparts, dim), jconcat(jparts, dim))
    jd, td = pair_ds()
    split = {'time': 4, 'x': 2, 'new': 0}[dim]
    if dim == 'new':
        same(concat([td.isel(time=0), td.isel(time=1)], 'new'),
             jconcat([jd.isel(time=0), jd.isel(time=1)], 'new'))
    else:
        same(concat([td.isel({dim: slice(0, split)}),
                     td.isel({dim: slice(split, None)})], dim),
             jconcat([jd.isel({dim: slice(0, split)}),
                      jd.isel({dim: slice(split, None)})], dim))


def test_broadcast_and_likes_match_jax():
    j, t = pair_da()
    for got, ref in zip(broadcast(t.isel(time=0), t.isel(x=0)),
                        jbroadcast(j.isel(time=0), j.isel(x=0))):
        same(got, ref)
    same(full_like(t, 2.5), jfull_like(j, 2.5))
    same(zeros_like(t, dtype='int32'), jzeros_like(j, dtype='int32'))
    same(ones_like(t), jones_like(j))


def test_comparison_methods_match_jax():
    j, t = pair_da()
    for fn in (lambda d: d.equals(d.copy()),
               lambda d: d.equals(d + 1),
               lambda d: d.identical(d.rename('x2')),
               lambda d: d.broadcast_equals(d.isel(time=[0]) * 1),
               lambda d: d.isel(time=0).broadcast_equals(
                   d.isel(time=0).expand_dims({'band': 2}))):
        assert fn(t) == fn(j)
    jd, td = pair_ds()
    assert td.equals(td.copy()) and jd.equals(jd.copy())
    assert td.identical(td.assign_attrs(a=1)) == \
        jd.identical(jd.assign_attrs(a=1))
    assert td.broadcast_equals(td) == jd.broadcast_equals(jd)


def test_scalar_conversions_and_sizes():
    j, t = pair_da()
    one_t, one_j = t.isel(y=0, x=0, time=1), j.isel(y=0, x=0, time=1)
    assert t.fillna(0).isel(y=1, x=1, time=0).item() == \
        j.fillna(0).isel(y=1, x=1, time=0).item()
    assert float(one_t.fillna(0)) == float(one_j.fillna(0))
    assert int((t > 0).sum()) == int((j > 0).sum())
    assert bool((t.fillna(0) > -9).all()) and len(t) == len(j) == 6
    assert t.size == j.size and t.nbytes == j.values.nbytes
    jd, td = pair_ds()
    assert td.nbytes == jd.nbytes
    assert td.get('missing') is None and td.get('C11').name == 'C11'


def test_serialisation_and_host_copies():
    j, t = pair_da()
    d = t.to_dict()
    assert d['dims'] == j.to_dict()['dims']
    same(DataArray.from_dict(d, device='cpu'),
         type(j).from_dict(j.to_dict()))
    jd, td = pair_ds()
    same(Dataset.from_dict(td.to_dict(), device='cpu'),
         type(jd).from_dict(jd.to_dict()))
    assert t.as_numpy().data.device.type == 'cpu'
    assert t.compute() is t and t.persist() is t and t.chunk() is t
    assert t.load() is t and t.data.device.type == 'cpu'
    assert td.load() is td


def test_argsort_matches_jax():
    from torch_models import cube_values
    j, t = pair_da(cube_values(nan_frac=0.0))
    same(t.argsort(), j.argsort())
    same(t.argsort(axis=0), j.argsort(axis=0))


def test_dataset_expand_dims_dict():
    jd, td = pair_ds()
    got = td.expand_dims({'band': [10, 20]})
    for v in jd.data_vars:
        same(got[v], jd[v].expand_dims({'band': [10, 20]}))


def test_loc_is_label_selection():
    _, t = pair_da()
    same_t = t.sel(x=3.0, time='2023-01-09')
    got = t.loc[:, 3.0, '2023-01-09']
    assert torch.equal(got.data, same_t.data, ) if not \
        torch.isnan(same_t.data).any() else \
        np.array_equal(got.values, same_t.values, equal_nan=True)
    assert got.dims == same_t.dims
    assert t.loc[{'x': 3.0}].dims == ('y', 'time')


@pytest.mark.parametrize('method,label,expect', [
    ('pad', 4.0, 3.0), ('ffill', 9.5, 9.0), ('backfill', 4.0, 5.0),
    ('bfill', 0.5, 1.0), ('nearest', 6.2, 7.0)])
def test_sel_methods(method, label, expect):
    _, t = pair_da()
    assert float(t.sel(x=label, method=method)['x']) == expect
    _, t = pair_da()
    # the descending y axis
    y = float(t.sel(y=47.6, method=method)['y'])
    ys = t['y'].values
    below, above = ys[ys <= 47.6].max(), ys[ys >= 47.6].min()
    want = {'pad': below, 'ffill': below, 'backfill': above,
            'bfill': above,
            'nearest': ys[np.argmin(np.abs(ys - 47.6))]}[method]
    assert y == want


def test_sel_method_raises_outside():
    _, t = pair_da()
    with pytest.raises(KeyError):
        t.sel(x=0.5, method='pad')
    with pytest.raises(KeyError):
        t.sel(x=2.0)
    with pytest.raises(ValueError):
        t.sel(x=2.0, method='linear')


def test_dt_fields_match_jax():
    j, t = pair_da()
    for field in ('year', 'month', 'day', 'dayofyear', 'dayofweek',
                  'quarter', 'season', 'days_in_month', 'weekofyear'):
        same(getattr(t['time'].dt, field), getattr(j['time'].dt, field))


def test_pandas_bridge_matches_jax():
    j, t = pair_da()
    import pandas as pd
    pd.testing.assert_series_equal(t.to_series(), j.to_series())
    pd.testing.assert_frame_equal(t.to_dataframe(), j.to_dataframe())
    pd.testing.assert_index_equal(t['x'].to_index(), j['x'].to_index())
    pd.testing.assert_index_equal(t.get_index('time'), j.get_index('time'))
    jd, td = pair_ds()
    pd.testing.assert_frame_equal(td.to_dataframe(), jd.to_dataframe())
