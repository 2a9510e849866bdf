"""The data model's arithmetic, ``where`` and NaN-skipping reductions:
nd_tpu_torch against nd_tpu.

Both packages' ``generate_test_dataset`` make the same float64 cube from
one seed; the same NaNs go into both. Elementwise results must be equal
(float64: rtol 1e-15 for ``**``, whose libraries may round the last bit
apart, and for ``/``, which PyTorch evaluates against a scalar as a
product with its reciprocal; exact otherwise), reductions within rtol
1e-12 (sums in another order), and every result stays on the CPU the
inputs were on. The JAX package has no reflected ``%`` or ``**``.
"""

import operator

import numpy as np
import pytest
import torch

from nd_tpu.core import DataArray as JDataArray
from nd_tpu.testing import generate_test_dataset as jgen
from nd_tpu_torch.core import DataArray, Dataset
from nd_tpu_torch.core.dataarray import broadcast_variables
from nd_tpu_torch.core.variable import Variable
from nd_tpu_torch.testing import generate_test_dataset

DIMS = {'y': 6, 'x': 7, 'time': 5}


def _with_nans(ds, torch_side):
    rng = np.random.RandomState(3)
    for i, v in enumerate(list(ds.data_vars)):
        data = np.array(ds[v].values)
        data[rng.rand(*data.shape) < 0.15] = np.nan
        if i == 0:
            data[0, 0, :] = np.nan          # an all-NaN series
        ds[v] = (ds[v].dims, torch.from_numpy(data) if torch_side else data)
    return ds


@pytest.fixture
def pair():
    jds = _with_nans(jgen(dims=DIMS), False)
    tds = _with_nans(generate_test_dataset(dims=DIMS, device='cpu'), True)
    return jds, tds


def _same(got, ref, rtol=0.0):
    if isinstance(ref, JDataArray):
        assert isinstance(got, DataArray)
        assert got.dims == ref.dims
        assert got.data.device.type == 'cpu'
        got, ref = got.values, np.asarray(ref.values)
        assert got.shape == ref.shape
        if ref.dtype.kind == 'b':
            assert got.dtype == np.bool_
            np.testing.assert_array_equal(got, ref)
            return
        assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=0,
                                   equal_nan=True)
        return
    assert list(got.data_vars) == list(ref.data_vars)
    for v in ref.data_vars:
        _same(got[v], ref[v], rtol)


ARITH = {'+': operator.add, '-': operator.sub, '*': operator.mul,
         '/': operator.truediv, '**': operator.pow, '%': operator.mod}
COMPARE = {'<': operator.lt, '<=': operator.le, '>': operator.gt,
           '>=': operator.ge, '==': operator.eq, '!=': operator.ne}


def _rtol(name):
    return 1e-15 if name in ('**', '/') else 0.0


@pytest.mark.parametrize('name', sorted(ARITH) + sorted(COMPARE))
def test_dataarray_op_dataarray(pair, name):
    op = {**ARITH, **COMPARE}[name]
    jds, tds = pair
    # same dims, and a (x, y) operand aligned by name and broadcast
    _same(op(tds['C11'], tds['C22']), op(jds['C11'], jds['C22']),
          _rtol(name))
    plane = np.ascontiguousarray(np.asarray(jds['C22'].values)[:, :, 1].T)
    jsub = JDataArray(plane, dims=('x', 'y'))
    tsub = DataArray(torch.from_numpy(plane.copy()), dims=('x', 'y'))
    _same(op(tds['C11'], tsub), op(jds['C11'], jsub), _rtol(name))
    _same(op(tsub, tds['C11']), op(jsub, jds['C11']), _rtol(name))


@pytest.mark.parametrize('name', sorted(ARITH) + sorted(COMPARE))
@pytest.mark.parametrize('scalar', [2, 0.5, -1.5])
def test_dataarray_op_scalar_both_ways(pair, name, scalar):
    op = {**ARITH, **COMPARE}[name]
    jds, tds = pair
    _same(op(tds['C12__re'], scalar), op(jds['C12__re'], scalar),
          _rtol(name))
    if name in ('+', '-', '*', '/'):
        _same(op(scalar, tds['C12__re']), op(scalar, jds['C12__re']),
              _rtol(name))


@pytest.mark.parametrize('name', ['+', '*', '/', '>', '=='])
def test_dataset_ops(pair, name):
    op = {**ARITH, **COMPARE}[name]
    jds, tds = pair
    _same(op(tds, 3.0), op(jds, 3.0))
    _same(op(tds, tds['C11']), op(jds, jds['C11']))
    _same(op(tds, tds), op(jds, jds))
    if name in ARITH:
        _same(op(2.0, tds), op(2.0, jds))


def test_bool_ops_and_unary(pair):
    jds, tds = pair
    jm, tm = jds['C11'] > 0, tds['C11'] > 0
    jn, tn = jds['C22'] < 0.5, tds['C22'] < 0.5
    for op in (operator.and_, operator.or_, operator.xor):
        _same(op(tm, tn), op(jm, jn))
    _same(~tm, ~jm)
    _same(-tds['C11'], -jds['C11'])
    _same(abs(tds['C11']), abs(jds['C11']))


def test_integer_division_is_float64():
    a = DataArray(torch.arange(6).reshape(2, 3), dims=('y', 'x'))
    b = JDataArray(np.arange(6).reshape(2, 3), dims=('y', 'x'))
    _same(a / 4, b / 4)
    _same(a / (a + 1), b / (b + 1))


def test_where(pair):
    jds, tds = pair
    jc, tc = jds['C22'].mean('time') > 0, tds['C22'].mean('time') > 0
    _same(tds['C11'].where(tc), jds['C11'].where(jc))
    _same(tds['C11'].where(tc, -1.0), jds['C11'].where(jc, -1.0))
    _same(tds['C11'].where(tc, tds['C22']), jds['C11'].where(jc, jds['C22']))
    _same(tds['C11'].where(tds['C11'] > 0, tds['C22'].mean('time')),
          jds['C11'].where(jds['C11'] > 0, jds['C22'].mean('time')), 1e-12)
    cond = np.asarray((jds['C12__im'] > 0).values)
    _same(tds['C11'].where(cond), jds['C11'].where(cond))
    _same(tds.where(tc), jds.where(jc))
    _same(tds.where(tds > 0, 0.0), jds.where(jds > 0, 0.0))


def test_where_on_integers_promotes_to_float64():
    t = DataArray(torch.arange(6).reshape(2, 3), dims=('y', 'x'))
    j = JDataArray(np.arange(6).reshape(2, 3), dims=('y', 'x'))
    _same(t.where(t > 2), j.where(j > 2))


def test_isnull_notnull(pair):
    jds, tds = pair
    _same(tds['C11'].isnull(), jds['C11'].isnull())
    _same(tds['C11'].notnull(), jds['C11'].notnull())
    _same(tds.isnull(), jds.isnull())
    _same(tds.notnull(), jds.notnull())
    # a datetime coordinate stays numpy; NaT is null
    times = np.array(['2020-01-01', 'NaT'], dtype='datetime64[ns]')
    assert DataArray(times, dims=('time',)).isnull().values.tolist() == \
        [False, True]
    _same(tds['time'].isnull(), jds['time'].isnull())
    ints = DataArray(torch.arange(4), dims=('x',))
    assert not ints.isnull().values.any()
    assert ints.notnull().values.all()


REDUCTIONS = ['mean', 'std', 'var', 'min', 'max', 'sum', 'count']
DIMSETS = [None, 'time', ('y', 'x'), ('y', 'x', 'time')]


@pytest.mark.parametrize('name', REDUCTIONS)
@pytest.mark.parametrize('dim', DIMSETS)
def test_dataarray_reductions(pair, name, dim):
    jds, tds = pair
    with _quiet():
        ref = getattr(jds['C11'], name)(dim)
    got = getattr(tds['C11'], name)(dim)
    _same(got, ref, 1e-12)
    assert set(got.coords) == set(ref.coords)


@pytest.mark.parametrize('name', REDUCTIONS)
@pytest.mark.parametrize('dim', DIMSETS[:3])
def test_dataset_reductions(pair, name, dim):
    jds, tds = pair
    with _quiet():
        ref = getattr(jds, name)(dim)
    got = getattr(tds, name)(dim)
    _same(got, ref, 1e-12)
    assert list(got.coords) == list(ref.coords)


@pytest.mark.parametrize('name', ['std', 'var'])
def test_ddof(pair, name):
    jds, tds = pair
    with _quiet():
        ref = getattr(jds['C22'], name)('time', ddof=1)
    _same(getattr(tds['C22'], name)('time', ddof=1), ref, 1e-12)


def test_reductions_of_integers():
    t = DataArray(torch.arange(12, dtype=torch.int32).reshape(3, 4),
                  dims=('y', 'x'))
    j = JDataArray(np.arange(12, dtype=np.int32).reshape(3, 4),
                   dims=('y', 'x'))
    for name in ('min', 'max', 'sum', 'count'):
        np.testing.assert_array_equal(getattr(t, name)('x').values,
                                      np.asarray(getattr(j, name)('x').values))
    _same(t.mean('y'), j.mean('y'), 1e-15)
    _same(t.std(), j.std(), 1e-15)


def test_squeeze_and_expand_dims(pair):
    jds, tds = pair
    jone = jds['C11'].mean('time').expand_dims('time')
    tone = tds['C11'].mean('time').expand_dims('time')
    _same(tone, jone, 1e-12)
    _same(tone.squeeze(), jone.squeeze(), 1e-12)
    _same(tone.squeeze('time'), jone.squeeze('time'), 1e-12)
    _same(tds['C11'].expand_dims('band', axis=-1),
          jds['C11'].expand_dims('band', axis=-1))
    with pytest.raises(ValueError):
        tds['C11'].squeeze('time')
    with pytest.raises(KeyError):
        tone.squeeze('band')
    _same(tone.expand_dims({'band': 2}), jone.expand_dims({'band': 2}),
          1e-12)
    _same(tone.expand_dims({'band': [10.0, 20.0, 30.0], 'z': 1}),
          jone.expand_dims({'band': [10.0, 20.0, 30.0], 'z': 1}), 1e-12)
    _same(tds.expand_dims('band'), jds.expand_dims('band'))
    _same(tds.expand_dims('band').squeeze(), jds.expand_dims('band').squeeze())
    _same(tds.expand_dims('band').squeeze('band'),
          jds.expand_dims('band').squeeze('band'))


def test_broadcast_variables_aligns_by_name():
    a = Variable(('y', 'x'), torch.arange(6.0).reshape(2, 3))
    b = Variable(('time', 'x'), torch.arange(12.0).reshape(4, 3) * 10)
    a2, b2 = broadcast_variables(a, b)
    assert a2.dims == b2.dims == ('y', 'x', 'time')
    assert a2.shape == b2.shape == (2, 3, 4)
    assert float(a2.data[1, 2, 3]) == 5.0 and float(b2.data[1, 2, 3]) == 110.0


def test_conflicting_sizes_raise():
    a = DataArray(torch.zeros(2, 3), dims=('y', 'x'))
    b = DataArray(torch.zeros(4), dims=('x',))
    with pytest.raises(ValueError, match='conflicting'):
        a + b


def test_dataset_where_copy_and_hash():
    ds = Dataset({'a': (('x',), torch.arange(4.0))})
    c = ds.copy()
    c['a'].data[0] = 9.0
    assert float(ds['a'].data[0]) == 0.0
    out = ds.where(ds > 1.5)
    assert np.isnan(out['a'].values[:2]).all() and \
        (out['a'].values[2:] == [2.0, 3.0]).all()
    with pytest.raises(TypeError):
        hash(ds['a'])


class _quiet:
    """numpy's all-NaN-slice warnings off (nd_tpu reduces with np.nan*)."""

    def __enter__(self):
        import warnings
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter('ignore', RuntimeWarning)

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)
