"""Faults F9-F15 of the port against nd_tpu, each held to nd_tpu on the
CPU: datetime64 payloads (F9), complex payloads (F10), ``round``,
``argmin``/``argmax`` and ``clip`` for the dtypes PyTorch lacks them for
(F11), ``Dataset.apply`` (F12), numpy's type promotion (F13, F13b),
numpy input to ``ops.interp`` (F14) and the reference's positional order
(F15). nd_tpu keeps numeric payloads as numpy arrays, so numpy's
semantics are the reference throughout."""

import os
import warnings

import numpy as np
import pytest
import torch

import nd_tpu
import nd_tpu.testing
from nd_tpu.core import DataArray as JDataArray
from nd_tpu.core import Dataset as JDataset
from nd_tpu.io import assemble_complex as jassemble
from nd_tpu.ops import interp as J
import nd_tpu_torch as ndt
import nd_tpu_torch.testing
from nd_tpu_torch.core import DataArray, Dataset
from nd_tpu_torch.core.variable import result_dtype
from nd_tpu_torch.io import assemble_complex
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import interp as T
from torch_cubes import sar_cube
from torch_models import pair_ds, same, same_array

NAN = float('nan')


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        return fn()


def _pair(values, dims=('t',)):
    """The same numpy values as an nd_tpu and a port DataArray."""
    return (JDataArray(values.copy(), dims=dims),
            DataArray(values.copy(), dims=dims, device='cpu'))


def _exact(got, ref):
    """Values and dtype as numpy's (torch dtypes compared by name)."""
    g, r = np.asarray(got.values), np.asarray(ref.values)
    assert g.dtype == r.dtype, (g.dtype, r.dtype)
    same_array(g, r, rtol=0)


# -- F9: datetime64 and timedelta64 payloads --------------------------------

DATETIME_REDUCTIONS = ['min', 'max', 'argmin', 'argmax', 'any', 'all']


@pytest.mark.parametrize('name', DATETIME_REDUCTIONS)
def test_f9_time_coordinate_reductions(name):
    j = nd_tpu.testing.generate_test_dataset()['time']
    t = ndt.testing.generate_test_dataset(device='cpu')['time']
    got = getattr(t, name)()
    _exact(got, getattr(j, name)())
    if name in ('min', 'max'):
        assert isinstance(got.data, np.ndarray)     # never on a device


@pytest.mark.parametrize('name', DATETIME_REDUCTIONS + ['median'])
def test_f9_datetime_with_nat(name):
    times = np.array(['2020-01-03', 'NaT', '2020-01-01', '2020-01-05'],
                     dtype='datetime64[ns]')
    j, t = _pair(np.stack([times, times[::-1]]), dims=('s', 't'))
    for dim in (None, 't'):
        try:
            ref = _quiet(lambda: getattr(j, name)(dim))
        except TypeError as e:           # numpy cannot add datetimes
            with pytest.raises(TypeError):
                getattr(t, name)(dim)
            assert 'add' in str(e)
            continue
        _exact(getattr(t, name)(dim), ref)


@pytest.mark.parametrize('q', [0.3, 0.5, [0.25, 0.75]])
@pytest.mark.parametrize('method', ['linear', 'lower', 'nearest'])
def test_f9_datetime_quantile(q, method):
    times = np.array(['2020-01-03', 'NaT', '2020-01-01', '2020-01-05'],
                     dtype='datetime64[ns]')
    j, t = _pair(times)
    got = t.quantile(q, method=method)
    _exact(got, j.quantile(q, method=method))
    assert isinstance(got.data, np.ndarray)


@pytest.mark.parametrize('name', ['min', 'max', 'argmax', 'median', 'sum'])
def test_f9_timedelta(name):
    j, t = _pair(np.array([1, 'NaT', 5, 2], dtype='timedelta64[D]'))
    _exact(getattr(t, name)(), _quiet(lambda: getattr(j, name)()))


@pytest.mark.parametrize('name', ['max', 'min'])
def test_f9_rolling_datetime_keeps_dtype(name):
    """tests/test_grouped_oracle.py's hand-computed windows."""
    times = np.array(['2020-01-03', 'NaT', '2020-01-01', '2020-01-05'],
                     dtype='datetime64[ns]')
    j, t = _pair(times)
    got = getattr(t.rolling(t=2, min_periods=1), name)()
    assert got.dtype == times.dtype
    _exact(got, getattr(j.rolling(t=2, min_periods=1), name)())
    expect = {'max': ['2020-01-03', '2020-01-03', '2020-01-01',
                      '2020-01-05'],
              'min': ['2020-01-03', '2020-01-03', '2020-01-01',
                      '2020-01-01']}[name]
    np.testing.assert_array_equal(got.values,
                                  np.array(expect, 'datetime64[ns]'))


def test_f9_dataset_time_reductions():
    j = nd_tpu.testing.generate_test_dataset()
    t = ndt.testing.generate_test_dataset(device='cpu')
    same(t['time'].max(), j['time'].max())
    same(t.max(), j.max(), rtol=1e-6)


# -- F10: complex payloads ---------------------------------------------------

def _complex_values(seed=0, shape=(5, 7)):
    rng = np.random.RandomState(seed)
    v = rng.randint(-3, 4, shape) + 1j * rng.randint(-3, 4, shape)
    v = v.astype(np.complex128)
    v[0, 2] = complex(NAN, 1.0)
    v[1, 4] = complex(2.0, NAN)
    v[2, :] = complex(NAN, NAN)                 # an all-NaN row
    v[3, 1] = NAN
    v[4, 3] = v[4, 5] = complex(3.0, 2.0)       # a tie for the maximum
    return v


COMPLEX_REDUCTIONS = ['mean', 'std', 'var', 'median', 'min', 'max', 'sum',
                      'prod']


@pytest.mark.parametrize('name', COMPLEX_REDUCTIONS)
@pytest.mark.parametrize('dim', [None, 'x', 'y'])
def test_f10_complex_reductions(name, dim):
    j, t = _pair(_complex_values(), dims=('y', 'x'))
    ref = _quiet(lambda: getattr(j, name)(dim))
    got = getattr(t, name)(dim)
    assert got.dtype == torch.from_numpy(np.asarray(ref.values)).dtype
    same(got, ref, rtol=1e-12)


@pytest.mark.parametrize('name', ['argmin', 'argmax'])
def test_f10_complex_arg_reductions(name):
    v = _complex_values()
    j, t = _pair(np.delete(v, 2, axis=0), dims=('y', 'x'))  # numpy raises
    for dim in (None, 'x', 'y'):                             # on all-NaN
        _exact(getattr(t, name)(dim), getattr(j, name)(dim))
    # an all-NaN slice gives -1, as jnp.nanargmax (numpy raises)
    assert getattr(_pair(v, ('y', 'x'))[1], name)('x').values[2] == -1


@pytest.mark.parametrize('name', ['cumsum', 'cumprod', 'diff'])
def test_f10_complex_accumulations(name):
    j, t = _pair(_complex_values(), dims=('y', 'x'))
    call = (lambda o: o.diff('x')) if name == 'diff' \
        else (lambda o: getattr(o, name)('x'))
    same(call(t), call(j), rtol=1e-12)


def test_f10_nansum_and_diff_over_a_nan():
    j, t = _pair(np.array([1 + 2j, 3 - 1j, NAN, 2j]))
    assert complex(t.sum().values) == 4 + 3j
    same(t.diff('t'), j.diff('t'))
    assert str(t.diff('t').values[-1]) == str(np.complex128(complex(NAN,
                                                                    2)))


def test_f10_complex_quantile_raises_as_numpy():
    j, t = _pair(_complex_values(), dims=('y', 'x'))
    with pytest.raises(TypeError, match='real numbers'):
        j.quantile(0.3)
    with pytest.raises(TypeError, match='real numbers'):
        t.quantile(0.3)


def test_f10_assembled_c12_mean_over_time():
    j = jassemble(nd_tpu.testing.generate_test_dataset())
    t = assemble_complex(ndt.testing.generate_test_dataset(device='cpu'))
    for name in ('mean', 'std', 'median', 'max', 'argmax'):
        got = getattr(t, name)('time')
        ref = _quiet(lambda: getattr(j, name)('time'))
        same(got, ref, rtol=1e-12)
    assert t['C12'].mean('time').dtype == torch.complex128


def test_f10_complex_arithmetic_with_nan_part():
    """Addition and subtraction go part by part, as numpy's."""
    v = np.array([2j, complex(NAN, 0), 1 + 1j, complex(0, NAN)])
    w = np.array([complex(NAN, 0), 2j, complex(0, NAN), 3 + 0j])
    (ja, ta), (jb, tb) = _pair(v), _pair(w)
    for op in (lambda a, b: a + b, lambda a, b: a - b,
               lambda a, b: a - 1.5, lambda a, b: 2 - a,
               lambda a, b: a + (1 - 2j)):
        got, ref = op(ta, tb), op(ja, jb)
        np.testing.assert_array_equal(
            np.isnan(got.values.real), np.isnan(ref.values.real))
        np.testing.assert_array_equal(
            np.isnan(got.values.imag), np.isnan(ref.values.imag))
        same(got, ref)


# -- F11: round, argmin/argmax, clip -----------------------------------------

ROUND_CASES = {
    'int32': np.array([15, 25, -35, 7, 2 ** 31 - 1], np.int32),
    'uint8': np.array([15, 250, 7, 0], np.uint8),
    'int64': np.array([1234567, -5, 45], np.int64),
    'bool': np.array([True, False, True]),
    'complex128': np.array([1.25 + 2.35j, 2.5 - 0.5j, complex(NAN, 1.55)]),
    'complex64': np.array([1.25 + 2.35j, -0.5 - 1.5j], np.complex64),
    'float32': np.array([1.25, 2.5, -0.5, NAN], np.float32),
    'float16': np.array([1.26, 2.5, 3.5], np.float16),
}


@pytest.mark.parametrize('case,decimals', [
    (c, d) for c in sorted(ROUND_CASES) for d in (0, 1, -1)
    if c != 'bool' or d == 0])           # numpy refuses bool at decimals
def test_f11_round(case, decimals):
    j, t = _pair(ROUND_CASES[case])
    _exact(t.round(decimals), j.round(decimals))


def test_f11_dataset_round():
    ref = JDataset({'a': ('t', ROUND_CASES['int32']),
                    'b': ('t', ROUND_CASES['bool'][[0, 1, 2, 0, 1]])})
    got = Dataset({'a': ('t', ROUND_CASES['int32']),
                   'b': ('t', ROUND_CASES['bool'][[0, 1, 2, 0, 1]])},
                  device='cpu')
    for v in ('a', 'b'):
        _exact(got.round()[v], ref.round()[v])


@pytest.mark.parametrize('name', ['argmin', 'argmax'])
@pytest.mark.parametrize('dim', [None, 'x', 'y'])
def test_f11_bool_argmin_argmax(name, dim):
    rng = np.random.RandomState(3)
    v = rng.rand(4, 6) > 0.5
    v[1] = True
    v[2] = False
    j, t = _pair(v, dims=('y', 'x'))
    _exact(getattr(t, name)(dim), getattr(j, name)(dim))
    ds_j = JDataset({'m': (('y', 'x'), v)})
    ds_t = Dataset({'m': (('y', 'x'), v)}, device='cpu')
    _exact(getattr(ds_t, name)(dim)['m'], getattr(ds_j, name)(dim)['m'])


CLIP_BOUNDS = [(0, 2), (0.5 + 0.5j, 2 + 2j), (None, 1), (-1.5, None),
               (2, 0)]


@pytest.mark.parametrize('bounds', CLIP_BOUNDS)
def test_f11_complex_clip(bounds):
    v = np.array([1 + 5j, -2 + 1j, 3 - 3j, 0.5 + 0j, complex(NAN, 1),
                  complex(2, NAN), complex(5, NAN), 2 + 0.7j, -1.5 - 1j])
    j, t = _pair(v)
    got, ref = t.clip(*bounds), j.clip(*bounds)
    _exact(got, ref)
    np.testing.assert_array_equal(np.isnan(got.values.imag),
                                  np.isnan(ref.values.imag))


@pytest.mark.parametrize('bounds', [(2, 7), (2.5, 7.5), (2, None),
                                    (np.float32(2.5), None)])
@pytest.mark.parametrize('dtype', ['int32', 'uint8', 'float32', 'bool'])
def test_f11_clip_dtype(bounds, dtype):
    v = np.array([1, 5, 9, 0], dtype)
    j, t = _pair(v)
    _exact(t.clip(*bounds), j.clip(*bounds))


# -- F12: Dataset.apply ------------------------------------------------------

def test_f12_dataset_apply_is_map():
    j, t = pair_ds(shape=(4, 5, 6))
    same(t.apply(lambda da, k: da * k + 1, k=3.0),
         j.apply(lambda da, k: da * k + 1, k=3.0))
    same(t.apply(lambda da: da.mean('time')),
         _quiet(lambda: j.apply(lambda da: da.mean('time'))))
    same(t.apply(lambda da: da.isel(time=0)),
         j.map(lambda da: da.isel(time=0)))


# -- F13, F13b: numpy's type promotion -----------------------------------------

SCALARS = [1.5, 2, True, 1 - 2j, np.float32(1.5), np.float64(0.25),
           np.int16(3)]
DTYPES = ['bool', 'int8', 'int16', 'int32', 'int64', 'uint8', 'uint16',
          'float16', 'float32', 'float64', 'complex64']


def _arr(dtype, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(6) * 4 + 1).astype(dtype)


@pytest.mark.parametrize('scalar', SCALARS, ids=repr)
@pytest.mark.parametrize('dtype', DTYPES)
def test_f13_payload_with_a_scalar(dtype, scalar):
    j, t = _pair(_arr(dtype))
    ops = [lambda a: a + scalar, lambda a: a * scalar, lambda a: a / scalar]
    if dtype != 'bool' or not isinstance(scalar, (bool, np.bool_)):
        ops.append(lambda a: a - scalar)     # numpy refuses bool - bool
    if not isinstance(scalar, np.generic):   # numpy's scalar would take
        ops.append(lambda a: scalar * a)     # the DataArray as an array
    for op in ops:
        ref = _quiet(lambda: op(j))
        got = op(t)
        _exact_dtype(got, ref)
        same(got, ref, rtol=1e-6 if 'float16' in (dtype,) else 1e-12)


def _exact_dtype(got, ref):
    assert np.asarray(got.values).dtype == np.asarray(ref.values).dtype, \
        (np.asarray(got.values).dtype, np.asarray(ref.values).dtype)


@pytest.mark.parametrize('other', DTYPES)
@pytest.mark.parametrize('dtype', DTYPES)
def test_f13b_payload_with_a_payload(dtype, other):
    (ja, ta), (jb, tb) = _pair(_arr(dtype, 1)), _pair(_arr(other, 2))
    for op in (lambda a, b: a + b, lambda a, b: a * b,
               lambda a, b: a / b, lambda a, b: a < b):
        ref = _quiet(lambda: op(ja, jb))
        got = op(ta, tb)
        _exact_dtype(got, ref)
        same(got, ref, rtol=1e-3 if 'float16' in (dtype, other) else 1e-6)


PROMOTION_TABLE = [
    ('int32', 1.5, '+', torch.float64), ('int32', 0.5, '**', torch.float64),
    ('int32', 'float32', '+', torch.float64),
    ('int8', 'float32', '+', torch.float32),
    ('int16', 'float32', '+', torch.float32),
    ('uint8', 'float32', '+', torch.float32),
    ('bool', 'float32', '+', torch.float32),
    ('float32', 1.5, '+', torch.float32), ('int32', 2, '+', torch.int32),
    ('uint16', 1e-4, '*', torch.float64)]


@pytest.mark.parametrize('dtype,other,op,expect', PROMOTION_TABLE)
def test_f13_promotion_table(dtype, other, op, expect):
    (ja, ta) = _pair(_arr(dtype))
    if isinstance(other, str):
        jb, tb = _pair(_arr(other, 3))
    else:
        jb = tb = other
    fn = {'+': lambda a, b: a + b, '*': lambda a, b: a * b,
          '**': lambda a, b: a ** b}[op]
    got = fn(ta, tb)
    assert got.dtype == expect
    _exact_dtype(got, fn(ja, jb))
    assert result_dtype(ta.data, tb.data if isinstance(tb, DataArray)
                        else tb) == expect


def test_f13_dataset_and_reflexive_ops():
    j, t = pair_ds(shape=(3, 4, 5))
    for ds in (j, t):
        ds['m'] = (('y', 'x'), np.arange(12, dtype=np.int32).reshape(3, 4))
    for op in (lambda d: d * 1e-4, lambda d: 1.5 - d, lambda d: d ** 0.5,
               lambda d: d['m'] + d['C11'].astype('float32'),
               lambda d: d / d['m'].astype('float32')):
        ref = _quiet(lambda: op(j))
        got = op(t)
        for v in (ref.data_vars if isinstance(ref, JDataset) else [None]):
            g, r = (got[v], ref[v]) if v else (got, ref)
            _exact_dtype(g, r)
            same(g, r, rtol=1e-6)


def test_f13_result_keeps_the_payload_device():
    _, t = _pair(_arr('int32'))
    got = t + 1.5
    assert got.data.device.type == 'cpu' and got.dtype == torch.float64
    m = DataArray(torch.ones(6, dtype=torch.int32, device='meta'),
                  dims=('t',))
    assert (m * 0.5).data.device.type == 'meta'
    assert (m * 0.5).dtype == torch.float64


# -- F14: numpy input to ops.interp ------------------------------------------

def _interp_inputs(dtype=np.float32):
    rng = np.random.RandomState(7)
    v = rng.normal(0, 1, (2, 17, 23)).astype(dtype)
    rows = rng.uniform(-1, 17, (9, 11)).astype(dtype)
    cols = rng.uniform(-1, 23, (9, 11)).astype(dtype)
    return v, rows, cols


@pytest.mark.parametrize('method', ['nearest', 'bilinear', 'cubic'])
def test_f14_map_coordinates_takes_numpy(method):
    v, rows, cols = _interp_inputs()
    ref = np.asarray(J.map_coordinates(v, rows, cols, method=method))
    got = T.map_coordinates(v, rows, cols, method=method, device='cpu')
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('method', ['bilinear', 'average'])
def test_f14_matmul_resample_takes_numpy(method):
    v = _interp_inputs()[0]
    wy, wym, vy = J.axis_weights(np.linspace(-1.5, 17.5, 11), 17, method)
    wx, wxm, vx = J.axis_weights(np.linspace(-0.7, 22.8, 13), 23, method)
    expected = 4.0 if method == 'bilinear' else 1.0
    args = (wy, wym, wx, wxm, vy, vx, np.nan)
    kw = dict(expected=expected, skipna=method == 'average')
    ref = np.asarray(J.matmul_resample(v, *args, **kw))
    got = T.matmul_resample(v, *args, device='cpu', **kw)
    assert got.device.type == 'cpu'
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('stat', ['med', 'max', 'mode'])
def test_f14_footprint_resample_takes_numpy(stat):
    v = np.round(_interp_inputs(np.float64)[0] * 2)
    plan = J.footprint_axis(np.arange(-0.4, 21, 2.6), 17, 2.6) \
        + J.footprint_axis(np.arange(0.3, 23, 2.6), 23, 2.6)
    ref = np.asarray(J.footprint_resample(v, *plan, stat=stat, cval=-5.0))
    got = T.footprint_resample(v, *plan, stat=stat, cval=-5.0, device='cpu')
    assert got.device.type == 'cpu'
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


def test_f14_numpy_lands_on_the_card_by_default():
    v, rows, cols = _interp_inputs()
    if torch.cuda.is_available():
        assert T.map_coordinates(v, rows, cols).device.type == 'cuda'
        return
    with pytest.raises((AssertionError, RuntimeError), match='CUDA'):
        T.map_coordinates(v, rows, cols)


# -- F15: positional order -----------------------------------------------------

def test_f15_open_netcdf_file_third_positional_is_chunks(tmp_path):
    from nd_tpu_torch.io.netcdf import open_netcdf_file
    _, t = pair_ds(shape=(4, 5, 3))
    path = os.path.join(tmp_path, 'x.nc')
    ndt.to_netcdf(t, path)
    lazy = open_netcdf_file(path, True, {}, 'cpu')
    assert lazy._variables['C11'].is_lazy
    eager = open_netcdf_file(path, True, None, 'cpu')
    assert not eager._variables['C11'].is_lazy
    np.testing.assert_array_equal(lazy['C11'].values, eager['C11'].values)


def test_f15_exact_fifth_positional_is_capacity():
    from nd_tpu.ops.change import change_detection_exact as jexact
    cube = sar_cube(6, 7, 8, seed=61, special=False)
    got = tchange.change_detection_exact(torch.from_numpy(cube), 0.99, 9,
                                         1e-4, 16)
    assert isinstance(got, torch.Tensor)
    ref = np.asarray(jexact(cube, 0.99, 9, 1e-4, 16))
    np.testing.assert_array_equal(got.numpy(), ref)
    flags, count = tchange.change_detection_exact(
        torch.from_numpy(cube), 0.99, 9, 1e-4, None, True)
    assert torch.equal(flags, got) and isinstance(count, int)
