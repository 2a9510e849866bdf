"""nd_tpu_torch.warp against nd_tpu.warp on the CPU: Reprojection,
Resample and Coregistration of ``generate_test_dataset`` cubes made from
the same seed in both packages (the port's generator repeats the same
draws), at odd shapes, with integer, float16, complex, NaN and inf
variables.

Tolerances: float64 rtol 1e-12; float32 and float16 (computed in
float32) rtol 1e-5, atol 1e-6; nearest, min, max, mode and integer
variables exact; coregistration shifts equal. Coordinates and the
georeferencing attrs must match too.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu import warp as J
from nd_tpu.testing import generate_test_dataset as jgen
import nd_tpu_torch as ndt
from nd_tpu_torch import warp as T
from nd_tpu_torch.testing import generate_test_dataset as tgen

ODD = {'y': 37, 'x': 53, 'time': 3}


def _pair(dims=ODD, dtype=np.float32, seed=42, special=True, **kw):
    """The same cube in both packages: nd_tpu's with device arrays, the
    port's on the CPU. ``special`` puts NaN and +-inf pixels in C11."""
    j = jgen(dims=dims, random_seed=seed, **kw)
    t = tgen(dims=dims, random_seed=seed, device='cpu', **kw)
    for v in list(j.data_vars):
        a = np.asarray(j[v].values).astype(dtype)
        np.testing.assert_array_equal(t[v].values.astype(dtype), a)
        if special and v == 'C11':
            a[3, 4] = np.nan
            a[10, 7] = np.inf
            a[-1, -2] = -np.inf
        j[v] = (j[v].dims, jnp.asarray(a))
        t[v] = (j[v].dims, torch.from_numpy(a.copy()))
    return j, t


def _tol(dtype, method='bilinear'):
    if method in ('nearest', 'min', 'max', 'mode') or \
            np.dtype(dtype).kind in 'iu':
        return dict(rtol=0, atol=0)
    if dtype == np.float64:
        return dict(rtol=1e-12, atol=1e-12)
    if dtype == np.float16:
        # both round one float32 result to float16
        return dict(rtol=1e-3, atol=1e-3)
    return dict(rtol=1e-5, atol=1e-6)


def _assert_same(got, ref, dtype, method='bilinear'):
    assert set(got.data_vars) == set(ref.data_vars)
    for v in ref.data_vars:
        r = np.asarray(ref[v].values)
        g = got[v].values
        assert got[v].dims == ref[v].dims, v
        assert g.dtype == r.dtype, (v, g.dtype, r.dtype)
        np.testing.assert_allclose(g, r, err_msg=v, **_tol(dtype, method))
    assert sorted(got.coords) == sorted(ref.coords)
    for c in ('x', 'y', 'lat', 'lon'):
        if c in ref.coords:
            np.testing.assert_array_equal(got.coords[c].values,
                                          np.asarray(ref.coords[c].values))
    assert set(got.attrs) == set(ref.attrs)
    for k in ('transform', 'crs', 'res', 'bounds', 'lines', 'samples'):
        if k in ref.attrs:
            assert got.attrs[k] == ref.attrs[k], k


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('crs', ['epsg:3395', 'epsg:3035', 'epsg:32631'])
@pytest.mark.parametrize('method', ['bilinear', 'nearest', 'cubic',
                                    'cubic_spline', 'lanczos'])
def test_reprojection_matches_jax(crs, method, dtype):
    j, t = _pair(dtype=dtype)
    ref = J.Reprojection(crs=crs, resampling=method).apply(j)
    got = ndt.Reprojection(crs=crs, resampling=method).apply(t)
    _assert_same(got, ref, dtype, method)
    assert got['C11'].data.device.type == 'cpu'
    assert got.coords['lat'].data.device.type == 'cpu'


@pytest.mark.parametrize('dtype', [np.int16, np.int32, np.float16])
def test_reprojection_integer_and_half_variables(dtype):
    if np.dtype(dtype).kind == 'i':
        j = jgen(dims=ODD)
        t = tgen(dims=ODD, device='cpu')
        for v in list(j.data_vars):
            a = np.round(np.asarray(j[v].values) * 100).astype(dtype)
            j[v] = (j[v].dims, jnp.asarray(a))
            t[v] = (j[v].dims, torch.from_numpy(a.copy()))
    else:
        j, t = _pair(dtype=dtype)
    for crs in ('epsg:3395', 'epsg:3035'):
        ref = J.Reprojection(crs=crs).apply(j)
        got = ndt.Reprojection(crs=crs).apply(t)
        _assert_same(got, ref, dtype)


def test_reprojection_of_complex_and_mixed_variables():
    j, t = _pair(dims={'y': 24, 'x': 31, 'time': 2}, special=False)
    c = np.asarray(j['C12__re'].values) + 1j * np.asarray(
        j['C12__im'].values)
    j['C12'] = (j['C11'].dims, jnp.asarray(c.astype(np.complex64)))
    t['C12'] = (j['C11'].dims, torch.from_numpy(c.astype(np.complex64)))
    two = np.asarray(j['C22'].values)[:, :, 0].astype(np.float64)
    j['flat'] = (('y', 'x'), jnp.asarray(two))
    t['flat'] = (('y', 'x'), torch.from_numpy(two.copy()))
    ref = J.Reprojection(crs='epsg:3035').apply(j)
    got = ndt.Reprojection(crs='epsg:3035').apply(t)
    assert got['C12'].dtype == torch.complex64
    assert got['flat'].dtype == torch.float64
    for v in ('C12', 'C11'):
        np.testing.assert_allclose(got[v].values, np.asarray(ref[v].values),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got['flat'].values,
                               np.asarray(ref['flat'].values), rtol=1e-12)


@pytest.mark.parametrize('method', ['bilinear', 'cubic'])
def test_reprojection_of_a_dataarray(method):
    j, t = _pair(special=True)
    jda, tda = j['C11'], t['C11']
    jda.attrs.update(j.attrs)
    tda.attrs.update(t.attrs)
    ref = J.reproject(jda, crs='epsg:3035', resampling=method)
    got = ndt.reproject(tda, crs='epsg:3035', resampling=method)
    assert isinstance(got, ndt.DataArray) and got.dims == ref.dims
    np.testing.assert_allclose(got.values, np.asarray(ref.values),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('kwargs', [
    dict(extent=(-8.0, 52.0, -2.0, 58.0), res=0.13),
    dict(extent=(-8.0, 52.0, -2.0, 58.0), width=40, height=30),
    dict(width=61),
    dict(height=23),
])
def test_reprojection_grid_parameterisations(kwargs):
    j, t = _pair()
    ref = J.Reprojection(crs='epsg:4326', **kwargs).apply(j)
    got = ndt.Reprojection(crs='epsg:4326', **kwargs).apply(t)
    _assert_same(got, ref, np.float32)


def test_reprojection_onto_a_target_grid():
    j, t = _pair()
    jt = J.Reprojection(crs='epsg:3035').apply(
        jgen(dims={'y': 20, 'x': 25, 'time': 3}, random_seed=5))
    tt = ndt.Reprojection(crs='epsg:3035').apply(
        tgen(dims={'y': 20, 'x': 25, 'time': 3}, random_seed=5,
             device='cpu'))
    ref = J.Reprojection(target=jt).apply(j)
    got = ndt.Reprojection(target=tt).apply(t)
    _assert_same(got, ref, np.float32)
    assert got.sizes['y'] == 20 and got.sizes['x'] == 25


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('method', ['average', 'mode', 'min', 'max', 'med',
                                    'q1', 'q3', 'sum', 'rms', 'bilinear',
                                    'nearest'])
def test_resample_matches_jax(method, dtype):
    j, t = _pair(dtype=dtype)
    if method == 'mode':
        for ds in (j, t):
            for v in list(ds.data_vars):
                ds[v] = (ds[v].dims, ds[v].data * 0 + (ds[v].data > 0))
    ref = J.Resample(res=(0.4, 0.4), resampling=method).apply(j)
    got = ndt.Resample(res=(0.4, 0.4), resampling=method).apply(t)
    _assert_same(got, ref, dtype, method)


def test_resample_by_width_keeps_the_aspect():
    j, t = _pair()
    ref = J.resample(j, width=20)
    got = ndt.resample(t, width=20)
    _assert_same(got, ref, np.float32)
    assert got.sizes['x'] == 20


def test_resample_integer_footprint_restores_the_dtype():
    j = jgen(dims=ODD)
    t = tgen(dims=ODD, device='cpu')
    for v in list(j.data_vars):
        a = np.round(np.asarray(j[v].values) * 3).astype(np.int32)
        j[v] = (j[v].dims, jnp.asarray(a))
        t[v] = (j[v].dims, torch.from_numpy(a.copy()))
    for method in ('med', 'mode'):
        ref = J.Resample(res=0.9, resampling=method).apply(j)
        got = ndt.Resample(res=0.9, resampling=method).apply(t)
        _assert_same(got, ref, np.int32, method)


def test_resample_integer_average_differs_only_at_half_ties():
    """An integer 'average' is the float mean restored by rint. Where
    that mean is a tie (k + 0.5), the two packages' products round
    the weights 1/count in another order and rint may go either way:
    there, and only there, the results may differ, by 1."""
    j = jgen(dims=ODD)
    t = tgen(dims=ODD, device='cpu')
    for v in list(j.data_vars):
        a = np.round(np.asarray(j[v].values) * 3).astype(np.int32)
        j[v] = (j[v].dims, jnp.asarray(a))
        t[v] = (j[v].dims, torch.from_numpy(a.copy()))
    ref = J.Resample(res=0.9, resampling='average').apply(j)
    got = ndt.Resample(res=0.9, resampling='average').apply(t)
    mean = ndt.Resample(res=0.9, resampling='average').apply(
        t.astype('float64'))
    for v in ref.data_vars:
        r, g = np.asarray(ref[v].values), got[v].values
        assert g.dtype == r.dtype == np.int32
        tie = np.abs(np.abs(mean[v].values % 1) - 0.5) < 1e-6
        assert np.all((g == r) | tie), v
        assert np.abs(g.astype(int) - r).max() <= 1


def test_footprint_on_a_curvilinear_warp_raises():
    _, t = _pair()
    with pytest.raises(NotImplementedError, match='separable'):
        ndt.Reprojection(crs='epsg:3035', resampling='med').apply(t)
    with pytest.raises(ValueError, match='unsupported resampling'):
        ndt.Reprojection(crs='epsg:3035', resampling='gauss').apply(t)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('dims,reference', [
    ({'y': 37, 'x': 53, 'time': 4}, 0),
    ({'y': 64, 'x': 48, 'time': 5}, 2),
])
def test_coregistration_matches_jax(dims, reference, dtype):
    j, t = _pair(dims=dims, dtype=dtype, special=False)
    ref = J.Coregistration(reference=reference, upsampling=10).apply(j)
    got = ndt.Coregistration(reference=reference, upsampling=10).apply(t)
    _assert_same(got, ref, dtype)
    np.testing.assert_array_equal(got['C22'].values[..., reference],
                                  t['C22'].values[..., reference])


def test_coregistration_shifts_equal_and_recover_known_shifts():
    """Shift a band-limited C11 series by known sub-pixel amounts: both
    packages estimate the same shifts, within 0.2 px of the truth, and
    register the series alike."""
    from nd_tpu.ops.fft import phase_cross_correlation_batch as jpcc
    from nd_tpu_torch.ops.fft import phase_cross_correlation_batch as tpcc
    H, W = 48, 64
    base = np.random.RandomState(9).rand(H, W)
    F = np.fft.fft2(base)
    F[6:-5, :] = 0
    F[:, 6:-5] = 0
    true = np.array([[0.0, 0.0], [1.3, -2.7], [-0.4, 0.8], [3.25, 1.75]])
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    series = np.stack([np.real(np.fft.ifft2(
        F * np.exp(-2j * np.pi * (fy * dy + fx * dx)))) for dy, dx in true],
        axis=-1).astype(np.float32)                         # (y, x, time)
    dims = {'y': H, 'x': W, 'time': 4}
    j, t = _pair(dims=dims, special=False)
    j['C11'] = (('y', 'x', 'time'), jnp.asarray(series))
    t['C11'] = (('y', 'x', 'time'), torch.from_numpy(series.copy()))
    ser = np.moveaxis(series, -1, 0)
    js = np.asarray(jpcc(jnp.asarray(ser), jnp.asarray(ser[0]), 10))
    ts = tpcc(torch.from_numpy(ser), torch.from_numpy(ser[0]), 10).numpy()
    np.testing.assert_array_equal(ts, js)
    assert np.abs(ts - true).max() <= 0.2
    ref = J.coregister(j, reference=0, upsampling=10)
    got = ndt.coregister(t, reference=0, upsampling=10)
    _assert_same(got, ref, np.float32)


def test_coregistration_of_integer_and_complex_variables():
    """Integer variables are resampled in float32 and truncated back, as
    in ``nd_tpu``. Truncation splits float32 results at whole numbers
    (a constant patch comes out as 33 - 1 ulp or 33 + 1 ulp, by the
    order of the taps' sums), so there, and only there, the packages
    may differ, by 1."""
    j, t = _pair(dims={'y': 40, 'x': 44, 'time': 3}, special=False)
    a = np.round(np.asarray(j['C22'].values) * 50).astype(np.int32)
    j['C22'] = (j['C22'].dims, jnp.asarray(a))
    t['C22'] = (j['C22'].dims, torch.from_numpy(a.copy()))
    ref = J.Coregistration().apply(j)
    got = ndt.Coregistration().apply(t)
    assert got['C22'].dtype == torch.int32
    for v in ('C11', 'C12__re', 'C12__im'):
        np.testing.assert_allclose(got[v].values, np.asarray(ref[v].values),
                                   rtol=1e-5, atol=1e-6)
    t['C22'] = (j['C22'].dims, torch.from_numpy(a.astype(np.float32)))
    fv = ndt.Coregistration().apply(t)['C22'].values
    whole = np.abs(fv - np.round(fv)) <= 1e-4 * np.maximum(1, np.abs(fv))
    g, r = got['C22'].values, np.asarray(ref['C22'].values)
    assert np.all((g == r) | whole)
    assert np.abs(g.astype(int) - r).max() <= 1
    # complex C12 comes back split, as from disassemble_complex
    c = ndt.assemble_complex(t)
    out = ndt.Coregistration().apply(c)
    assert 'C12__re' in out.data_vars and 'C12' not in out.data_vars


def test_getters_match_jax():
    j, t = _pair()
    assert T.get_crs(t) == T.CRS.from_epsg(4326)
    assert tuple(T.get_bounds(t)) == tuple(J.get_bounds(j))
    assert tuple(T.get_extent(t)) == tuple(J.get_extent(j))
    assert tuple(T.get_resolution(t)) == tuple(J.get_resolution(j))
    assert tuple(T.get_transform(t)) == tuple(J.get_transform(j))
    assert T.get_crs(t, 'proj') == J.get_crs(j, 'proj')
    assert T.get_crs(t, 'wkt') == J.get_crs(j, 'wkt')
    jr = J.Reprojection(crs='epsg:3035').apply(j)
    tr = ndt.Reprojection(crs='epsg:3035').apply(t)
    assert tuple(T.get_extent(tr)) == tuple(J.get_extent(jr))
    assert tuple(T.get_common_bounds([tr, t])) == \
        tuple(J.get_common_bounds([jr, j]))
    assert tuple(T.get_common_extent([t, t])) == \
        tuple(J.get_common_extent([j, j]))
    assert T.get_common_resolution([t, t], 'mean') == \
        J.get_common_resolution([j, j], 'mean')
    want = J.calculate_default_transform('epsg:4326', 'epsg:3035', 53, 37,
                                         -10, 50, 0, 60)
    got = T.calculate_default_transform('epsg:4326', 'epsg:3035', 53, 37,
                                        -10, 50, 0, 60)
    assert tuple(got[0]) == tuple(want[0]) and got[1:] == want[1:]


def test_get_geometry_matches_jax():
    """get_geometry is the grid's box as nd_tpu builds it."""
    from nd_tpu.vector.geometry import mapping as jmapping
    from nd_tpu_torch.vector.geometry import mapping as tmapping
    j, t = _pair()
    for crs in ({'init': 'epsg:4326'}, 'epsg:3035'):
        got, want = T.get_geometry(t, crs=crs), J.get_geometry(j, crs=crs)
        assert got.geom_type == want.geom_type == 'Polygon'
        assert tmapping(got) == jmapping(want)


def _products(tmp_path):
    """Two products in both packages: the cube and a copy shifted by a
    fraction of a pixel, each also written to netCDF by its package."""
    from nd_tpu import io as jio
    from nd_tpu_torch import io as tio
    dims = {'y': 23, 'x': 29, 'time': 2}
    a = _pair(dims=dims, special=False, extent=(10.0, 50.0, 12.0, 52.0))
    b = _pair(dims=dims, special=False, seed=7,
              extent=(10.37, 49.81, 12.37, 51.81))
    files = {'j': [], 't': []}
    for name, (j, t) in (('a', a), ('b', b)):
        for key, write, ds in (('j', jio.to_netcdf, j), ('t', tio.to_netcdf, t)):
            path = str(tmp_path / ('%s_%s.nc' % (key, name)))
            write(ds, path)
            files[key].append(path)
    return a, b, files


def _aligned_equal(got, ref, exact):
    """Port output (``got``) against nd_tpu's or the port's own."""
    assert set(got.data_vars) == set(ref.data_vars)
    for v in ref.data_vars:
        g, r = got[v].values, np.asarray(ref[v].values)
        assert got[v].dims == ref[v].dims and g.dtype == r.dtype, v
        if exact:
            np.testing.assert_array_equal(g, r, err_msg=v)
        else:
            np.testing.assert_allclose(g, r, err_msg=v, **_tol(r.dtype))
    for c in ref.coords:
        np.testing.assert_array_equal(got.coords[c].values,
                                      np.asarray(ref.coords[c].values))
    assert set(got.attrs) == set(ref.attrs)
    for k in ref.attrs:
        assert np.array_equal(np.asarray(got.attrs[k]),
                              np.asarray(ref.attrs[k])), k


@pytest.mark.parametrize('source', ['datasets', 'files'])
def test_align_matches_jax_and_in_memory_reprojection(tmp_path, source):
    """``align`` writes ``<name>_aligned.nc`` per product: the port's
    files equal its own Reprojection of the products onto the common
    grid, exactly, and nd_tpu's files within the warp's tolerances."""
    from nd_tpu import io as jio
    from nd_tpu_torch import io as tio
    a, b, files = _products(tmp_path)
    if source == 'files':
        jsrc, tsrc, names = files['j'], files['t'], ['%s_a', '%s_b']
    else:
        jsrc, tsrc, names = [a[0], b[0]], [a[1], b[1]], ['data0', 'data1']
    J.align(jsrc, str(tmp_path / 'j_out'))
    ndt.warp.Alignment(device='cpu').apply(tsrc, str(tmp_path / 't_out'))
    grid = dict(extent=T.get_common_bounds([a[1], b[1]]),
                res=T.get_common_resolution([a[1], b[1]]),
                dst_crs=T.get_crs(a[1]))
    for name, (_, t) in zip(names, (a, b)):
        jname = name % 'j' if '%' in name else name
        tname = name % 't' if '%' in name else name
        got = tio.open_netcdf(str(tmp_path / 't_out' / (tname + '_aligned.nc')),
                              device='cpu')
        ref = jio.open_netcdf(str(tmp_path / 'j_out' / (jname + '_aligned.nc')))
        _aligned_equal(got, ref, exact=False)
        mem = ndt.Reprojection(**grid).apply(t)
        for v in mem.data_vars:
            np.testing.assert_array_equal(got[v].values, mem[v].values)


def test_align_of_a_glob_and_of_nothing(tmp_path):
    a, b, files = _products(tmp_path)
    T.align(str(tmp_path / 't_*.nc'), str(tmp_path / 'out'), device='cpu')
    assert sorted(os.listdir(str(tmp_path / 'out'))) == \
        ['t_a_aligned.nc', 't_b_aligned.nc']
    with pytest.raises(ValueError, match='nothing to align'):
        T.align(str(tmp_path / 'none_*.nc'), str(tmp_path / 'out'))


def test_plan_caches_are_keyed_by_device():
    """Every cache of tensors takes the device in its key, so a CPU call
    is never handed a CUDA tensor (the card's half is in
    test_torch_cuda.py)."""
    _, t = _pair()
    caches = (T._cached_plan, T._cached_grid, T._cached_footprint_plan)
    for cache in caches:
        cache.cache_clear()
    ndt.Reprojection(crs='epsg:3395').apply(t)          # matmul plan
    ndt.Reprojection(crs='epsg:3035').apply(t)          # gather grid
    ndt.Resample(res=0.4, resampling='med').apply(t)    # footprint plan
    for cache in caches:
        assert cache.cache_info().currsize >= 1
        assert 'device' in cache.__wrapped__.__code__.co_varnames
    ident = (1.0, 0, 0.0, 0, -1.0, 0.0)
    wgs = T.CRS.from_epsg(4326).to_proj4()
    rows, cols = T._cached_grid(ident, (2, 3), ident, wgs, wgs, '<f4',
                                'cpu')
    assert rows.device.type == 'cpu' and rows.dtype == torch.float32
    np.testing.assert_array_equal(cols.numpy(), [[0, 1, 2], [0, 1, 2]])
