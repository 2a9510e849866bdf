"""nd_tpu_torch.ops.interp against nd_tpu.ops.interp on the CPU, from the
same seeded numpy inputs.

``map_coordinates`` for every method, ``matmul_resample`` on the
separable plans of every method, and every footprint statistic, in
float32 and float64, with NaN and inf pixels and coordinates at and
past every edge. Tolerances: float64 rtol 1e-12; float32 rtol 1e-5,
atol 1e-6; nearest, min, max and mode exact. The host plans
(``axis_weights``, ``footprint_axis``, ``separable_coords``) are the
same numpy code in both packages and must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import interp as J
from nd_tpu_torch.ops import interp as T

METHODS = ['nearest', 'bilinear', 'cubic', 'cubic_spline', 'lanczos']
DTYPES = [np.float32, np.float64]
EXACT = {'nearest', 'min', 'max', 'mode'}


def _tol(dtype, method):
    if method in EXACT:
        return dict(rtol=0, atol=0)
    if dtype == np.float64:
        return dict(rtol=1e-12, atol=1e-12)
    return dict(rtol=1e-5, atol=1e-6)


def _raster(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    v = rng.normal(0, 1, shape).astype(dtype)
    v[..., 3, 4] = np.nan
    v[..., 10, 2] = np.inf
    v[..., 0, -1] = -np.inf
    return v


def _coords(dtype, seed, H=37, W=53):
    """Fractional coordinates inside, on every edge and past it."""
    rng = np.random.RandomState(seed)
    rows = rng.uniform(-3, H + 2, (29, 31))
    cols = rng.uniform(-3, W + 2, (29, 31))
    rows[0, :8] = [0, H - 1, -1e-7, H - 1 + 1e-7, -0.5, H - 0.5, -1, H]
    cols[1, :8] = [0, W - 1, -1e-7, W - 1 + 1e-7, -0.5, W - 0.5, -1, W]
    rows[2, :4] = [0, 0, H - 1, H - 1]
    cols[2, :4] = [0, W - 1, 0, W - 1]
    return rows.astype(dtype), cols.astype(dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('method', METHODS)
def test_map_coordinates_matches_jax(method, dtype):
    v = _raster((2, 3, 37, 53), dtype, seed=1)
    rows, cols = _coords(dtype, seed=2)
    ref = np.asarray(J.map_coordinates(jnp.asarray(v), jnp.asarray(rows),
                                       jnp.asarray(cols), method=method))
    got = T.map_coordinates(torch.from_numpy(v), torch.from_numpy(rows),
                            torch.from_numpy(cols), method=method)
    assert got.dtype == torch.from_numpy(v).dtype
    assert tuple(got.shape) == ref.shape == (2, 3, 29, 31)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, method))
    assert np.isnan(ref).any() and np.isfinite(ref).any()


@pytest.mark.parametrize('method', ['nearest', 'bilinear', 'cubic'])
def test_map_coordinates_integer_raster(method):
    rng = np.random.RandomState(5)
    v = rng.randint(-50, 50, (3, 37, 53)).astype(np.int32)
    rows, cols = _coords(np.float32, seed=6)
    ref = np.asarray(J.map_coordinates(jnp.asarray(v), jnp.asarray(rows),
                                       jnp.asarray(cols), method=method,
                                       cval=0))
    got = T.map_coordinates(torch.from_numpy(v), torch.from_numpy(rows),
                            torch.from_numpy(cols), method=method, cval=0)
    assert str(got.dtype).split('.')[-1] == str(ref.dtype)
    np.testing.assert_allclose(got.numpy(), ref, **_tol(np.float32, method))


@pytest.mark.parametrize('method', METHODS)
def test_map_coordinates_nan_coordinate_is_out_of_range(method):
    """A NaN coordinate takes the fill value. (``nd_tpu``'s nearest
    casts NaN to pixel 0 instead; the port treats it as out of range,
    as every other method does in both packages.)"""
    v = torch.ones(1, 5, 6)
    rows = torch.tensor([[np.nan, 2.0]])
    cols = torch.tensor([[1.0, np.nan]])
    got = T.map_coordinates(v, rows, cols, method=method, cval=-7.0)
    np.testing.assert_array_equal(got.numpy(), [[[-7.0, -7.0]]])


@pytest.mark.parametrize('method', METHODS + ['average'])
def test_host_plans_are_identical(method):
    rng = np.random.RandomState(7)
    coords = np.sort(rng.uniform(-2, 40, 25))
    for a, b in zip(T.axis_weights(coords, 37, method),
                    J.axis_weights(coords, 37, method)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(T.footprint_axis(coords, 37, 1.5),
                    J.footprint_axis(coords, 37, 1.5)):
        np.testing.assert_array_equal(a, b)
    rows = np.repeat(coords[:, None], 9, 1)
    cols = np.repeat(coords[None, :9], 25, 0)
    for a, b in zip(T.separable_coords(rows, cols),
                    J.separable_coords(rows, cols)):
        np.testing.assert_array_equal(a, b)
    assert T.separable_coords(rows, rows) is None


def _plan(method, H=37, W=53):
    rr = np.linspace(-1.5, H + 0.5, 23)        # past both edges
    cc = np.linspace(-0.7, W - 0.2, 41)
    wy, wym, vy = J.axis_weights(rr, H, method)
    wx, wxm, vx = J.axis_weights(cc, W, method)
    expected = {'bilinear': 4.0, 'cubic': 16.0, 'cubic_spline': 16.0,
                'lanczos': 36.0}.get(method, 1.0)
    return (wy, wym, wx, wxm, vy, vx), expected


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('method', METHODS + ['average'])
def test_matmul_resample_matches_jax(method, dtype):
    v = _raster((3, 37, 53), dtype, seed=8)
    plan, expected = _plan(method)
    skipna = method == 'average'
    ref = np.asarray(J.matmul_resample(
        jnp.asarray(v), *[jnp.asarray(a) for a in plan], np.nan,
        expected=expected, skipna=skipna))
    got = T.matmul_resample(torch.from_numpy(v),
                            *[torch.from_numpy(a) for a in plan], np.nan,
                            expected=expected, skipna=skipna)
    assert got.dtype == torch.from_numpy(v).dtype
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == np.float32 \
        else dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), ref, **tol)
    assert np.isnan(ref).any() and np.isfinite(ref).any()


def test_matmul_resample_leaves_the_callers_precision():
    """The products run with every float32-precision switch at full
    precision, and the caller's TF32 switch (the legacy one, as callers
    set it) is back when the call returns."""
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    try:
        with T.full_f32_matmul():
            for obj, attr, full in T._precision_flags():
                assert getattr(obj, attr) == full
        assert matmul.allow_tf32
        plan, expected = _plan('bilinear')
        T.matmul_resample(torch.ones(1, 37, 53),
                          *[torch.from_numpy(a) for a in plan], 0.0,
                          expected=expected)
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = False


def _footprint_plan(H=37, W=53, step=2.6):
    ry = np.arange(-0.4, H + 4, step)            # a last cell past the edge
    cx = np.arange(0.3, W, step)
    return J.footprint_axis(ry, H, step) + J.footprint_axis(cx, W, step)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('stat', ['mode', 'min', 'max', 'med', 'q1', 'q3',
                                  'sum', 'rms'])
def test_footprint_resample_matches_jax(stat, dtype):
    v = _raster((2, 37, 53), dtype, seed=9)
    if stat == 'mode':          # repeated values, so majorities exist
        v = np.round(v * 2).astype(dtype)
    v[:, 20:26, 20:26] = np.nan           # windows with no finite sample
    plan = _footprint_plan()
    ref = np.asarray(J.footprint_resample(
        jnp.asarray(v), *[jnp.asarray(a) for a in plan], stat=stat,
        cval=-5.0))
    got = T.footprint_resample(torch.from_numpy(v),
                               *[torch.from_numpy(a) for a in plan],
                               stat=stat, cval=-5.0)
    assert got.dtype == torch.from_numpy(v).dtype
    np.testing.assert_allclose(got.numpy(), ref, **_tol(dtype, stat))
    assert np.isnan(ref).any() and (ref == -5.0).any()


def test_footprint_all_nodata_window_is_nan():
    plan = _footprint_plan()
    v = torch.full((1, 37, 53), np.nan)
    for stat in ('mode', 'min', 'med', 'sum'):
        out = T.footprint_resample(v, *[torch.from_numpy(a) for a in plan],
                                   stat=stat, cval=-1.0)
        assert torch.isnan(out[..., :-1, :]).all()
        assert (out[..., -1, :] == -1.0).all()      # out-of-range row


def test_grid_from_transforms_is_identical():
    from nd_tpu.crs import CRS as JCRS, Affine as JAffine
    from nd_tpu_torch.crs import CRS, Affine
    dst = (1000.0, 0, 3.0e6, 0, -1000.0, 3.4e6)
    src = (0.05, 0, -10.0, 0, -0.05, 60.0)
    ref = J.grid_from_transforms(JAffine(*dst), (21, 17), JAffine(*src),
                                 src_crs=JCRS.from_epsg(4326),
                                 dst_crs=JCRS.from_epsg(3035), xp=np)
    got = T.grid_from_transforms(Affine(*dst), (21, 17), Affine(*src),
                                 src_crs=CRS.from_epsg(4326),
                                 dst_crs=CRS.from_epsg(3035))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
