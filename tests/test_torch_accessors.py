"""The method-style API, ``ds.nd.*`` and ``ds.filter.*``, of nd_tpu_torch
against nd_tpu's, on the same seeded covariance cube with the JAX
package's geo metadata.

The README chain (``ds.nd.as_complex()``, then ``ds.filter.nlmeans(r=2,
f=1, sigma=2, h=3).nd.change_omnibus(ml=3)``) is held to the tolerances
``test_torch_pipeline.py`` holds the same chain to: the NLMeans stage
within rtol 1e-5, atol 1e-6, and change maps exactly equal when the
omnibus stage is fed the same filtered data on both sides. The warp
methods are held as in ``test_torch_warp.py``. The visualization
methods (``nd.to_rgb``, ``nd.to_video``, ``nd.plot_map``) give images
and GIF files equal to nd_tpu's bit for bit.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nd_tpu  # noqa: F401  (registers nd_tpu's accessors)
from nd_tpu.testing import generate_test_dataset as jgen
import nd_tpu_torch as ndt
from nd_tpu_torch.core import from_jax_dataset
from nd_tpu_torch.testing import generate_test_dataset as tgen
from torch_cubes import sar_cube

VARS = ('C11', 'C12__re', 'C12__im', 'C22')
DIMS = {'y': 24, 'x': 21, 'time': 12}


def _pair(dims=DIMS, seed=24):
    """nd_tpu's and the port's test cube (geo metadata from the shared
    generator) carrying the same S1 covariance series."""
    cube = sar_cube(dims['y'], dims['x'], dims['time'], seed=seed,
                    special=False)
    j = jgen(dims=dims)
    t = tgen(dims=dims, device='cpu')
    for i, v in enumerate(VARS):
        j[v] = (('y', 'x', 'time'), jnp.asarray(cube[..., i]))
        t[v] = (('y', 'x', 'time'), torch.from_numpy(cube[..., i].copy()))
    return j, t


def _assert_close(got, ref, rtol=1e-5, atol=1e-6):
    assert set(got.data_vars) == set(ref.data_vars)
    for v in ref.data_vars:
        np.testing.assert_allclose(got[v].values, np.asarray(ref[v].values),
                                   rtol=rtol, atol=atol, err_msg=v)


def test_readme_chain_matches_jax():
    j, t = _pair()
    jflt = j.filter.nlmeans(r=2, f=1, sigma=2, h=3)
    tflt = t.filter.nlmeans(r=2, f=1, sigma=2, h=3)
    _assert_close(tflt, jflt)
    ref = jflt.nd.change_omnibus(ml=3)
    got = from_jax_dataset(jflt, device='cpu').nd.change_omnibus(ml=3)
    assert got.dims == ref.dims == ('y', 'x', 'time')
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    assert np.asarray(ref.values).any()
    # the whole chain in one expression, as the README writes it
    chain = t.filter.nlmeans(r=2, f=1, sigma=2, h=3).nd.change_omnibus(ml=3)
    np.testing.assert_array_equal(chain.values,
                                  tflt.nd.change_omnibus(ml=3).values)


def test_readme_chain_from_complex_matches_jax():
    j, t = _pair(seed=25)
    jc, tc = j.nd.as_complex(), t.nd.as_complex()
    assert set(tc.data_vars) == set(jc.data_vars) == {'C11', 'C12', 'C22'}
    assert tc['C12'].dtype == torch.complex64
    np.testing.assert_array_equal(tc['C12'].values,
                                  np.asarray(jc['C12'].values))
    jflt = jc.filter.nlmeans(r=2, f=1, sigma=2, h=3)
    tflt = tc.filter.nlmeans(r=2, f=1, sigma=2, h=3)
    _assert_close(tflt, jflt)
    ref = jflt.nd.change_omnibus(ml=3)
    got = from_jax_dataset(jflt, device='cpu').nd.change_omnibus(ml=3)
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    back = tc.nd.as_real()
    assert set(back.data_vars) == set(VARS)
    np.testing.assert_array_equal(back['C12__im'].values,
                                  t['C12__im'].values)


def test_reproject_then_chain_matches_jax():
    """The card path at a small size: reproject to EPSG:3035 (the
    gather), then NLMeans and the omnibus test."""
    j, t = _pair(seed=26)
    jr = j.nd.reproject(crs='epsg:3035')
    tr = t.nd.reproject(crs='epsg:3035')
    _assert_close(tr, jr)
    assert np.isnan(tr['C11'].values).any()          # corners off the map
    jflt = jr.filter.nlmeans(r=2, f=1, sigma=2, h=3)
    tflt = tr.filter.nlmeans(r=2, f=1, sigma=2, h=3)
    _assert_close(tflt, jflt)
    ref = jflt.nd.change_omnibus(ml=3)
    got = from_jax_dataset(jflt, device='cpu').nd.change_omnibus(ml=3)
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))


@pytest.mark.parametrize('method,kwargs', [
    ('resample', dict(res=0.9)),
    ('resample', dict(res=0.9, resampling='med')),
    ('reproject', dict(crs='epsg:3395')),
    ('coregister', dict(reference=1, upsampling=10)),
])
def test_warp_methods_match_jax(method, kwargs):
    j, t = _pair(seed=27)
    ref = getattr(j.nd, method)(**kwargs)
    got = getattr(t.nd, method)(**kwargs)
    _assert_close(got, ref)


@pytest.mark.parametrize('method,kwargs', [
    ('boxcar', dict(w=3)),
    ('gaussian', dict(sigma=1.0)),
    ('convolve', dict(kernel=np.ones((3, 3)) / 9.0)),
])
def test_filter_methods_match_jax(method, kwargs):
    j, t = _pair(seed=28)
    ref = getattr(j.filter, method)(**kwargs)
    got = getattr(t.filter, method)(**kwargs)
    _assert_close(got, ref, rtol=1e-6, atol=1e-7)


def test_properties_match_jax():
    j, t = _pair()
    assert t.nd.crs == ndt.CRS.from_epsg(4326)
    assert tuple(t.nd.bounds) == tuple(j.nd.bounds)
    assert tuple(t.nd.extent) == tuple(j.nd.extent)
    assert tuple(t.nd.resolution) == tuple(j.nd.resolution)
    assert tuple(t.nd.transform) == tuple(j.nd.transform)
    assert t.nd.dims == tuple(j.nd.dims)
    assert t.nd.shape == tuple(j.nd.shape)
    da = t['C11']
    assert da.nd.dims == ('y', 'x', 'time') and da.nd.shape == (24, 21, 12)
    np.testing.assert_array_equal(da.filter.values, da.values)
    assert t.nd is t.nd                   # cached per object


def test_methods_carry_the_functional_signatures():
    acc = ndt.accessors.NDAccessor
    assert 'crs' in inspect.signature(acc.reproject).parameters
    for name, func in (('reproject', ndt.reproject),
                       ('coregister', ndt.coregister),
                       ('change_omnibus', ndt.omnibus)):
        method = getattr(acc, name)
        assert method.__doc__ == func.__doc__
        params = list(inspect.signature(method).parameters)
        assert params[0] == 'self'
        assert params[1:] == list(inspect.signature(func).parameters)[1:]
    flt = ndt.accessors.FilterAccessor
    assert flt.nlmeans.__doc__ == ndt.nlmeans.__doc__


def _visual_pair():
    """The shared generator's cube in both packages (positive C11/C22 for
    the ratio channel's stretch)."""
    dims = {'y': 20, 'x': 26, 'time': 4}
    return jgen(dims=dims, mean=[3, 0, 0, 2]), \
        tgen(dims=dims, mean=[3, 0, 0, 2], device='cpu')


@pytest.mark.parametrize('case', ['dataset', 'dataarray', 'dataarray_rgb',
                                  'options'])
def test_to_rgb_accessor_matches_jax(case):
    """``nd.to_rgb``: the C11 / C22 / ratio default of a Dataset, a
    DataArray alone, a user ``rgb`` applied to a DataArray, and the
    stretch options: images equal to nd_tpu's bit for bit."""
    pytest.importorskip('cv2')
    j, t = _visual_pair()
    j0, t0 = j.isel(time=0), t.isel(time=0)
    if case == 'dataset':
        got, ref = t0.nd.to_rgb(), j0.nd.to_rgb()
    elif case == 'dataarray':
        got, ref = t0['C22'].nd.to_rgb(), j0['C22'].nd.to_rgb()
    elif case == 'dataarray_rgb':
        def rgb(d):
            return [d, d * 2, d * d]
        got, ref = t0['C11'].nd.to_rgb(rgb=rgb), j0['C11'].nd.to_rgb(rgb=rgb)
    else:
        kw = dict(vmin=[0, 0, 0.5], vmax=[6, 4, 2], shape=(10, None))
        got, ref = t0.nd.to_rgb(**kw), j0.nd.to_rgb(**kw)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_to_video_accessor_matches_jax(tmp_path):
    pytest.importorskip('cv2')
    pytest.importorskip('imageio')
    from nd_tpu_torch.testing import assert_equal_files
    j, t = _visual_pair()
    j.nd.to_video(str(tmp_path / 'j.gif'), fps=2)
    t.nd.to_video(str(tmp_path / 't.gif'), fps=2)
    assert_equal_files(str(tmp_path / 't.gif'), str(tmp_path / 'j.gif'))
    j['C11'].nd.to_video(str(tmp_path / 'j1.gif'), timestamp=None)
    t['C11'].nd.to_video(str(tmp_path / 't1.gif'), timestamp=None)
    assert_equal_files(str(tmp_path / 't1.gif'), str(tmp_path / 'j1.gif'))


def test_plot_map_accessor_matches_jax(tmp_path):
    pytest.importorskip('cv2')
    from nd_tpu_torch import visualize
    if visualize.cartopy is not None:
        pytest.skip('cartopy installed: plot_map draws on its axes')
    j, t = _visual_pair()
    got = t.nd.plot_map(buffer=0.5, gridlines=False)
    ref = j.nd.plot_map(buffer=0.5, gridlines=False)
    assert got.shape == ref.shape == (720, 720, 3)
    np.testing.assert_array_equal(got, ref)
    from nd_tpu.testing import generate_test_dataarray as jgen_da
    from nd_tpu_torch.testing import generate_test_dataarray as tgen_da
    dims = {'y': 9, 'x': 7, 'time': 2}
    extent = (20.0, -5.0, 23.0, -1.0)
    np.testing.assert_array_equal(
        tgen_da(dims=dims, extent=extent, device='cpu').nd.plot_map(),
        jgen_da(dims=dims, extent=extent).nd.plot_map())
    # a DataArray without geo metadata raises in both
    for da in (t['C11'], j['C11']):
        with pytest.raises(Exception, match='Could not determine the CRS'):
            da.nd.plot_map()
