"""The method-style API, ``ds.nd.*`` and ``ds.filter.*``, of nd_tpu_torch
against nd_tpu's, on the same seeded covariance cube with the JAX
package's geo metadata.

The README chain (``ds.nd.as_complex()``, then ``ds.filter.nlmeans(r=2,
f=1, sigma=2, h=3).nd.change_omnibus(ml=3)``) is held to the tolerances
``test_torch_pipeline.py`` holds the same chain to: the NLMeans stage
within rtol 1e-5, atol 1e-6, and change maps exactly equal when the
omnibus stage is fed the same filtered data on both sides. The warp
methods are held as in ``test_torch_warp.py``. Each accessor whose
module is not ported yet raises and names its ROADMAP item.
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


@pytest.mark.parametrize('method,item', [
    ('to_rgb', 15), ('to_video', 15), ('plot_map', 15),
])
def test_unported_methods_raise_naming_their_item(method, item):
    _, t = _pair()
    with pytest.raises(NotImplementedError,
                       match='ROADMAP item %d' % item):
        getattr(t.nd, method)(None)
