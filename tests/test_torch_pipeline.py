"""The SAR change path end to end: nd_tpu_torch against nd_tpu.

``SARChangePipeline.forward``, ``OmnibusTest(ml=3)`` and the README
chain (``NLMeansFilter`` then ``OmnibusTest``) run on the same seeded
cube through both packages. Change maps must be exactly equal; the
NLMeans stage is held to rtol 1e-5, atol 1e-6, and the omnibus stage is
fed the same filtered data on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.change import OmnibusTest as JOmnibusTest
from nd_tpu.core import Dataset as JDataset
from nd_tpu.filters import NLMeansFilter as JNLMeansFilter
from nd_tpu.models.pipeline import SARChangePipeline as JPipeline
import nd_tpu_torch as ndt
from nd_tpu_torch.core import from_jax_dataset
from torch_cubes import sar_cube

VARS = ('C11', 'C12__re', 'C12__im', 'C22')


def _jax_dataset(cube):
    return JDataset({v: (('y', 'x', 'time'), cube[..., i])
                     for i, v in enumerate(VARS)},
                    coords={'time': np.arange(cube.shape[2])},
                    attrs={'source': 'synthetic'})


@pytest.mark.parametrize('shape,alpha', [((20, 17, 12), 0.5),
                                         ((16, 128, 6), 0.9)])
def test_pipeline_forward_matches_jax(shape, alpha):
    cube = sar_cube(*shape, seed=21, special=False)
    ref = np.asarray(JPipeline(ml=3, n=1, alpha=alpha).forward(
        jnp.asarray(cube)))
    got = ndt.SARChangePipeline(ml=3, n=1, alpha=alpha)(
        torch.from_numpy(cube))
    assert got.dtype == torch.bool and tuple(got.shape) == shape
    assert ref.any() or alpha == 0.9
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('ml,alpha', [(3, 0.01), (None, 0.9)])
def test_omnibus_test_matches_jax(ml, alpha):
    cube = sar_cube(14, 19, 12, seed=22, special=False)
    jds = _jax_dataset(cube)
    ref = JOmnibusTest(ml=ml, n=9, alpha=alpha).apply(jds)
    got = ndt.OmnibusTest(ml=ml, n=9, alpha=alpha).apply(
        from_jax_dataset(jds, device='cpu'))
    assert got.dims == ref.dims == ('y', 'x', 'time')
    assert got.attrs == ref.attrs and 'time' in got.coords
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))


def test_omnibus_wrapper_and_complex_input():
    cube = sar_cube(10, 12, 8, seed=23, special=False)
    c12 = (cube[..., 1] + 1j * cube[..., 2]).astype(np.complex64)
    ds = ndt.Dataset({'C11': (('y', 'x', 'time'), cube[..., 0]),
                      'C12': (('y', 'x', 'time'), c12),
                      'C22': (('y', 'x', 'time'), cube[..., 3])},
                     device='cpu')
    got = ndt.omnibus(ds, ml=3, alpha=0.01)
    ref = JOmnibusTest(ml=3, alpha=0.01).apply(_jax_dataset(cube))
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))


def test_readme_chain_matches_jax():
    cube = sar_cube(24, 21, 12, seed=24, special=False)
    jds = _jax_dataset(cube)
    jflt = JNLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2,
                          h=3).apply(jds)
    flt = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2,
                            h=3).apply(from_jax_dataset(jds, device='cpu'))
    for v in VARS:
        np.testing.assert_allclose(flt[v].values, jflt[v].values,
                                   rtol=1e-5, atol=1e-6)
    # the omnibus stage on the same filtered data on both sides
    ref = JOmnibusTest(ml=3, alpha=0.01).apply(jflt)
    got = ndt.OmnibusTest(ml=3, alpha=0.01).apply(
        from_jax_dataset(jflt, device='cpu'))
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))


def test_boxcar_filter_matches_jax():
    from nd_tpu.filters import BoxcarFilter as JBoxcar
    cube = sar_cube(13, 15, 4, seed=25, special=False)
    jds = _jax_dataset(cube)
    ref = JBoxcar(w=3).apply(jds)
    got = ndt.boxcar(from_jax_dataset(jds, device='cpu'), w=3)
    for v in VARS:
        np.testing.assert_allclose(got[v].values, np.asarray(ref[v].values),
                                   rtol=1e-6, atol=1e-7)


def test_load_params_round_trips_init_params():
    params = JPipeline(n_classes=3).init_params(seed=7)
    params = {k: np.asarray(v) for k, v in params.items()}
    model = ndt.SARChangePipeline(n_classes=3).load_params(params)
    for k in ('w', 'b'):
        np.testing.assert_array_equal(model.params()[k], params[k])
    assert {n for n, _ in model.named_parameters()} == {'w', 'b'}
    with pytest.raises(ValueError):
        ndt.SARChangePipeline(n_classes=2).load_params(params)
