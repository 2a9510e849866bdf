"""Parity of nd_tpu_torch's separable convolution with nd_tpu's.

The same numpy inputs (from a seed) go through the JAX function and its
port; where the JAX side reaches a Pallas kernel it runs in interpret
mode. Tolerances:

  - float32: rtol 1e-6, atol 1e-7 (one kernel, the same add order;
    the uniform-tap scaling order may differ from a Pallas variant by
    one rounding);
  - float64: rtol 1e-13.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import conv as jconv
from nd_tpu.ops import conv_pallas as jpallas
from nd_tpu.models.pipeline import multilook as jmultilook
from nd_tpu_torch.ops import conv as tconv
from nd_tpu_torch.ops import conv_cuda
from nd_tpu_torch.models.pipeline import multilook as tmultilook

F32 = dict(rtol=1e-6, atol=1e-7)
F64 = dict(rtol=1e-13, atol=0)
MODES = ['reflect', 'mirror', 'nearest', 'constant', 'wrap']
SHAPES = [(20, 17, 3, 4), (16, 128, 2, 4), (20, 130, 12, 4)]


def _data(shape, dtype=np.float32, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('shape', SHAPES)
def test_boxcar_matches_jax(shape, mode):
    a = _data(shape)
    k = np.ones((3, 3), np.float32) / 9
    ref = np.asarray(jconv.convolve(jnp.asarray(a), k, axes=(0, 1),
                                    mode=mode, cval=0.5))
    got = tconv.convolve(torch.from_numpy(a), k, axes=(0, 1), mode=mode,
                         cval=0.5).numpy()
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize('mode', MODES)
def test_stacked_layout_axes_12_matches_jax(mode):
    # OmnibusTest(ml=3) stacks the four variables: (4, y, x, t), axes (1, 2)
    a = _data((4, 19, 23, 5), seed=1)
    k = np.ones((3, 3)) / 9
    ref = np.asarray(jconv.convolve(jnp.asarray(a), k, axes=(1, 2),
                                    mode=mode))
    got = tconv.convolve(torch.from_numpy(a), k, axes=(1, 2),
                         mode=mode).numpy()
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize('axes', [(0, 1), (1, 2), (2, 3), (1, 0), (0, 2)])
@pytest.mark.parametrize('mode', MODES)
def test_weighted_separable_f64_matches_jax(axes, mode):
    a = _data((11, 13, 6, 3), np.float64, seed=2)
    kern = np.outer([1.0, 2.0, 3.0], [0.5, 1.0, 2.0, 1.0])
    ref = np.asarray(jconv.convolve(jnp.asarray(a), kern, axes=axes,
                                    mode=mode, cval=-1.5))
    got = tconv.convolve(torch.from_numpy(a), kern, axes=axes, mode=mode,
                         cval=-1.5).numpy()
    np.testing.assert_allclose(got, ref, **F64)


def test_three_axis_boxcar_f64_matches_jax():
    a = _data((9, 10, 7, 2), np.float64, seed=3)
    k = np.ones((3, 3, 3)) / 27
    for mode in ('reflect', 'constant'):
        ref = np.asarray(jconv.convolve(jnp.asarray(a), k, axes=(0, 1, 2),
                                        mode=mode, cval=2.0))
        got = tconv.convolve(torch.from_numpy(a), k, axes=(0, 1, 2),
                             mode=mode, cval=2.0).numpy()
        np.testing.assert_allclose(got, ref, **F64)


def test_scale_factor_kernel_matches_jax():
    # a (1, 3) uniform kernel factors into a length-1 scale and 3 taps
    a = _data((12, 9, 2, 2), seed=4)
    k = np.full((1, 3), 0.25)
    ref = np.asarray(jconv.convolve(jnp.asarray(a), k, axes=(0, 1)))
    got = tconv.convolve(torch.from_numpy(a), k, axes=(0, 1)).numpy()
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize('mode', ['reflect', 'mirror', 'nearest',
                                  'constant'])
def test_sepconv_matches_padless_pallas(mode):
    # cval 0: with another fill the padless kernel's x-edge columns read
    # the raw fill where the reference (pad every axis, then pass) reads
    # the y pass of the fill; the port follows the reference
    a = _data((32, 128, 2, 4), seed=5)
    t0 = np.ones(3) / 9
    t1 = np.ones(3)
    ref = np.asarray(jpallas.padless_convolve(
        jnp.asarray(a), [(0, t0), (1, t1)], mode=mode, cval=0.0,
        interpret=True))
    got = conv_cuda.sepconv2(torch.from_numpy(a).reshape(1, 32, 128, 8),
                             t0, t1, mode=mode, cval=0.0)
    np.testing.assert_allclose(got.reshape(a.shape).numpy(), ref, **F32)


@pytest.mark.parametrize('mode', ['wrap', 'reflect'])
def test_sepconv_matches_rowfused_pallas_odd_width(mode):
    a = _data((20, 37, 3, 2), seed=6)
    t0 = np.array([0.25, 0.5, 0.25])
    t1 = np.ones(5) / 5
    ref = np.asarray(jpallas.rowfused_convolve(
        jnp.asarray(a), [(0, t0), (1, t1)], mode=mode, interpret=True))
    got = conv_cuda.sepconv2(torch.from_numpy(a).reshape(1, 20, 37, 6),
                             t0, t1, mode=mode)
    np.testing.assert_allclose(got.reshape(a.shape).numpy(), ref, **F32)


def test_sepconv_matches_separable_pallas_stacked():
    a = _data((4, 17, 21, 5), seed=7)
    t = np.ones(3) / 3
    ref = np.asarray(jpallas.separable_convolve_pallas(
        jnp.asarray(a), [(1, t), (2, t)], interpret=True))
    got = conv_cuda.sepconv2(torch.from_numpy(a), t, t)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_multilook_matches_jax(dtype):
    a = _data((20, 130, 12, 4), dtype, seed=8)
    ref = np.asarray(jmultilook(jnp.asarray(a), 3))
    got = tmultilook(torch.from_numpy(a), 3).numpy()
    np.testing.assert_allclose(got, ref,
                               **(F32 if dtype == np.float32 else F64))


@pytest.mark.parametrize('mode', MODES)
def test_pad_reflect_matches_jax(mode):
    a = _data((5, 7, 3), np.float64, seed=9)
    widths = ((2, 3), (0, 0), (4, 1))
    ref = np.asarray(jconv.pad_reflect(jnp.asarray(a), widths, mode, 1.5))
    got = tconv.pad_reflect(torch.from_numpy(a), widths, mode, 1.5).numpy()
    np.testing.assert_array_equal(got, ref)


def test_host_helpers_match_jax():
    for sigma in (0.0, 0.7, 2.0):
        np.testing.assert_array_equal(tconv.gaussian_kernel1d(sigma),
                                      jconv.gaussian_kernel1d(sigma))
    for k in (np.ones((3, 3)) / 9, np.outer([1, 2, 1], [1, 0, -1.0]),
              np.arange(9.0).reshape(3, 3), np.ones((2, 3, 4))):
        ref = jconv._separable_factors(k)
        got = tconv._separable_factors(k)
        assert (ref is None) == (got is None)
        for r, g in zip(ref or [], got or []):
            np.testing.assert_array_equal(g, r)
    assert tconv._SCIPY_TO_NP_PAD == jconv._SCIPY_TO_NP_PAD
    for mode in ('reflect', 'mirror', 'nearest', 'constant'):
        for j in (-3, -1, 7, 9):
            assert tconv._edge_src(j, 7, mode) == \
                jpallas._edge_src(j, 7, mode)


def test_complex_input():
    a = _data((8, 9), np.float64) + 1j * _data((8, 9), np.float64, seed=1)
    k = np.ones((3, 3)) / 9
    ref = np.asarray(jconv.convolve(jnp.asarray(a), k))
    got = tconv.convolve(torch.from_numpy(a), k).numpy()
    np.testing.assert_allclose(got, ref, **F64)


def test_sepconv_rejects_what_the_kernel_does_not_take():
    t = np.ones(3)
    with pytest.raises(TypeError):
        conv_cuda.sepconv2(torch.zeros(1, 4, 4, 1, dtype=torch.int32), t, t)
    with pytest.raises(ValueError):
        conv_cuda.sepconv2(torch.zeros(4, 4, 1), t, t)
    with pytest.raises(ValueError):
        conv_cuda.sepconv2(torch.zeros(1, 4, 4, 2).transpose(1, 2), t, t)
    with pytest.raises(ValueError):
        conv_cuda.sepconv2(torch.zeros(1, 4, 4, 1), t, t, mode='bogus')
    with pytest.raises(ValueError, match='cuda or cpu'):
        conv_cuda.sepconv2(torch.zeros(1, 4, 4, 1, device='meta'), t, t)
