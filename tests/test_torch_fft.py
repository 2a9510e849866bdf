"""nd_tpu_torch.ops.fft against nd_tpu.ops.fft on the CPU, from the same
seeded numpy inputs.

Phase correlation: the estimated shifts must be equal (they sit on the
1/upsample_factor grid). Translations and the Fourier shift: float32
within rtol 1e-5 (atol 1e-6), float64 within rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import fft as J
from nd_tpu_torch.ops import fft as T

DTYPES = [np.float32, np.float64]


def _tol(dtype):
    return dict(rtol=1e-5, atol=1e-6) if dtype == np.float32 \
        else dict(rtol=1e-12, atol=1e-12)


def _shifted_series(shape=(64, 80), seed=9):
    """A band-limited image and copies shifted by known sub-pixel
    amounts (alias-free through the Fourier shift theorem)."""
    H, W = shape
    base = np.random.RandomState(seed).rand(H, W)
    F = np.fft.fft2(base)
    F[8:-7, :] = 0
    F[:, 8:-7] = 0
    true = np.array([[0.0, 0.0], [1.3, -2.7], [-0.4, 0.8], [3.25, 1.75],
                     [-6.6, 4.1]])
    fy = np.fft.fftfreq(H)[:, None]
    fx = np.fft.fftfreq(W)[None, :]
    srcs = np.stack([np.real(np.fft.ifft2(
        F * np.exp(-2j * np.pi * (fy * dy + fx * dx)))) for dy, dx in true])
    return srcs, np.real(np.fft.ifft2(F)), true


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('upsample', [1, 4, 10, 20])
@pytest.mark.parametrize('normalization', ['phase', None])
def test_phase_cross_correlation_shifts_equal(dtype, upsample,
                                              normalization):
    srcs, ref, true = _shifted_series()
    srcs, ref = srcs.astype(dtype), ref.astype(dtype)
    want = np.asarray(J.phase_cross_correlation_batch(
        jnp.asarray(srcs), jnp.asarray(ref), upsample_factor=upsample,
        normalization=normalization))
    got = T.phase_cross_correlation_batch(
        torch.from_numpy(srcs), torch.from_numpy(ref),
        upsample_factor=upsample, normalization=normalization)
    assert got.dtype == torch.float64 and tuple(got.shape) == (5, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    if normalization == 'phase' and upsample >= 10:
        assert np.abs(got.numpy() - true).max() <= 0.2


def test_phase_cross_correlation_single_pair_and_odd_shape():
    srcs, ref, _ = _shifted_series((37, 53), seed=3)
    want = np.asarray(J.phase_cross_correlation(srcs[2], ref,
                                                upsample_factor=10))
    got = T.phase_cross_correlation(srcs[2], ref, upsample_factor=10,
                                    device='cpu')
    np.testing.assert_array_equal(got.numpy(), want)


def test_phase_cross_correlation_rejects_unknown_normalization():
    srcs, ref, _ = _shifted_series()
    with pytest.raises(ValueError, match='normalization'):
        T.phase_cross_correlation_batch(torch.from_numpy(srcs),
                                        torch.from_numpy(ref),
                                        normalization='l2')


@pytest.mark.parametrize('dtype', DTYPES)
def test_translate_batch_matches_jax(dtype):
    rng = np.random.RandomState(11)
    imgs = rng.normal(0, 1, (6, 37, 53)).astype(dtype)
    imgs[1, 4, 5] = np.nan
    tr = np.array([[0.0, 0.0], [1.3, -2.7], [-0.4, 0.8], [3.25, 1.75],
                   [-60.0, 45.5], [2.0, -3.0]])
    want = np.asarray(J.translate_batch(jnp.asarray(imgs), tr))
    got = T.translate_batch(torch.from_numpy(imgs), tr)
    assert got.dtype == torch.from_numpy(imgs).dtype
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))
    np.testing.assert_array_equal(got.numpy()[0], imgs[0])  # identity


def test_translate_batch_integer_images_truncate_back():
    rng = np.random.RandomState(12)
    imgs = rng.randint(-100, 100, (3, 21, 30)).astype(np.int32)
    tr = np.array([[0.5, 0.25], [-1.75, 2.0], [0.0, 0.0]])
    want = np.asarray(J.translate_batch(jnp.asarray(imgs), tr))
    got = T.translate_batch(torch.from_numpy(imgs), tr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('method', ['cubic', 'bilinear', 'nearest'])
@pytest.mark.parametrize('shift', [(1.3, -0.7), (-4.0, 2.0), (70.0, -0.5)])
def test_translate_matches_jax(dtype, method, shift):
    img = np.random.RandomState(13).normal(0, 1, (37, 53)).astype(dtype)
    want = np.asarray(J.translate(jnp.asarray(img), shift, method=method))
    got = T.translate(torch.from_numpy(img), shift, method=method)
    assert got.dtype == torch.from_numpy(img).dtype
    tol = dict(rtol=0, atol=0) if method == 'nearest' else _tol(dtype)
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.mark.parametrize('dtype', DTYPES)
def test_fourier_shift_matches_jax(dtype):
    img = np.random.RandomState(14).normal(0, 1, (37, 53)).astype(dtype)
    want = np.asarray(J.fourier_shift(jnp.asarray(img), (1.3, -2.6)))
    got = T.fourier_shift(torch.from_numpy(img), (1.3, -2.6))
    assert str(got.dtype).split('.')[-1] == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))
