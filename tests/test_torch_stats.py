"""``ops.stats`` (the chi-square CDF): nd_tpu_torch against nd_tpu.

Tolerances follow what each library's incomplete gamma function achieves
(measured on 200k draws per shape against float64 scipy): in float32
``lax.igamma`` errs by up to 4e-6 at a = 24 (the chi-square shapes of a
12-date series) and ``torch.special.gammainc`` by about 3e-7, so the
port is held to nd_tpu at atol 5e-6 up to a = 24 and to scipy at atol
1e-6 beyond (where ``lax.igamma`` errs by up to 2.4e-5); in float64
torch errs by about 4e-10 and JAX by 8e-15, so atol 1e-9.
"""

import numpy as np
import pytest
import torch
from scipy.stats import chi2

import jax.numpy as jnp

from nd_tpu.ops.stats import chi2_cdf as jchi2_cdf
from nd_tpu_torch.ops.stats import chi2_cdf, gammainc_lower


def _draws(df, n=4000, seed=0):
    rng = np.random.RandomState(seed + int(df))
    return rng.chisquare(df, n)


@pytest.mark.parametrize('df', [2, 4, 8, 20, 44, 48])
def test_float32_matches_nd_tpu_up_to_a_24(df):
    x = _draws(df).astype(np.float32)
    got = chi2_cdf(torch.from_numpy(x), df)
    ref = np.asarray(jchi2_cdf(jnp.asarray(x), df))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize('df', [60, 100, 200])
def test_float32_beyond_a_24_matches_scipy(df):
    x = _draws(df).astype(np.float32)
    got = chi2_cdf(torch.from_numpy(x), df)
    ref = chi2.cdf(x.astype(np.float64), df)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize('df', [2, 8, 44, 48, 100])
def test_float64_matches_nd_tpu(df):
    x = _draws(df)
    got = chi2_cdf(torch.from_numpy(x), df)
    ref = np.asarray(jchi2_cdf(jnp.asarray(x), df))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_negative_nan_and_inf(dtype):
    x = np.array([-5.0, -1e-30, 0.0, np.nan, np.inf, -np.inf, 3.0], dtype)
    got = chi2_cdf(torch.from_numpy(x), 4).numpy()
    ref = np.asarray(jchi2_cdf(jnp.asarray(x), 4))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-6)
    np.testing.assert_array_equal(got[[0, 1, 2, 5]], 0.0)
    assert np.isnan(got[3]) and got[4] == 1.0


def test_integer_statistics_become_float64():
    x = np.array([-3, 0, 1, 4, 9, 30], np.int64)
    got = chi2_cdf(x, 6, device='cpu')
    ref = np.asarray(jchi2_cdf(jnp.asarray(x), 6))
    assert got.dtype == torch.float64 and ref.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)


def test_df_as_a_tensor_and_gammainc_lower():
    x = torch.from_numpy(_draws(12))
    np.testing.assert_array_equal(
        chi2_cdf(x, torch.tensor(12.0)).numpy(), chi2_cdf(x, 12).numpy())
    a = torch.full_like(x, 6.0)
    np.testing.assert_array_equal(gammainc_lower(a, x / 2).numpy(),
                                  chi2_cdf(x, 12).numpy())


def test_numpy_input_lands_on_the_named_device():
    got = chi2_cdf(np.array([1.0, 2.0]), 2, device='cpu')
    assert got.device.type == 'cpu'
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            chi2_cdf(np.array([1.0, 2.0]), 2)
