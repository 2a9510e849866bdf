"""Parity of nd_tpu_torch's fast omnibus kernel path
(``ops.change_cuda``) and its host helpers with nd_tpu's.

The same numpy cubes (from a seed) go through the JAX functions and
their ports; the Pallas kernel runs in interpret mode. Tolerances:

  - thresholds and packed flags: exactly equal;
  - margins: the same +-inf and NaN positions, finite values within
    MARGIN_TOL (relative to max(1, |margin|): the reference's XLA
    lowering rounds some products differently), and the same suspect
    sets at margin_eps 1e-4 and 3e-4;
  - on the card, kernel against plain version: flag mismatch rate at
    most 1e-5, margins within MARGIN_TOL.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import change as jchange
from nd_tpu.ops import change_pallas as jpallas
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_cuda
from torch_cubes import CASES, sar_cube as _cube

MARGIN_TOL = 1e-4


@pytest.mark.parametrize('k,n,alpha', [(12, 9, 0.99), (40, 4, 0.9),
                                       (6, 1, 0.5), (3, 2, 0.01)])
def test_thresholds_and_host_helpers_match_jax(k, n, alpha):
    np.testing.assert_array_equal(tchange.omnibus_thresholds(k, n, alpha),
                                  jchange.omnibus_thresholds(k, n, alpha))
    with np.errstate(divide='ignore', invalid='ignore'):
        np.testing.assert_array_equal(
            tchange.omnibus_rho(np.arange(k + 1), n),
            jchange.omnibus_rho(np.arange(k + 1), n))
    assert change_cuda._round_cap(k) == jpallas._round_cap(k)


@pytest.mark.parametrize('shape,alpha,n', CASES)
def test_fast_kernel_matches_pallas(shape, alpha, n):
    ny, nx, k = shape
    cube = _cube(ny, nx, k)
    cap = jpallas._round_cap(k)
    jp, jm = jpallas.change_detection_pallas(
        jnp.asarray(cube), alpha, n=n, return_margin=True,
        return_packed=True, max_rounds=cap, interpret=True)
    jp, jm = np.asarray(jp), np.asarray(jm)
    tp, tm = change_cuda.change_detection_fast(
        torch.from_numpy(cube), alpha, n=n, return_margin=True,
        return_packed=True, max_rounds=cap)
    tp, tm = tp.numpy(), tm.numpy()
    assert jp.any()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(np.isnan(tm), np.isnan(jm))
    np.testing.assert_array_equal(np.isposinf(tm), np.isposinf(jm))
    np.testing.assert_array_equal(np.isneginf(tm), np.isneginf(jm))
    fin = np.isfinite(jm)
    assert np.all(np.abs(tm[fin] - jm[fin])
                  <= MARGIN_TOL * np.maximum(1.0, np.abs(jm[fin])))
    for eps in (1e-4, 3e-4):
        np.testing.assert_array_equal(~(tm > eps), ~(jm > eps))


def test_unpack_flags_round_trip_two_planes():
    rng = np.random.RandomState(4)
    flags = rng.rand(5, 7, 40) > 0.7
    packed = tchange.pack_flags(torch.from_numpy(flags))
    assert packed.shape == (2, 5, 7) and packed.dtype == torch.int32
    np.testing.assert_array_equal(
        change_cuda.unpack_flags(packed, 40).numpy(), flags)
    np.testing.assert_array_equal(
        np.asarray(jpallas.unpack_flags(jnp.asarray(packed.numpy()), 40)),
        flags)


def test_mlog_matches_pallas_helper():
    # (subnormals left out: the reference's CPU log flushes them to 0)
    x = np.concatenate([np.geomspace(1e-30, 1e30, 997),
                        [0.0, -1.0, np.inf, np.nan, 1.0, 2.0]])
    x = x.astype(np.float32)
    ref = np.asarray(jpallas._mlog(jnp.asarray(x)))
    got = change_cuda._mlog(torch.from_numpy(x)).numpy()
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[fin], np.log(x[fin].astype(np.float64)),
                               rtol=0, atol=1e-5)


def test_fast_rejects_cap_without_margin():
    cube = torch.from_numpy(_cube(4, 4, 12, special=False))
    with pytest.raises(ValueError, match='return_margin'):
        change_cuda.change_detection_fast(cube, 0.9, n=1, max_rounds=3)
    with pytest.raises(ValueError, match='cuda or cpu'):
        change_cuda.change_detection_fast(cube.to('meta'), 0.9, n=1)
