"""Parity of the plain version of nd_tpu_torch's rescan kernel
(``ops.change_mixed_cuda.mixed_scan_plain``, the ``omnibus_mixed``
kernel's twin) and of its shared decision tables with nd_tpu's float64
'mixed' scan.

The same numpy rows (from a seed: a cube's series gathered as the exact
mode gathers its suspects, with the bursty column and zero, negative and
NaN determinants) go through nd_tpu's ``change_detection`` (XLA on the
CPU) and the plain version. Tolerances: packed flags exactly equal for
'mixed' and 'float64' statistics; decision tables exactly equal. N is
37, not a multiple of 32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import change as jchange
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_cuda, change_mixed_cuda, stream_cuda
from torch_cubes import long_stack_cube, sar_cube

N = 37


def _rows(k, seed, dtype=np.float32):
    """N gathered series: a cube's rows with the bursty column (rows 0
    and 5; backscatter alternating every 3 steps, every k // 16 for long
    series, which keeps the plain scan's rounds few), exact zero
    determinants (row 1, steps 0, 3, 6 and 9), negative ones (row 2, every
    other step), a NaN (row 3) and a constant series (row 4)."""
    rows = np.concatenate([
        long_stack_cube(2, 5, k, seed=seed).reshape(-1, k, 4),
        sar_cube(3, 9, k, seed=seed + 1, special=False).reshape(-1, k, 4)])
    wave = np.where((np.arange(k) // max(3, k // 16)) % 2 == 0, 1.0, 5.0)
    rows[[0, 5], :, 0] = wave
    rows[[0, 5], :, 3] = wave
    rows[1, 0:12:3] = (1.0, 1.0, 0.0, 1.0)
    rows[2, 1::2, 1] = 3.0
    rows[3, k // 2, 0] = np.nan
    rows[4] = rows[4, 0]
    assert rows.shape == (N, k, 4)
    return rows.astype(dtype)


def _jax_packed(rows, alpha, n, stat_dtype):
    flags = np.asarray(jchange.change_detection(
        jnp.asarray(rows[None]), alpha=alpha, n=n, stat_dtype=stat_dtype))
    return tchange.pack_flags(torch.from_numpy(flags[0].copy())).numpy()


CASES = [(k, np.float32, 'mixed') for k in (2, 12, 48, 56, 200, 300)] + [
    (k, dt, mode) for k in (12, 56, 200)
    for dt, mode in ((np.float64, 'mixed'), (np.float32, 'float64'),
                     (np.float64, 'float64'))]


@pytest.mark.parametrize('k,dtype,mode', CASES)
def test_plain_rescan_equals_jax_scan(k, dtype, mode):
    rows = _rows(k, seed=k, dtype=dtype)
    got = change_mixed_cuda.mixed_scan_plain(torch.from_numpy(rows), 0.99,
                                             9, mode)
    ref = _jax_packed(rows, 0.99, 9, mode)
    assert got.shape == ((k + 30) // 31, N) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy().any()


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('alpha,n', [(1e-12, 9), (0.99, 0.5)])
def test_plain_rescan_equals_jax_far_tails_and_fractional_looks(dtype, alpha,
                                                                n):
    # 0.5 looks make rho(j) <= 0 for short windows: the unfolded float64
    # statistic; alpha 1e-12 keeps the folded one with most windows hit
    rows = _rows(56, seed=3, dtype=dtype)
    use_folded, _ = tchange.decision_tables(56, n, alpha, torch.float64)
    assert use_folded == (n == 9)
    got = change_mixed_cuda.mixed_scan_plain(torch.from_numpy(rows), alpha,
                                             n, 'mixed')
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_packed(rows, alpha, n, 'mixed'))


def _jax_tables(k, n, alpha):
    """nd_tpu's change_detection table preparation, from its host
    helpers."""
    z = jchange.omnibus_thresholds(k, n, float(alpha))
    with np.errstate(divide='ignore', invalid='ignore'):
        rho = jchange.omnibus_rho(np.arange(k + 1), n)
    folded = np.full(k + 1, -np.inf)
    for j in range(2, k + 1):
        if np.isfinite(z[j]):
            if rho[j] <= 0:
                return False, z
            folded[j] = -z[j] / (2 * rho[j]) - n * 2.0 * j * np.log(j)
    return True, folded


@pytest.mark.parametrize('k,n,alpha', [(12, 9, 0.99), (56, 9, 1e-12),
                                       (100, 9, 0.99), (56, 0.5, 0.99),
                                       (12, 1, 0.01), (2, 4, 0.5)])
def test_decision_tables_equal_jax(k, n, alpha):
    use_folded, table = tchange.decision_tables(k, n, alpha, torch.float64)
    ref_folded, ref = _jax_tables(k, n, alpha)
    assert use_folded == ref_folded
    np.testing.assert_array_equal(table, ref)
    assert not table.flags.writeable
    # float32 statistics never fold: the table is the z-thresholds
    use32, table32 = tchange.decision_tables(k, n, alpha, torch.float32)
    assert not use32
    np.testing.assert_array_equal(
        table32, jchange.omnibus_thresholds(k, n, float(alpha)))


def test_float32_statistics_stay_plain_on_the_cpu():
    cube = torch.from_numpy(sar_cube(9, 11, 12, seed=21))
    change_cuda.reset_launches()
    change_mixed_cuda.reset_launches()
    got = tchange.change_detection(cube, 0.99, n=9, stat_dtype='float32')
    assert change_cuda.launches == 0 and change_mixed_cuda.launches == 0
    ref = tchange.change_detection_plain(cube, 0.99, n=9,
                                         stat_dtype='float32')
    assert got.device.type == 'cpu'
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert got.numpy().any()


def test_change_detection_is_the_plain_scan_on_the_cpu():
    rows = _rows(40, seed=22)
    cube = torch.from_numpy(rows.reshape(1, N, 40, 4))
    got = tchange.change_detection(cube, 0.99, n=9)
    ref = change_mixed_cuda.mixed_scan_plain(torch.from_numpy(rows), 0.99,
                                             9)
    np.testing.assert_array_equal(tchange.pack_flags(got[0]).numpy(),
                                  ref.numpy())


def test_rescan_kernel_wrapper_raises_off_the_card():
    rows = torch.from_numpy(_rows(12, seed=23))
    with pytest.raises(ValueError, match='CUDA'):
        change_mixed_cuda.mixed_scan(rows, 0.99, 9)
    with pytest.raises(ValueError, match='mixed, float32 or float64'):
        tchange.change_detection(rows[None], 0.99, n=9, stat_dtype='f16')
    with pytest.raises(ValueError, match='cuda or cpu'):
        tchange.change_detection(rows[None].to('meta'), 0.99, n=9)


def test_stream_probe_plain_on_the_cpu():
    x = torch.from_numpy(np.random.RandomState(24).rand(96, 1024)
                         .astype(np.float32))
    stream_cuda.reset_launches()
    got = stream_cuda.stream_plus_one(x)
    assert stream_cuda.launches == 0
    assert float((got - (x + 1)).abs().max()) == 0.0
    with pytest.raises(ValueError, match='1024'):
        stream_cuda.stream_plus_one(torch.zeros(4, 512))
    with pytest.raises(TypeError):
        stream_cuda.stream_plus_one(torch.zeros(4, 1024,
                                                dtype=torch.float64))
    with pytest.raises(ValueError, match='contiguous'):
        stream_cuda.stream_plus_one(torch.zeros(1024, 4).t())
