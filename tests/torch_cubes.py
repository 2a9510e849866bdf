"""Shared inputs of the nd_tpu_torch parity tests: a seeded S1-style
covariance cube and the fixture for tests that need a CUDA device."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    """The CUDA device; the test skips where there is none (decided when
    the test runs, not when the module is collected)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def sar_cube(ny, nx, k, seed=0, special=True):
    """bench-style S1 dual-pol cube (y, x, k, 4) float32 with a
    backscatter step half-way; with ``special`` also a negative
    determinant, a NaN pixel and a constant series."""
    rng = np.random.RandomState(seed)
    c11 = np.abs(rng.normal(1, .25, (ny, nx, k))) + .3
    c22 = np.abs(rng.normal(1, .25, (ny, nx, k))) + .3
    mag = .4 * np.sqrt(c11 * c22) * rng.uniform(0, 1, (ny, nx, k))
    ph = rng.uniform(0, 2 * np.pi, (ny, nx, k))
    c11[:, :, k // 2:] *= 2.5
    c22[:, :, k // 2:] *= 2.5
    cube = np.stack([c11, mag * np.cos(ph), mag * np.sin(ph), c22], -1)
    cube = cube.astype(np.float32)
    if special:
        cube[0, 0, 1, 1] = 5.0          # negative determinant
        cube[1, 2, 0, 0] = np.nan
        cube[2, 3] = cube[2, 3, 0]      # constant series
    return cube


def long_stack_cube(ny, nx, k, seed=0, step=5.0):
    """A long S1 stack: ``sar_cube`` without the special pixels, its
    backscatter step half-way raised to ``step`` (a 2.5x step over 56
    dates does not survive NLMeans and a 3x3 multilook at alpha 0.99),
    plus tests/test_change_scan.py's bursty column (x = 0), whose
    backscatter alternates every 3 steps (many change points, scan
    restart churn)."""
    cube = sar_cube(ny, nx, k, seed=seed, special=False)
    cube[:, :, k // 2:, 0] *= np.float32(step / 2.5)
    cube[:, :, k // 2:, 3] *= np.float32(step / 2.5)
    burst = np.where((np.arange(k) // 3) % 2 == 0, 1.0, 5.0)
    cube[:, 0, :, 0] = burst
    cube[:, 0, :, 3] = burst
    cube[:, 0, :, 1] = 0.05
    cube[:, 0, :, 2] = 0.02
    return cube


# (y, x, k), alpha, looks: one plane (k=12, the bench's length), two
# planes (k=40) and a short series; each flags changes
CASES = [((16, 128, 12), 0.99, 9), ((8, 16, 40), 0.99, 9),
         ((10, 12, 6), 0.9, 9)]


def dated_stack(ny, nx, k=56, seed=0, nan_frac=0.02):
    """``long_stack_cube`` with dates (a 6-day revisit from 2023-01-03)
    and ``nan_frac`` of its samples set to NaN by the seed (no-data, the
    same positions in every variable). Returns (cube, times)."""
    cube = long_stack_cube(ny, nx, k, seed=seed)
    gaps = np.random.RandomState(seed + 1).rand(ny, nx, k) < nan_frac
    cube[gaps] = np.nan
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(k) * np.timedelta64(6, 'D')
    return cube, times
