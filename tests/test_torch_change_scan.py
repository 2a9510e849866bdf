"""Parity of nd_tpu_torch's omnibus scan in PyTorch operations
(``ops.change.change_detection``) with nd_tpu's XLA scan.

Tolerances: 'mixed' and float64 decisions exactly equal; float32
statistics (the builtin log, another implementation than the
reference's) and the unrounded fast scan: decision mismatch rate at
most 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import change as jchange
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_cuda
from torch_cubes import CASES, sar_cube as _cube


@pytest.mark.parametrize('shape,alpha,n', CASES)
@pytest.mark.parametrize('stat_dtype', ['mixed', 'float64'])
def test_scan_decisions_match_jax(shape, alpha, n, stat_dtype):
    cube = _cube(*shape, seed=1)
    if stat_dtype == 'float64':
        cube = cube.astype(np.float64)
    ref = np.asarray(jchange.change_detection(
        jnp.asarray(cube), alpha=alpha, n=n, stat_dtype=stat_dtype))
    got = tchange.change_detection(torch.from_numpy(cube), alpha, n=n,
                                   stat_dtype=stat_dtype).numpy()
    assert ref.any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('shape,alpha,n', CASES)
def test_float32_scan_close_to_jax(shape, alpha, n):
    cube = _cube(*shape, seed=2)
    ref = np.asarray(jchange.change_detection(
        jnp.asarray(cube), alpha=alpha, n=n, stat_dtype='float32'))
    got = tchange.change_detection(torch.from_numpy(cube), alpha, n=n,
                                   stat_dtype='float32').numpy()
    assert (got != ref).mean() <= 1e-3


@pytest.mark.parametrize('shape,alpha,n', CASES)
def test_unrounded_fast_scan_close_to_mixed(shape, alpha, n):
    # no round cap, no margins: the kernel's plain version against the
    # float64 decisions (f32 statistics: rare knife-edge disagreements)
    cube = _cube(*shape, seed=3)
    fast = change_cuda.change_detection_fast(torch.from_numpy(cube), alpha,
                                             n=n).numpy()
    mixed = tchange.change_detection(torch.from_numpy(cube), alpha,
                                     n=n).numpy()
    assert fast.shape == cube.shape[:3]
    assert (fast != mixed).mean() <= 1e-3
