"""Parity of nd_tpu_torch's exact omnibus mode with nd_tpu's.

The fast pass's margins pick the suspect pixels, which are rescanned
with the float64 'mixed' scan. The decisions must equal the 'mixed'
scan's exactly, and the reference's exact mode (its Pallas kernel in
interpret mode) exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import change as jchange
from nd_tpu_torch.ops import change as tchange
from torch_cubes import sar_cube


@pytest.mark.parametrize('eps', [1e-4, 3e-4])
def test_exact_matches_jax_exact_and_mixed(eps):
    cube = sar_cube(16, 128, 12, seed=11)
    ref, jcount = jchange._change_detection_exact_core(
        jnp.asarray(cube), 0.99, 9, eps, 4096, interpret=True)
    got, count = tchange.change_detection_exact(
        torch.from_numpy(cube), 0.99, n=9, margin_eps=eps,
        return_count=True)
    mixed = tchange.change_detection(torch.from_numpy(cube), 0.99, n=9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), mixed.numpy())
    assert count == int(jcount) and count > 0


@pytest.mark.parametrize('k,alpha', [(40, 0.99), (6, 0.9), (12, 0.01)])
def test_exact_equals_mixed(k, alpha):
    cube = sar_cube(9, 11, k, seed=12)
    got = tchange.change_detection_exact(torch.from_numpy(cube), alpha, n=9)
    ref = np.asarray(jchange.change_detection(jnp.asarray(cube),
                                              alpha=alpha, n=9))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_exact_float64_input_rescans_in_float64():
    cube = sar_cube(12, 14, 12, seed=13).astype(np.float64)
    cube[..., 0] += 1e-9        # below f32 resolution: kept by the rescan
    got = tchange.change_detection_exact(torch.from_numpy(cube), 0.99, n=9)
    ref = tchange.change_detection(torch.from_numpy(cube), 0.99, n=9)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_mixed_rescan_is_batch_shape_invariant():
    # the rescan scans gathered rows: the same series must decide the
    # same as in the full grid
    cube = torch.from_numpy(sar_cube(10, 13, 12, seed=14))
    full = tchange.change_detection(cube, 0.99, n=9)
    rows = tchange.change_detection(cube.reshape(1, 130, 12, 4), 0.99,
                                    n=9).reshape(10, 13, 12)
    np.testing.assert_array_equal(rows.numpy(), full.numpy())
