"""The exact mode's rescan entry point of nd_tpu_torch
(``ops.change_mixed_cuda.rescan``: margins and the cube in, flag planes
written in place) on the CPU, where it runs its plain version
(``rescan_plain``: the suspects gathered, scanned and scattered back).

Held against the gather path of the exact mode before the suspects were
selected on the card (``torch.nonzero`` of the suspects,
``index_select`` of their series, ``mixed_scan_plain``, a scatter of
their planes), against the whole cube's 'mixed' scan kept where a
pixel's margin is not above eps, and against nd_tpu's exact mode (its
Pallas kernel in interpret mode) and 'mixed' scan. Tolerances: packed
flags and suspect counts exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import change as jchange
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_cuda, change_mixed_cuda
from torch_cubes import long_stack_cube, sar_cube


def _gather_path(values, margin, packed, alpha, n, eps):
    """The exact mode's rescan before the suspects moved to the card."""
    idx = torch.nonzero(~(margin.reshape(-1) > eps)).squeeze(1)
    planes = packed.view(packed.shape[0], -1)
    if idx.numel():
        planes[:, idx] = change_mixed_cuda.mixed_scan_plain(
            values.index_select(0, idx), alpha, n)
    return int(idx.numel())


def _full_grid_path(values, margin, packed, alpha, n, eps):
    """Every pixel's scan, kept where the margin is not above eps."""
    suspect = ~(margin.reshape(-1) > eps)
    full = change_mixed_cuda.mixed_scan_plain(values, alpha, n)
    return torch.where(suspect, full, packed.view(packed.shape[0], -1))


def _case(k, seed, dtype):
    cube = sar_cube(6, 11, k, seed=seed)
    cube[:, 0] = long_stack_cube(6, 1, k, seed=seed)[:, 0]   # bursty
    cube[3, 4, 0:12:3] = (1.0, 1.0, 0.0, 1.0)                 # zero dets
    cube[4, 5, 1::2, 1] = 3.0                                 # negative
    values = torch.from_numpy(cube.reshape(-1, k, 4).astype(dtype))
    return cube, values


MARGINS = ['kernel', 'nan', 'none', 'all']


def _margins(kind, cube, k, rng):
    npix = cube.shape[0] * cube.shape[1]
    if kind == 'kernel':
        _, margin = change_cuda.change_detection_fast(
            torch.from_numpy(cube.astype(np.float32)), 0.99, n=9,
            return_margin=True, return_packed=True,
            max_rounds=change_cuda._round_cap(k))
        return margin.reshape(-1).contiguous()
    m = rng.uniform(-1, 1, npix).astype(np.float32)
    if kind == 'nan':
        m[::5] = np.nan
    elif kind == 'none':
        m[:] = 1.0
    else:
        m[:] = -np.inf
    return torch.from_numpy(m)


@pytest.mark.parametrize('k', [3, 12, 40])
@pytest.mark.parametrize('kind', MARGINS)
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_rescan_plain_matches_the_gather_path(k, kind, dtype):
    rng = np.random.RandomState(k)
    cube, values = _case(k, seed=110 + k, dtype=dtype)
    margin = _margins(kind, cube, k, rng)
    start = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, ((k + 30) // 31,
                                                           values.shape[0]),
                                         dtype=np.int64).astype(np.int32))
    got = start.clone()
    count = change_mixed_cuda.rescan(values, margin, got, 0.99, 9, 1e-4)
    ref = start.clone()
    ref_count = _gather_path(values, margin, ref, 0.99, 9, 1e-4)
    assert count.dtype == torch.int32 and count.shape == (1,)
    assert int(count) == ref_count
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(
        got.numpy(), _full_grid_path(values, margin, start, 0.99, 9, 1e-4)
        .numpy())
    if kind == 'none':
        assert ref_count == 0 and bool((got == start).all())
    if kind == 'all':
        assert ref_count == values.shape[0]
        flags = np.asarray(jchange.change_detection(
            jnp.asarray(values.numpy()[None]), alpha=0.99, n=9))[0]
        np.testing.assert_array_equal(
            got.numpy(), tchange.pack_flags(torch.from_numpy(flags.copy()))
            .numpy())


@pytest.mark.parametrize('k,dtype', [(12, np.float32), (12, np.float64),
                                     (40, np.float32)])
def test_exact_mode_matches_jax_exact(k, dtype):
    cube, _ = _case(k, seed=120 + k, dtype=dtype)
    cube = cube.astype(dtype)
    ref, jcount = jchange._change_detection_exact_core(
        jnp.asarray(cube), 0.99, 9, 1e-4, 4096, interpret=True)
    got, count = tchange.change_detection_exact(
        torch.from_numpy(cube), 0.99, n=9, margin_eps=1e-4,
        return_count=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert isinstance(count, int) and count == int(jcount) and count > 0
    mixed = np.asarray(jchange.change_detection(jnp.asarray(cube),
                                                alpha=0.99, n=9))
    np.testing.assert_array_equal(got.numpy(), mixed)


def test_exact_packed_keeps_the_count_as_a_tensor():
    cube, _ = _case(12, seed=130, dtype=np.float32)
    packed, count = tchange._exact_packed(torch.from_numpy(cube), 0.99, 9,
                                          1e-4)
    assert isinstance(count, torch.Tensor) and count.shape == (1,)
    ref = tchange.change_detection_plain(torch.from_numpy(cube), 0.99, n=9)
    np.testing.assert_array_equal(
        change_cuda.unpack_flags(packed, 12).numpy(), ref.numpy())


def test_rescan_checks_its_arguments():
    values = torch.zeros(10, 12, 4)
    margin = torch.zeros(10)
    planes = torch.zeros(1, 10, dtype=torch.int32)
    with pytest.raises(ValueError, match='match'):
        change_mixed_cuda.rescan(values, margin[:9], planes, 0.9, 9, 1e-4)
    with pytest.raises(ValueError, match='float32 margins'):
        change_mixed_cuda.rescan(values, margin.double(), planes, 0.9, 9,
                                 1e-4)
    with pytest.raises(TypeError):
        change_mixed_cuda.rescan(values.half(), margin, planes, 0.9, 9,
                                 1e-4)
    with pytest.raises(ValueError, match='cuda or cpu'):
        change_mixed_cuda.rescan(values.to('meta'), margin, planes, 0.9, 9,
                                 1e-4)


@pytest.mark.parametrize('sdtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('ldtype', [torch.float32, torch.float64])
def test_rescan_block_fits_the_shared_memory_up_to_the_kernels_k(sdtype,
                                                                 ldtype):
    # every series length the exact mode rescans (k <= 256), and the
    # full-grid route's longer ones well past it
    sizes = [change_mixed_cuda.rescan_smem(k, sdtype, ldtype)
             for k in range(1, 1025)]
    assert all(s % 16 == 0 for s in sizes)
    assert max(sizes) <= change_mixed_cuda.SMEM_MAX
    assert sizes == sorted(sizes)
