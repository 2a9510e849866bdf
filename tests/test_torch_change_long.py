"""Parity of nd_tpu_torch's long-series omnibus scan (the plain version
of the ``omnibus_scan`` kernel) and of the exact mode's routes with
nd_tpu's.

References and tolerances:

  - ``scan_tables``: equal to nd_tpu's, ``None`` cases included;
  - the JAX scan kernel's body (``change_scan_pallas._scan_kernel``) run
    op by op on the CPU: flags and margins exactly equal (the same f32
    operations in the same order);
  - ``change_detection_scan(..., interpret=True)`` at k = 16: flags
    equal wherever the JAX margin is above eps = 1e-4, margins within
    5e-5 absolute (interpret mode jit-compiles the kernel, and XLA's
    fused loops round some sums differently). At k = 56 interpret mode
    takes more than ten minutes and 15 GB to compile on the CPU, so the
    body run op by op stands in for it there;
  - the exact mode: 0 mismatches against the float64 'mixed' scan and
    against nd_tpu's exact mode (its kernel's margins pick the suspects,
    the 'mixed' scan patches them);
  - no kernel route (k = 300, infeasible tables): exactly nd_tpu's
    float64 'mixed' scan; ``OmnibusTest`` at k = 56 exactly nd_tpu's
    ``OmnibusTest`` on the same Dataset.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.ops import change as jchange
from nd_tpu.ops import change_scan_pallas as jscan
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_cuda, change_scan_cuda

EPS = 1e-4


def _cube_with_changes(ny, nx, k, seed=0, neg_dets=False):
    """tests/test_change_scan.py's cube: a backscatter step half-way and
    a bursty column with many change points."""
    rng = np.random.RandomState(seed)
    c11 = np.abs(rng.normal(1, .3, (ny, nx, k))) + .2
    c22 = np.abs(rng.normal(1, .3, (ny, nx, k))) + .2
    hi = 1.3 if neg_dets else 0.9
    mag = np.sqrt(c11 * c22) * rng.uniform(0.2, hi, (ny, nx, k))
    ph = rng.uniform(0, 2 * np.pi, (ny, nx, k))
    cube = np.stack([c11, mag * np.cos(ph), mag * np.sin(ph), c22],
                    -1).astype(np.float32)
    cube[:, :, k // 2:, 0] *= 2.5
    cube[:, :, k // 2:, 3] *= 2.5
    t = np.arange(k)
    burst = np.where((t // 3) % 2 == 0, 1.0, 5.0).astype(np.float32)
    cube[:, 0, :, 0] = burst
    cube[:, 0, :, 3] = burst
    cube[:, 0, :, 1] = 0.05
    cube[:, 0, :, 2] = 0.02
    return cube


class _Ref:
    """An array with the ref interface the Pallas kernel body uses."""

    def __init__(self, a):
        self.a = jnp.asarray(a)

    shape = property(lambda self: self.a.shape)

    def __getitem__(self, idx):
        return self.a[idx]

    def __setitem__(self, idx, value):
        self.a = self.a.at[idx].set(value)


def _jax_scan_body(cube, alpha, n):
    """nd_tpu's scan kernel body over the whole cube as one tile."""
    ny, nx, k, _ = cube.shape
    f32 = np.float32
    out = _Ref(np.zeros(((k + 30) // 31, ny, nx), np.int32))
    margin = _Ref(np.zeros((ny, nx), f32))
    planes = [_Ref(np.zeros((k, ny, nx), f32)) for _ in range(6)]
    regs = [_Ref(np.zeros((ny, nx), f32)) for _ in range(8)]
    jscan._scan_kernel(_Ref(np.transpose(cube, (2, 3, 0, 1))), out, margin,
                       *planes, *regs, k=k, nf=float(n),
                       tabs=jscan.scan_tables(k, int(n), float(alpha)))
    return np.asarray(out.a), np.asarray(margin.a)


_BODY = {}


def _body_result(k):
    if k not in _BODY:
        cube = _cube_with_changes(8, 128, k, seed=3, neg_dets=True)
        _BODY[k] = (cube,) + _jax_scan_body(cube, 0.99, 9)
    return _BODY[k]


@pytest.mark.parametrize('k,n,alpha', [(16, 9, 0.99), (56, 9, 0.99),
                                       (64, 1, 0.01), (56, 9, 1e-12),
                                       (9, 9, 0.99), (3, 9, 0.99)])
def test_scan_tables_equal_jax(k, n, alpha):
    ref = jscan.scan_tables(k, n, alpha)
    got = change_scan_cuda.scan_tables(k, n, alpha)
    assert got == ref
    assert (got is None) == ((k, alpha) in ((56, 1e-12), (9, 0.99),
                                            (3, 0.99)))


@pytest.mark.parametrize('k', [16, 56])
def test_plain_scan_equals_jax_kernel_body(k):
    cube, ref_packed, ref_margin = _body_result(k)
    packed, margin = change_scan_cuda.change_detection_scan(
        torch.from_numpy(cube), 0.99, n=9, return_packed=True)
    np.testing.assert_array_equal(packed.numpy(), ref_packed)
    np.testing.assert_array_equal(margin.numpy(), ref_margin)


def test_plain_scan_matches_jax_interpret():
    cube, _, _ = _body_result(16)
    ref_flags, ref_margin = jscan.change_detection_scan(
        cube, 0.99, n=9, interpret=True)
    ref_flags, ref_margin = np.asarray(ref_flags), np.asarray(ref_margin)
    flags, margin = change_scan_cuda.change_detection_scan(
        torch.from_numpy(cube), 0.99, n=9)
    flags, margin = flags.numpy(), margin.numpy()
    sure = ref_margin > EPS
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(flags[sure], ref_flags[sure])
    np.testing.assert_array_equal(np.isfinite(margin),
                                  np.isfinite(ref_margin))
    fin = np.isfinite(ref_margin)
    np.testing.assert_allclose(margin[fin], ref_margin[fin], rtol=0,
                               atol=5e-5)


def test_exact_long_series_routes_through_the_scan():
    cube, ref_packed, ref_margin = _body_result(56)
    eps = 0.05          # wide: this small cube has no pixel within 1e-4
    change_scan_cuda.reset_launches()
    got, count = tchange.change_detection_exact(
        torch.from_numpy(cube), 0.99, n=9, margin_eps=eps,
        return_count=True)
    mixed = np.asarray(jchange.change_detection(jnp.asarray(cube), 0.99,
                                                n=9, stat_dtype='mixed'))
    # nd_tpu's exact mode: its kernel's flags where the margin is above
    # eps, the 'mixed' scan elsewhere
    suspect = ~(ref_margin > eps)
    kernel_flags = np.asarray(change_cuda.unpack_flags(
        torch.from_numpy(ref_packed.copy()), 56))
    ref_exact = np.where(suspect[..., None], mixed, kernel_flags)
    np.testing.assert_array_equal(got.numpy(), mixed)
    np.testing.assert_array_equal(got.numpy(), ref_exact)
    assert count == int(suspect.sum()) and 0 < count < cube[..., 0, 0].size
    assert mixed.any()
    assert change_scan_cuda.launches == 0        # CPU: the plain version


@pytest.mark.parametrize('k,alpha', [(300, 0.99), (56, 1e-12)])
def test_exact_without_a_kernel_route_returns_mixed(k, alpha):
    cube = _cube_with_changes(4, 6, k, seed=4)
    assert not change_cuda.supports_rescan(k, 9, alpha)
    got, count = tchange.change_detection_exact(
        torch.from_numpy(cube), alpha, n=9, return_count=True)
    assert count == 4 * 6
    # nd_tpu returns its float64 'mixed' scan here too
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jchange.change_detection(
            jnp.asarray(cube), alpha, n=9, stat_dtype='mixed')))


def test_supports_rescan_mirrors_jax_gate():
    from nd_tpu.ops import change_pallas
    assert change_cuda.K_MAX == change_pallas._K_MAX
    assert change_cuda.K_RESCAN_MAX == change_pallas._K_RESCAN_MAX \
        == change_scan_cuda.K_SCAN_MAX == jscan.K_SCAN_MAX
    for k, n, alpha in [(12, 9, 0.99), (48, 9, 1e-12), (49, 9, 0.99),
                        (56, 9, 1e-12), (64, 1, 0.01), (257, 9, 0.99)]:
        want = k <= 256 and (k <= 48 or jscan.scan_tables(
            k, n, alpha) is not None)
        assert change_cuda.supports_rescan(k, n, alpha) == want


def test_scan_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match='k >= 3'):
        change_scan_cuda.change_detection_scan(torch.zeros(2, 2, 2, 4), 0.9)
    with pytest.raises(ValueError, match='too long'):
        change_scan_cuda.change_detection_scan(torch.zeros(2, 2, 257, 4),
                                               0.9)
    with pytest.raises(ValueError, match='infeasible'):
        change_scan_cuda.change_detection_scan(torch.zeros(2, 2, 56, 4),
                                               1e-12, n=9)
    with pytest.raises(ValueError, match='cuda or cpu'):
        change_scan_cuda.change_detection_scan(
            torch.zeros(2, 2, 56, 4, device='meta'), 0.99, n=9)


def test_omnibus_test_long_series_equals_mixed():
    import nd_tpu_torch as ndt
    from nd_tpu.change import OmnibusTest as JOmnibusTest
    from nd_tpu.core import Dataset as JDataset
    from nd_tpu_torch.core import Dataset
    cube = _cube_with_changes(10, 12, 56, seed=5)
    names = ('C11', 'C12__re', 'C12__im', 'C22')
    ds = Dataset({v: (('y', 'x', 'time'), torch.from_numpy(cube[..., i]))
                  for i, v in enumerate(names)})
    got = ndt.OmnibusTest(n=9, alpha=0.99).apply(ds)
    ref = tchange.change_detection(torch.from_numpy(cube), 0.99, n=9)
    assert got.dims == ('y', 'x', 'time')
    np.testing.assert_array_equal(got.data.numpy(), ref.numpy())
    # nd_tpu's OmnibusTest on the same Dataset
    jds = JDataset({v: (('y', 'x', 'time'), cube[..., i])
                    for i, v in enumerate(names)})
    jref = JOmnibusTest(n=9, alpha=0.99).apply(jds)
    assert jref.dims == got.dims
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(jref.values))
    assert got.data.any()
