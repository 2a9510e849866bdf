"""Parity of nd_tpu_torch's NLMeans with nd_tpu's.

The same numpy inputs (from a seed) go through the JAX function and its
port; the spatial Pallas kernel runs in interpret mode. Tolerance for
float32: rtol 1e-5, atol 1e-6 (the patch sums and the exp run in
another order and implementation than the reference's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.filters import NLMeansFilter as JNLMeansFilter
from nd_tpu.ops.nlmeans import find_weight_vectorized as jfind
from nd_tpu.ops.nlmeans import nlmeans as jnlmeans
from nd_tpu.ops.nlmeans_pallas import nlmeans_spatial_pallas
from nd_tpu_torch.filters import NLMeansFilter
from nd_tpu_torch.core import from_jax_dataset
from nd_tpu_torch.ops import nlmeans_cuda
from nd_tpu_torch.ops.nlmeans import find_weight_vectorized, nlmeans

TOL = dict(rtol=1e-5, atol=1e-6)


def _data(shape, dtype=np.float32, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


SHAPES = [(20, 17, 3, 4), (9, 40, 1, 2), (16, 128, 2, 4), (13, 11, 2, 6)]


@pytest.mark.parametrize('shape,rf', [((20, 17, 3, 4), (1, 1)),
                                      ((9, 40, 1, 2), (2, 1)),
                                      ((16, 128, 1, 4), (2, 2))])
def test_spatial_matches_pallas(shape, rf):
    # interpret mode is slow: three cases cover the row-fused (odd
    # widths) and padless (128-aligned) kernels; the XLA test below
    # covers the rest of the grid
    r, f = rf
    a = _data(shape)
    ref = np.asarray(nlmeans_spatial_pallas(
        jnp.asarray(a), (r, r), (f, f), 2.0, 3.0, -1.0, interpret=True))
    got = nlmeans(torch.from_numpy(a), (r, r, 0), (f, f, 0), 2.0, 3.0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('rf', [(1, 1), (2, 1), (2, 2)])
def test_spatial_matches_xla(shape, rf):
    r, f = rf
    a = _data(shape, seed=8)
    ref = np.asarray(jnlmeans(jnp.asarray(a), (r, r, 0), (f, f, 0), 2.0,
                              3.0))
    got = nlmeans(torch.from_numpy(a), (r, r, 0), (f, f, 0), 2.0, 3.0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize('r,f', [((1, 2, 0), (1, 0, 0)),
                                 ((2, 1, 0), (0, 1, 0))])
def test_anisotropic_matches_xla(r, f):
    a = _data((15, 19, 3, 4), seed=1)
    ref = np.asarray(jnlmeans(jnp.asarray(a), r, f, 0.5, 0.8))
    got = nlmeans(torch.from_numpy(a), r, f, 0.5, 0.8).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_n_eff_matches_xla():
    a = _data((16, 16, 2, 4), seed=2)
    ref = np.asarray(jnlmeans(jnp.asarray(a), (2, 2, 0), (1, 1, 0), 2.0,
                              2.0, 4.0))
    got = nlmeans(torch.from_numpy(a), (2, 2, 0), (1, 1, 0), 2.0, 2.0,
                  4.0).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize('r,f', [((1, 1, 1), (1, 1, 1)),
                                 ((0, 0, 2), (1, 1, 0))])
def test_temporal_windows_match_xla_on_cpu(r, f):
    a = _data((12, 10, 5, 3), seed=3)
    ref = np.asarray(jnlmeans(jnp.asarray(a), r, f, 0.5, 0.8))
    got = nlmeans(torch.from_numpy(a), r, f, 0.5, 0.8).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_float64_matches_xla():
    a = _data((11, 12, 2, 4), np.float64, seed=4)
    ref = np.asarray(jnlmeans(jnp.asarray(a), (2, 1, 0), (1, 1, 0), 0.3,
                              0.4))
    got = nlmeans(torch.from_numpy(a), (2, 1, 0), (1, 1, 0), 0.3,
                  0.4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def test_identity_and_window_checks():
    a = torch.from_numpy(_data((6, 7, 2, 2)))
    assert nlmeans(a, (0, 0, 0), (1, 1, 0), 1.0, 1.0) is a
    with pytest.raises(ValueError, match='must be smaller'):
        nlmeans(a, (3, 1, 0), (3, 1, 0), 1.0, 1.0)
    with pytest.raises(ValueError, match='must be smaller'):
        nlmeans_cuda.nlmeans_spatial(a, (1, 6), (1, 1), 1.0, 1.0)
    with pytest.raises(ValueError, match='4-D'):
        nlmeans(a[0], (1, 1, 0), (1, 1, 0), 1.0, 1.0)
    with pytest.raises(ValueError, match='cuda or cpu'):
        nlmeans_cuda.nlmeans_spatial(a.to('meta'), (1, 1), (1, 1), 1.0, 1.0)


def test_find_weight_matches_jax():
    rng = np.random.RandomState(5)
    ws = rng.rand(50) * 8
    sq = rng.rand(50) * 2
    ref = np.asarray(jfind(jnp.asarray(ws), jnp.asarray(sq),
                           jnp.asarray(4.0)))
    got = find_weight_vectorized(torch.from_numpy(ws), torch.from_numpy(sq),
                                 torch.tensor(4.0, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14)


def _jax_dataset(ny=14, nx=18, nt=3, seed=6):
    from nd_tpu.core import Dataset as JDataset
    rng = np.random.RandomState(seed)
    return JDataset({v: (('y', 'x', 'time'),
                         rng.rand(ny, nx, nt).astype(np.float32))
                     for v in ('C11', 'C12__re', 'C12__im', 'C22')},
                    coords={'time': np.arange(nt)})


@pytest.mark.parametrize('dims,r,f', [(('y', 'x'), 2, 1),
                                      (('y', 'x'), 1, 1),
                                      (('x', 'y'), (1, 2), 1)])
def test_filter_apply_matches_jax(dims, r, f):
    jds = _jax_dataset()
    ref = JNLMeansFilter(dims=dims, r=r, f=f, sigma=2, h=3).apply(jds)
    got = NLMeansFilter(dims=dims, r=r, f=f, sigma=2, h=3).apply(
        from_jax_dataset(jds, device='cpu'))
    assert list(got.data_vars) == list(ref.data_vars)
    for v in ref.data_vars:
        assert got[v].dims == ref[v].dims
        np.testing.assert_allclose(got[v].values, ref[v].values, **TOL)


@pytest.mark.parametrize('shape,r,f', [
    ((20, 17, 5, 4), (1, 1, 1), (1, 1, 1)),   # full 3-D window
    ((12, 16, 7, 3), (0, 0, 2), (1, 1, 0)),   # temporal-only radius
    ((10, 14, 5, 1), (1, 0, 1), (0, 1, 1)),   # active axes {0, 2}
    ((18, 15, 4, 4), (2, 1, 0), (1, 1, 1)),   # spatial r, temporal f
])
def test_3d_window_matches_pallas(shape, r, f):
    # tests/test_pallas.py's shapes: the tiled kernel (temporal or full
    # 3-D windows) in interpret mode against the port's 3-D entry point
    from nd_tpu.ops.nlmeans_pallas import nlmeans_pallas
    a = _data(shape, seed=5)
    ref = np.asarray(nlmeans_pallas(jnp.asarray(a), r, f, 0.6, 0.9, -1.0,
                                    interpret=True))
    got = nlmeans_cuda.nlmeans_3d(torch.from_numpy(a), r, f, 0.6, 0.9)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(
        nlmeans(torch.from_numpy(a), r, f, 0.6, 0.9).numpy(), got.numpy())


def test_3d_filter_apply_matches_jax():
    # NLMeansFilter(dims=('y', 'x', 'time')): the joint (y, x, t, var)
    # stack through the 3-D window, reflect on t too
    jds = _jax_dataset(ny=12, nx=14, nt=6, seed=9)
    kw = dict(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1, sigma=2, h=3)
    ref = JNLMeansFilter(**kw).apply(jds)
    nlmeans_cuda.reset_launches()
    got = NLMeansFilter(**kw).apply(from_jax_dataset(jds, device='cpu'))
    assert nlmeans_cuda.launches_3d == 0          # CPU: the plain version
    for v in ref.data_vars:
        assert got[v].dims == ref[v].dims
        np.testing.assert_allclose(got[v].values, ref[v].values, **TOL)


def test_3d_checks():
    a = torch.from_numpy(_data((6, 7, 3, 2)))
    with pytest.raises(ValueError, match='must be smaller'):
        nlmeans_cuda.nlmeans_3d(a, (1, 1, 2), (0, 0, 1), 1.0, 1.0)
    with pytest.raises(ValueError, match='three radii'):
        nlmeans_cuda.nlmeans_3d(a, (1, 1), (1, 1), 1.0, 1.0)
    with pytest.raises(ValueError, match='contiguous'):
        nlmeans_cuda.nlmeans_3d(a.transpose(0, 1), (1, 1, 1), (1, 1, 1),
                                1.0, 1.0)
    with pytest.raises(ValueError, match='cuda or cpu'):
        nlmeans_cuda.nlmeans_3d(a.to('meta'), (1, 1, 1), (1, 1, 1), 1.0,
                                1.0)


PLAN_CASES = [((1024, 1024, 56, 4), (2, 2, 1), (1, 1, 1)),   # path A
              ((1024, 1024, 12, 4), (2, 2, 0), (2, 2, 0)),
              ((1024, 1024, 12, 4), (2, 2, 0), (1, 1, 0)),
              ((1024, 1024, 12, 4), (1, 1, 0), (1, 1, 0)),
              ((37, 53, 5, 4), (2, 2, 1), (1, 1, 1)),         # ragged
              ((4, 4, 3, 5), (2, 2, 1), (1, 1, 1)),           # r+f+1 dims
              ((21, 37, 3, 6), (2, 2, 0), (2, 2, 0))]         # generic nv


@pytest.mark.parametrize('shape,r,f', PLAN_CASES)
@pytest.mark.parametrize('itemsize', [4, 8])
def test_tile_plan_covers_every_output_once(shape, r, f, itemsize):
    plan = nlmeans_cuda._tile_plan(shape, r, f, itemsize)
    ty, tx, tt = plan['tile']
    ny, nx, nt, nv = shape
    # the kernel's block order: t fastest, then x, then y
    nbt, nbx = -(-nt // tt), -(-nx // tx)
    count = np.zeros((ny, nx, nt), np.int64)
    for b in range(plan['blocks']):
        y0, x0, t0 = (b // nbt // nbx) * ty, (b // nbt % nbx) * tx, \
            (b % nbt) * tt
        count[y0:y0 + ty, x0:x0 + tx, t0:t0 + tt] += 1
    assert (count == 1).all()
    assert plan['threads'] * nlmeans_cuda.OUTS_PER_THREAD == ty * tx * tt
    assert 32 <= plan['threads'] <= 512 and plan['threads'] % 32 == 0
    # the halo is r + f on each side: what one block holds
    halo = [t + 2 * (ri + fi) for t, ri, fi in zip(plan['tile'], r, f)]
    region = [t + ri + 2 * fi for t, ri, fi in zip(plan['tile'], r, f)]
    assert plan['route'] == 'staged'
    assert plan['smem'] == (nv * np.prod(halo) + 2 * np.prod(region)) \
        * itemsize
    assert plan['smem'] <= nlmeans_cuda.SMEM_MAX


@pytest.mark.parametrize('shape,r,f', PLAN_CASES[:4])
def test_tile_plan_fits_two_blocks_per_sm_at_the_path_shapes(shape, r, f):
    assert nlmeans_cuda._tile_plan(shape, r, f, 4)['smem'] \
        <= nlmeans_cuda.SMEM_BUDGET


def test_tile_plan_raises_when_nothing_fits():
    # even the global-halo route's two scratch planes overflow the block
    with pytest.raises(ValueError, match='no tile fits'):
        nlmeans_cuda._tile_plan((256, 256, 256, 1), (1, 1, 1),
                                (40, 40, 40), 8)


@pytest.mark.parametrize('r,f', [((2, 2, 1), (1, 1, 1)),
                                 ((2, 1, 0), (2, 1, 0))])
def test_plain_uses_each_offset_pair_once_in_both_directions(r, f):
    # the kernel's order (pairs, forward and backward terms, separable
    # patch sums) agrees with one pass per signed offset, the direct
    # definition, to f32 rounding
    import itertools
    a = torch.from_numpy(_data((9, 11, 5, 3), seed=58))
    got = nlmeans_cuda.nlmeans_3d_plain(a, r, f, 1.0, 1.5)
    pad = [ri + fi for ri, fi in zip(r, f)]
    P = np.pad(a.double().numpy(), [(p, p) for p in pad] + [(0, 0)],
               mode='reflect')
    D = a.shape[:3]
    norm = 3 * np.prod([2 * fi + 1 for fi in f])
    wsum = np.zeros(D)
    wmax = np.zeros(D)
    acc = np.zeros(a.shape)
    for off in itertools.product(*[range(-ri, ri + 1) for ri in r]):
        if off == (0, 0, 0):
            continue
        dsq = np.zeros(D)
        for u in itertools.product(*[range(-fi, fi + 1) for fi in f]):
            s1 = tuple(slice(p + ui, p + ui + n)
                       for p, ui, n in zip(pad, u, D))
            s2 = tuple(slice(p + ui + o, p + ui + o + n)
                       for p, ui, o, n in zip(pad, u, off, D))
            dsq += ((P[s1] - P[s2]) ** 2).sum(-1)
        w = np.exp(-np.maximum(dsq / norm - 2.0, 0) / 1.5 ** 2)
        vals = P[tuple(slice(p + o, p + o + n)
                       for p, o, n in zip(pad, off, D))]
        wsum += w
        wmax = np.maximum(wmax, w)
        acc += w[..., None] * vals
    w_self = np.where(wmax == 0, 1.0, wmax)
    center = P[tuple(slice(p, p + n) for p, n in zip(pad, D))]
    ref = (acc + w_self[..., None] * center) / (wsum + w_self)[..., None]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
