"""Parity with nd_tpu of three repaired routes of nd_tpu_torch, on the
CPU (the kernels' plain versions):

  - separable kernels of any length (GaussianFilter past sigma 7.8 at
    truncate 4 has more than 64 taps): float32 rtol 1e-6, atol 1e-7, as
    the other convolution tests;
  - float16 and bfloat16 cubes in NLMeans and the convolutions: the port
    filters them in float32 and returns their dtype, the reference
    filters in the low precision itself, so they agree to that
    precision's rounding: float16 rtol 5e-3, atol 5e-3 (a few float16
    ulps at 1); bfloat16 rtol 2e-2, atol 2e-2 (a few bfloat16 ulps);
  - NLMeans with wide 3-D windows, whose halo tile of every variable
    fits no block on the card (the wide-window kernel): the route chosen
    by ``_tile_plan`` from the shapes, and the plain version against
    the reference at a small size (float32 rtol 1e-5, atol 1e-6;
    float64 rtol 1e-12, atol 1e-13).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nd_tpu.filters as jfilters
from nd_tpu.core import Dataset as JDataset
from nd_tpu.ops import conv as jconv
from nd_tpu.ops.nlmeans import nlmeans as jnlmeans
import nd_tpu_torch as ndt
from nd_tpu_torch.core import from_jax_dataset
from nd_tpu_torch.ops import conv as tconv
from nd_tpu_torch.ops import conv_cuda, nlmeans_cuda
from nd_tpu_torch.ops.nlmeans import nlmeans

F32 = dict(rtol=1e-6, atol=1e-7)
F16 = dict(rtol=5e-3, atol=5e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
NAMES = ('C11', 'C12__re', 'C12__im', 'C22')


def _data(shape, dtype=np.float32, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


def _jax_stack(ny=14, nx=18, nt=7, seed=3):
    rng = np.random.RandomState(seed)
    return JDataset({v: (('y', 'x', 'time'),
                         rng.rand(ny, nx, nt).astype(np.float32))
                     for v in NAMES},
                    coords={'time': np.arange(nt)})


# ---- separable kernels of any length --------------------------------------

LONG = [(7.9, ('y', 'x')), (7.9, ('y', 'x', 'time')), (8.0, ('y', 'x')),
        (8.0, ('y', 'x', 'time')), (16.0, ('y', 'x')),
        (16.0, ('y', 'x', 'time')), (32.0, ('y', 'x', 'time'))]


@pytest.mark.parametrize('sigma,dims', LONG)
def test_long_gaussian_on_a_dataarray_matches_jax(sigma, dims):
    ref = jfilters.GaussianFilter(dims=dims, sigma=sigma).apply(
        _jax_stack()['C11'])
    got = ndt.GaussianFilter(dims=dims, sigma=sigma).apply(
        from_jax_dataset(_jax_stack(), device='cpu')['C11'])
    assert len(tconv.gaussian_kernel1d(sigma)) > conv_cuda.INLINE_TAPS
    np.testing.assert_allclose(got.values, ref.values, **F32)


@pytest.mark.parametrize('sigma,dims', LONG[:6])
def test_long_gaussian_on_a_dataset_matches_jax(sigma, dims):
    jds = _jax_stack(seed=4)
    ref = jfilters.GaussianFilter(dims=dims, sigma=sigma).apply(jds)
    got = ndt.GaussianFilter(dims=dims, sigma=sigma).apply(
        from_jax_dataset(jds, device='cpu'))
    for v in NAMES:
        np.testing.assert_allclose(got[v].values, ref[v].values, **F32)


@pytest.mark.parametrize('mode', ['reflect', 'mirror', 'nearest',
                                  'constant', 'wrap'])
def test_long_separable_kernel_matches_jax(mode):
    # a 2-d rank-1 kernel of 65 x 3 taps through ConvolutionFilter
    a = _data((30, 20, 3), seed=5)
    kernel = np.outer(np.linspace(0.5, 1.5, 65), [0.25, 0.5, 0.25])
    ref = np.asarray(jconv.convolve(jnp.asarray(a), kernel, axes=(0, 1),
                                    mode=mode))
    got = tconv.convolve(torch.from_numpy(a), kernel, axes=(0, 1),
                         mode=mode)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_long_axes_take_one_axis_passes(monkeypatch):
    calls = []
    real = conv_cuda.sepconv2

    def spy(x, t0, t1, **kw):
        calls.append((tuple(x.shape), len(t0), len(t1)))
        return real(x, t0, t1, **kw)

    monkeypatch.setattr(conv_cuda, 'sepconv2', spy)
    x = torch.from_numpy(_data((10, 11, 6)))
    g = tconv.gaussian_kernel1d(8.0)                    # 65 taps
    tconv.separable_convolve(x, [g, g, g], (0, 1, 2))
    # one launch per axis, each the (1, outer, n, inner) view filtered
    # over n, the outer axis copied by one tap of weight 1
    assert calls == [((1, 1, 10, 66), 1, 65), ((1, 10, 11, 6), 1, 65),
                     ((1, 110, 6, 1), 1, 65)]
    del calls[:]
    short = np.ones(3) / 3
    tconv.convolve(x, np.outer(short, short), axes=(0, 1))
    assert calls == [((1, 10, 11, 6), 3, 3)]            # still paired


# ---- float16 and bfloat16 ---------------------------------------------------

@pytest.mark.parametrize('jdt,tdt,tol', [(jnp.float16, torch.float16, F16),
                                         (jnp.bfloat16, torch.bfloat16,
                                          BF16)])
def test_low_precision_convolution_matches_jax(jdt, tdt, tol):
    a = _data((12, 14, 6), seed=6)
    k = np.ones((3, 3)) / 9
    g = tconv.gaussian_kernel1d(1.0)
    x = torch.from_numpy(a).to(tdt)
    for ref, got in (
            (jconv.convolve(jnp.asarray(a).astype(jdt), k, axes=(0, 1)),
             tconv.convolve(x, k, axes=(0, 1))),
            (jconv.separable_convolve(jnp.asarray(a).astype(jdt), [g, g, g],
                                      (0, 1, 2)),
             tconv.separable_convolve(x, [g, g, g], (0, 1, 2)))):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   **tol)


@pytest.mark.parametrize('r,f', [((1, 1, 0), (1, 1, 0)),
                                 ((2, 2, 0), (1, 1, 0)),
                                 ((1, 1, 1), (1, 1, 1))])
@pytest.mark.parametrize('jdt,tdt,tol', [(jnp.float16, torch.float16, F16),
                                         (jnp.bfloat16, torch.bfloat16,
                                          BF16)])
def test_low_precision_nlmeans_matches_jax(r, f, jdt, tdt, tol):
    a = _data((9, 10, 4, 4), seed=7)
    ref = jnlmeans(jnp.asarray(a).astype(jdt), r, f, 0.2, 0.3)
    got = nlmeans(torch.from_numpy(a).to(tdt), r, f, 0.2, 0.3, device='cpu')
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


def test_low_precision_is_filtered_in_float32():
    a = torch.from_numpy(_data((9, 10, 4, 4), seed=8))
    half = a.to(torch.float16)
    got = nlmeans(half, (1, 1, 1), (1, 1, 1), 0.2, 0.3)
    ref = nlmeans(half.float(), (1, 1, 1), (1, 1, 1), 0.2, 0.3)
    assert bool((got == ref.to(torch.float16)).all())
    t = np.array([0.25, 0.5, 0.25])
    got = conv_cuda.sepconv2(half, t, t)
    assert bool((got == conv_cuda.sepconv2(half.float(), t, t)
                 .to(torch.float16)).all())


# ---- NLMeans with wide 3-D windows ------------------------------------------

WIDE_PLANS = [((1024, 1024, 56, 4), (10, 10, 3), (3, 3, 3), 4, 'wide'),
              ((1024, 1024, 56, 4), (5, 5, 5), (2, 2, 2), 8, 'wide'),
              ((1024, 1024, 56, 4), (5, 5, 5), (2, 2, 2), 4, 'ring'),
              ((1024, 1024, 56, 8), (5, 5, 5), (2, 2, 2), 4, 'wide'),
              ((1024, 1024, 56, 4), (4, 4, 4), (3, 3, 3), 8, 'wide'),
              ((1024, 1024, 56, 4), (2, 2, 1), (1, 1, 1), 4, 'ring')]


@pytest.mark.parametrize('shape,r,f,itemsize,route', WIDE_PLANS)
def test_tile_plan_chooses_the_route_from_the_shapes(shape, r, f, itemsize,
                                                     route):
    plan = nlmeans_cuda._tile_plan(shape, r, f, itemsize)
    assert plan['route'] == route
    nv = shape[3]
    ty, tx, tt = plan['tile']
    halo = (ty + 2 * (r[0] + f[0])) * (32 + 2 * r[1]) \
        * (tt + 2 * (r[2] + f[2]))
    assert plan['smem'] == (nv * halo * itemsize if route == 'ring'
                            else nlmeans_cuda.wide_smem(
                                plan['tile'], r, f, nv, itemsize,
                                plan['ring'], plan['fused']))
    assert plan['smem'] <= nlmeans_cuda.SMEM_MAX
    if route == 'wide':
        # the partner rows of one dy in the block's ring
        assert plan['ring']
        # no tile of the ring route holds the halo
        assert nlmeans_cuda._ring_plan(shape, r, f, itemsize) is None
        R, C, tx_run = nlmeans_cuda.ring_run(shape, r, f, itemsize)
        assert nlmeans_cuda.ring_smem((R, tx_run, C), r, f, nv,
                                      itemsize) > nlmeans_cuda.SMEM_MAX
    # every output in exactly one block
    ty, tx, tt = plan['tile']
    assert plan['blocks'] == np.prod([-(-n // t) for n, t in
                                      zip(shape[:3], plan['tile'])])


WIDE = [((24, 24, 8, 4), (10, 10, 3), (3, 3, 3), np.float32),
        ((12, 13, 12, 4), (5, 5, 5), (2, 2, 2), np.float64),
        ((12, 13, 12, 8), (5, 5, 5), (2, 2, 2), np.float32)]


@pytest.mark.parametrize('shape,r,f,dtype', WIDE)
def test_wide_window_plain_matches_jax(shape, r, f, dtype):
    a = _data(shape, dtype, seed=9)
    ref = np.asarray(jnlmeans(jnp.asarray(a), r, f, 2.0, 3.0))
    got = nlmeans_cuda.nlmeans_3d(torch.from_numpy(a), r, f, 2.0, 3.0)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == np.float32 \
        else dict(rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.numpy(), ref, **tol)
