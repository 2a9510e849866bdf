"""Parity of nd_tpu_torch's three-axis separable convolution, its
``GaussianFilter`` and its three-axis ``BoxcarFilter`` with nd_tpu's.

The same numpy inputs (from a seed) go through the JAX function and its
port. ``separable_convolve_pallas`` runs in interpret mode. Tolerances
for float32: rtol 1e-6, atol 1e-7. The three-axis kernel passes time
first, then y, then x, as the fused TPU route does; nd_tpu on the CPU
passes the axes in their given order, and interpret mode jit-compiles
the kernel, whose fused loops may round a sum differently — one or two
roundings of f32 either way.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nd_tpu.filters as jfilters
from nd_tpu.core import Dataset as JDataset
from nd_tpu.ops import conv as jconv
from nd_tpu.ops.conv_pallas import separable_convolve_pallas
import nd_tpu_torch as ndt
from nd_tpu_torch.core import from_jax_dataset
from nd_tpu_torch.ops import conv as tconv
from nd_tpu_torch.ops import conv_cuda

F32 = dict(rtol=1e-6, atol=1e-7)
MODES = ['reflect', 'mirror', 'nearest', 'constant', 'wrap']
NAMES = ('C11', 'C12__re', 'C12__im', 'C22')


def _data(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_gaussian_kernel_equals_jax():
    for sigma, truncate in ((1.0, 4.0), (1.7, 3.0), (0.5, 4.0), (0, 4.0)):
        np.testing.assert_array_equal(
            tconv.gaussian_kernel1d(sigma, truncate),
            jconv.gaussian_kernel1d(sigma, truncate))


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('taps', ['gaussian', 'boxcar', 'two-axis'])
def test_three_axis_plain_matches_pallas(mode, taps):
    a = _data((12, 20, 9, 2), seed=1)
    g = tconv.gaussian_kernel1d(1.0)
    t0, t1, t2 = {'gaussian': (g, g, g[2:-2]),
                  'boxcar': (np.ones(3) / 27, np.ones(3), np.ones(3)),
                  'two-axis': (np.ones(1), np.array([.2, .5, .3]),
                               np.ones(5) / 5)}[taps]
    pairs = [(ax, t) for ax, t in ((0, t0), (1, t1), (2, t2)) if len(t) > 1]
    ref = np.asarray(separable_convolve_pallas(jnp.asarray(a), pairs,
                                               mode=mode, interpret=True))
    got = conv_cuda.sepconv3(torch.from_numpy(a), t0, t1, t2, mode=mode)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_three_axis_constant_fill_matches_pallas():
    # cval != 0: every axis padded with cval, then the passes
    a = _data((7, 9, 6, 1), seed=2)
    t = np.array([.25, .5, .25])
    ref = np.asarray(separable_convolve_pallas(
        jnp.asarray(a), [(0, t), (1, t), (2, t)], mode='constant',
        cval=1.5, interpret=True))
    got = conv_cuda.sepconv3(torch.from_numpy(a), t, t, t, mode='constant',
                             cval=1.5)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def _jax_stack(ny=14, nx=18, nt=7, seed=3):
    rng = np.random.RandomState(seed)
    return JDataset({v: (('y', 'x', 'time'),
                         rng.rand(ny, nx, nt).astype(np.float32))
                     for v in NAMES},
                    coords={'time': np.arange(nt)})


FILTERS = [
    ('gaussian', dict(dims=('y', 'x', 'time'), sigma=1)),
    ('gaussian', dict(dims=('y', 'x', 'time'), sigma=(1.0, 0.7, 0.5),
                      mode='mirror')),
    ('boxcar', dict(dims=('y', 'x', 'time'), w=3)),
    ('gaussian', dict(dims=('y', 'x'), sigma=1.5)),
]


def _make(kind, kw, pkg):
    cls = {'gaussian': 'GaussianFilter', 'boxcar': 'BoxcarFilter'}[kind]
    return getattr(pkg, cls)(**kw)


@pytest.mark.parametrize('kind,kw', FILTERS)
def test_filter_on_a_dataarray_matches_jax(kind, kw):
    # one variable, (y, x, time): the fused three-axis route
    jda = _jax_stack()['C11']
    ref = _make(kind, kw, jfilters).apply(jda)
    conv_cuda.reset_launches()
    got = _make(kind, kw, ndt).apply(
        from_jax_dataset(_jax_stack(), device='cpu')['C11'])
    assert got.dims == ref.dims
    np.testing.assert_allclose(got.values, ref.values, **F32)
    assert conv_cuda.launches3 == 0               # CPU: the plain version


@pytest.mark.parametrize('kind,kw', FILTERS)
def test_filter_on_a_dataset_matches_jax(kind, kw):
    # four variables stacked to (4, y, x, t), axes (1, 2, 3): per-axis
    # passes, as in nd_tpu
    jds = _jax_stack(seed=4)
    ref = _make(kind, kw, jfilters).apply(jds)
    got = _make(kind, kw, ndt).apply(from_jax_dataset(jds, device='cpu'))
    for v in NAMES:
        assert got[v].dims == ref[v].dims
        np.testing.assert_allclose(got[v].values, ref[v].values, **F32)


def test_routes(monkeypatch):
    # the fused three-axis route: float32, taps over exactly the axes
    # {0, 1, 2}, at most 16 each; separable_convolve keeps per-axis
    # passes for 'constant' with cval != 0
    calls = []
    real = conv_cuda.sepconv3

    def spy(x, t0, t1, t2, **kw):
        calls.append((tuple(x.shape), len(t0), len(t1), len(t2)))
        return real(x, t0, t1, t2, **kw)

    monkeypatch.setattr(conv_cuda, 'sepconv3', spy)
    g = tconv.gaussian_kernel1d(1.0)
    x = torch.from_numpy(_data((10, 11, 6)))
    tconv.separable_convolve(x, [g, g, g], (0, 1, 2))
    tconv.convolve(x, np.ones((3, 3, 3)) / 27, axes=(0, 1, 2))
    tconv.convolve(x[..., None], np.ones((3, 3, 3)) / 27, axes=(0, 1, 2),
                   mode='constant', cval=2.0)
    assert calls == [((10, 11, 6, 1), 9, 9, 9), ((10, 11, 6, 1), 3, 3, 3),
                     ((10, 11, 6, 1), 3, 3, 3)]
    del calls[:]
    tconv.separable_convolve(x.double(), [g, g, g], (0, 1, 2))   # f64
    tconv.separable_convolve(x, [tconv.gaussian_kernel1d(2.5)] * 3,
                             (0, 1, 2))               # 21 taps > 16
    tconv.separable_convolve(x, [g, g], (0, 2))       # two axes
    tconv.separable_convolve(x, [g, g, g], (0, 1, 2), mode='constant',
                             cval=1.0)
    tconv.separable_convolve(x[None], [g, g, g], (1, 2, 3))   # 4 variables
    assert calls == []
    # the per-axis passes agree with the fused route to f32 rounding
    fused = tconv.separable_convolve(x, [g, g, g], (0, 1, 2))
    seq = tconv.separable_convolve(x[None], [g, g, g], (1, 2, 3))[0]
    np.testing.assert_allclose(fused.numpy(), seq.numpy(), **F32)


def test_sepconv3_checks():
    t = np.ones(3)
    with pytest.raises(ValueError, match='contiguous'):
        conv_cuda.sepconv3(torch.zeros(4, 5, 6, 2).transpose(0, 1), t, t, t)
    with pytest.raises(TypeError):
        conv_cuda.sepconv3(torch.zeros(4, 5, 6, 2, dtype=torch.int32),
                           t, t, t)
    # float16 is filtered in float32 and comes back as float16
    half = conv_cuda.sepconv3(torch.ones(4, 5, 6, 2, dtype=torch.float16),
                              t, t, t)
    assert half.dtype == torch.float16 and bool((half == 27).all())
    with pytest.raises(ValueError, match='4-d'):
        conv_cuda.sepconv3(torch.zeros(4, 5, 6), t, t, t)
    with pytest.raises(ValueError, match='cuda or cpu'):
        conv_cuda.sepconv3(torch.zeros(4, 5, 6, 1, device='meta'), t, t, t)
