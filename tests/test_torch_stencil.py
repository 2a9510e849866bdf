"""Non-separable convolution: nd_tpu_torch's ``stencil`` route against
nd_tpu's ``convolve`` (XLA's ``conv_general_dilated``) on the same numpy
inputs, and the plain version's tap order.

Tolerances: float32 rtol 1e-6 with an atol of 1e-6 * sum|k| * max|x|
(the two sum the taps in other orders); float64 rtol 1e-13 with an atol
of 1e-13 * sum|k| * max|x|; float16 rtol/atol 5e-3 (the port filters it
in float32, the reference in float16). Complex input is filtered as its
real and imaginary parts. The plain version's tap order is checked bit
for bit against a loop over the taps in row-major order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.filters import ConvolutionFilter as JConvolutionFilter
from nd_tpu.filters import _expand_kernel as jexpand
from nd_tpu.ops import conv as jconv
from nd_tpu.testing import generate_test_dataset as jgen
import nd_tpu_torch as ndt
from nd_tpu_torch.filters import _expand_kernel
from nd_tpu_torch.ops import conv as tconv
from nd_tpu_torch.ops import stencil_cuda
from nd_tpu_torch.testing import generate_test_dataset

MODES = ['reflect', 'mirror', 'nearest', 'wrap', 'constant']
DISK = np.array([[1.0 if i * i + j * j <= 5 else 0.0 for j in range(-2, 3)]
                 for i in range(-2, 3)])


def _data(shape, dtype=np.float32, seed=0):
    return (np.random.RandomState(seed).rand(*shape) * 2 - 0.5).astype(dtype)


def _kernel(shape, seed=1):
    return np.random.RandomState(seed).rand(*shape) - 0.3


def _tol(a, k, dtype):
    scale = float(np.abs(k).sum() * np.abs(a).max())
    if dtype == np.float64:
        return dict(rtol=1e-13, atol=1e-13 * scale)
    if dtype == np.float16:
        return dict(rtol=5e-3, atol=5e-3 * scale)
    return dict(rtol=1e-6, atol=1e-6 * scale)


def _both(a, k, axes, mode, cval=0.0):
    ref = np.asarray(jconv.convolve(jnp.asarray(a), k, axes=axes, mode=mode,
                                    cval=cval))
    got = tconv.convolve(torch.from_numpy(a), k, axes=axes, mode=mode,
                         cval=cval).numpy()
    return got, ref


CASES = [
    # shape, axes, kernel shape (odd and even sizes: the origin convention)
    ((13, 11, 3, 2), (0, 1), (3, 3)),
    ((13, 11, 3, 2), (0, 1), (4, 2)),
    ((12, 9, 7), (0, 1, 2), (3, 3, 3)),
    ((12, 9, 7), (0, 1, 2), (2, 4, 3)),
    ((12, 9, 7), (0, 2), (3, 2)),
    ((12, 9, 7), (2, 0), (3, 2)),
    ((4, 12, 9, 7), (1, 2), (5, 5)),
    ((7, 8, 6, 5), (0, 1, 2, 3), (3, 2, 3, 2)),
]


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('shape,axes,kshape', CASES)
def test_non_separable_matches_jax(shape, axes, kshape, mode):
    a = _data(shape)
    k = _kernel(kshape)
    got, ref = _both(a, k, axes, mode, cval=1.5)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, **_tol(a, k, np.float32))


@pytest.mark.parametrize('dtype', [np.float64, np.float16])
@pytest.mark.parametrize('mode', ['reflect', 'constant'])
def test_dtypes_match_jax(dtype, mode):
    a = _data((11, 10, 4), dtype)
    k = DISK / DISK.sum()
    got, ref = _both(a, k, (0, 1), mode, cval=0.5)
    assert got.dtype == ref.dtype == dtype
    np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                               **_tol(a.astype(np.float64), k, dtype))


def test_complex_matches_jax():
    a = _data((9, 8, 3)).astype(np.complex64) \
        + 1j * _data((9, 8, 3), seed=5)
    k = _kernel((3, 3))
    got, ref = _both(a, k, (0, 1), 'reflect')
    assert got.dtype == np.complex64
    tol = _tol(np.abs(a), k, np.float32)
    np.testing.assert_allclose(got.real, ref.real, **tol)
    np.testing.assert_allclose(got.imag, ref.imag, **tol)


def test_integer_input_is_filtered_in_float32():
    a = (np.arange(80) % 7).reshape(10, 8).astype(np.int32)
    k = _kernel((3, 3))
    got = tconv.convolve(torch.from_numpy(a), k).numpy()
    assert got.dtype == np.float32
    ref = tconv.convolve(torch.from_numpy(a.astype(np.float32)), k).numpy()
    np.testing.assert_array_equal(got, ref)


def test_plain_version_tap_order():
    """Row-major taps, each product rounded, then added: the order the
    CUDA kernel keeps, so that the two agree bit for bit on the card."""
    x = torch.from_numpy(_data((2, 9, 8, 5, 3)))
    k = _kernel((3, 2, 3)).astype(np.float32).astype(np.float64)
    got = stencil_cuda.stencil_plain(x, k, 'wrap')
    pads = [(0, 0), (1, 1), (0, 1), (1, 1), (0, 0)]
    padded = torch.from_numpy(np.pad(x.numpy(), pads, mode='wrap'))
    ref = None
    for (i, j, m), w in np.ndenumerate(k):
        term = padded[:, i:i + 9, j:j + 8, m:m + 5] * torch.tensor(
            np.float32(w))
        ref = term if ref is None else ref + term
    assert torch.equal(got, ref)
    # the entry point takes the plain version for a CPU tensor
    assert torch.equal(stencil_cuda.stencil(x, k, 'wrap'), got)


def test_stencil_checks_its_input():
    x = torch.zeros(1, 4, 4, 1, 1)
    with pytest.raises(ValueError):
        stencil_cuda.stencil(x[0], np.ones((3, 3, 1)))
    with pytest.raises(TypeError):
        stencil_cuda.stencil(x.to(torch.float16), np.ones((3, 3, 1)))
    with pytest.raises(ValueError):
        stencil_cuda.stencil(x, np.ones((3, 3)))
    with pytest.raises(ValueError):
        stencil_cuda.stencil(x, np.ones((3, 3, 1)), mode='edge')


@pytest.mark.parametrize('dims,kernel', [
    (('y', 'x'), DISK / DISK.sum()),
    (('y', 'x', 'time'), _kernel((3, 3, 3))),
    (('x', 'time'), _kernel((3, 2))),
])
def test_convolution_filter_on_a_dataset_matches_jax(dims, kernel):
    size = {'y': 14, 'x': 12, 'time': 5}
    jds = jgen(dims=size)
    tds = generate_test_dataset(dims=size, device='cpu')
    ref = JConvolutionFilter(dims=dims, kernel=kernel).apply(jds)
    got = ndt.ConvolutionFilter(dims=dims, kernel=kernel).apply(tds)
    for v in ref.data_vars:
        a = np.asarray(jds[v].values)
        assert got[v].dims == ref[v].dims
        np.testing.assert_allclose(got[v].values, np.asarray(ref[v].values),
                                   **_tol(a, kernel, a.dtype.type))


def test_expand_kernel_matches_jax():
    k = _kernel((3, 2))
    for kd, nd in ((('y', 'x'), ('y', 'x', 'time')),
                   (('x', 'time'), ('y', 'x', 'time'))):
        np.testing.assert_array_equal(_expand_kernel(k, kd, nd),
                                      jexpand(k, kd, nd))
    for bad in ((('y', 'z'), ('y', 'x')), (('y',), ('y', 'x'))):
        with pytest.raises(ValueError):
            _expand_kernel(k, *bad)
        with pytest.raises(ValueError):
            jexpand(k, *bad)


def test_weights_cache_keys_on_content_dtype_and_device():
    """The launch's weights (host values passed by value, the device copy)
    are cached by the kernel's float64 bytes, shape, dtype and device:
    equal kernels share an entry, and a kernel changed in place, reshaped
    or asked for in another dtype never gets stale weights."""
    k = _kernel((3, 4, 2))
    host, dev = stencil_cuda._weights(k, torch.float32, torch.device('cpu'))
    again = stencil_cuda._weights(k.copy(), torch.float32,
                                  torch.device('cpu'))
    assert again[0] is host and again[1] is dev
    ref = torch.tensor(k.ravel().tolist(), dtype=torch.float32)
    assert host.dtype == np.float32 and host.shape == k.shape
    assert torch.equal(torch.from_numpy(host).reshape(-1), ref)
    assert torch.equal(dev.reshape(-1), ref)
    k[1, 2, 0] += 0.25                              # changed in place
    changed, _ = stencil_cuda._weights(k, torch.float32, torch.device('cpu'))
    assert changed is not host and changed[1, 2, 0] == np.float32(k[1, 2, 0])
    flat, _ = stencil_cuda._weights(k.reshape(4, 3, 2), torch.float32,
                                    torch.device('cpu'))
    assert flat.shape == (4, 3, 2) and flat is not changed
    f64, dev64 = stencil_cuda._weights(k, torch.float64, torch.device('cpu'))
    assert f64.dtype == np.float64 and np.array_equal(f64, k)
    assert dev64.dtype == torch.float64
    # a float32 kernel is keyed by its float64 value, as the plain version
    # reads it (float(w))
    k32 = k.astype(np.float32)
    h32, _ = stencil_cuda._weights(k32, torch.float64, torch.device('cpu'))
    assert np.array_equal(h32, k32.astype(np.float64))


def test_weights_rounding_matches_the_plain_version():
    """Each weight rounded once from float64 to the input's dtype, as
    ``stencil_plain`` rounds ``float(w)``: the kernel multiplies by the
    same values."""
    k = _kernel((5, 5, 1), seed=4) / 3.0
    for dtype in (torch.float32, torch.float64):
        host, _ = stencil_cuda._weights(k, dtype, torch.device('cpu'))
        for (i, j, m), w in np.ndenumerate(k):
            assert torch.tensor(float(w), dtype=dtype).item() == \
                float(host[i, j, m])
