"""Non-separable VALID correlation over up to three adjacent axes: the
tiled ``stencil`` CUDA kernel (``csrc/stencil.cu``) and its plain
PyTorch version.

``stencil`` filters a contiguous ``(outer, n0, n1, n2, inner)`` view
with an already-FLIPPED ``(k0, k1, k2)`` kernel (a two-axis filter
passes ``k2 = 1``): output ``o`` along an axis reads input
``o - (k-1)//2 .. o + k//2``, positions outside by the boundary mode.
Replaces ``nd_tpu/ops/conv.py`` ``_conv_valid`` (XLA's
``conv_general_dilated``, no Pallas kernel).

On the H100 the kernel is bound by device-memory bytes at the path's
windows. Persistent blocks stage each tile's halo box in shared memory
(16-byte copies where the layout allows, the next tile's box while they
compute the current one); each thread slides a run of ``RUN`` outputs
along n0, reading each staged value once for the whole run. Every
window of at most 7 rows along n0, 9 taps a row (k1 * k2) and 64
float32 (32 float64) taps is unrolled at compile time, its weights
passed by value in the launch parameters (``UNROLLED``); other windows
take runtime tap loops with the weights in shared memory. A kernel too
large for any tile reads device memory directly. See the source for the
design.

Numerics: one accumulator per output over the taps in row-major order,
each tap's product rounded, then added (``-fmad=false``), zero taps
included; the plain version does the same operations in the same order,
so the two agree bit for bit on the card.

Dtypes: float32 and float64; others raise (``ops.conv.convolve`` filters
float16 and bfloat16 in float32 and splits complex input). A CUDA tensor
launches the kernel, a CPU tensor takes the plain version, any other
device raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .. import _build
from .conv import pad_reflect

__all__ = ['stencil', 'stencil_plain', 'stencil_tiled', 'stencil_route',
           'MODES', 'RUN', 'UNROLLED', 'launches']

MODES = {'reflect': 0, 'mirror': 1, 'nearest': 2, 'constant': 3,
         'wrap': 4}

launches = 0           # stencil kernel launches since import (or reset)
# outputs a thread runs along n0: 0 takes the kernel's default
# (default_plan in csrc/stencil.cu); 8 or 16 force one (python -m
# nd_tpu_torch.scan_sweep stencil sweeps them)
RUN = 0
# False forces the generic build on windows that have an unrolled one (the
# sweep's A/B); both give the same bits
UNROLLED = True
_ROUTES = ('direct', 'generic', 'unrolled')


def reset_launches():
    global launches
    launches = 0


def _check(x, kernel, mode):
    if not isinstance(x, torch.Tensor) or x.ndim != 5:
        raise ValueError('stencil takes a 5-d (outer, n0, n1, n2, inner) '
                         'tensor')
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError('stencil takes float32 or float64, got %s'
                        % x.dtype)
    if not x.is_contiguous():
        raise ValueError('stencil takes a contiguous tensor')
    if mode not in MODES:
        raise ValueError('unsupported boundary mode %r' % (mode,))
    k = np.asarray(kernel)
    if k.ndim != 3 or min(k.shape) < 1:
        raise ValueError('stencil takes a (k0, k1, k2) kernel, got shape %r'
                         % (k.shape,))
    if max(x.shape[1:4]) >= 2 ** 31 or x.shape[0] >= 2 ** 31 \
            or x.shape[3] * x.shape[4] >= 2 ** 31:
        raise ValueError('stencil takes outer, n0, n1 and the row length '
                         'below 2**31')
    return k


def stencil_plain(x, kernel, mode='reflect', cval=0.0):
    """Plain PyTorch version of the kernel: the three axes padded with
    the boundary mode (its index mapping), then one shifted product per
    tap added in row-major order, the first product starting the sum."""
    k = _check(x, kernel, mode)
    pads = [(0, 0)] + [((n - 1) // 2, n // 2) for n in k.shape] + [(0, 0)]
    padded = pad_reflect(x, pads, mode, cval)
    _, n0, n1, n2, _ = x.shape
    out = None
    for (j0, j1, j2), w in np.ndenumerate(k):
        term = padded[:, j0:j0 + n0, j1:j1 + n1, j2:j2 + n2] \
            * torch.tensor(float(w), dtype=x.dtype, device=x.device)
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=64)
def _cached_weights(data, shape, dtype, device):
    host = np.frombuffer(data, np.float64).reshape(shape).astype(
        np.float32 if dtype == torch.float32 else np.float64)
    return host, torch.from_numpy(host).to(device)


def _weights(k, dtype, device):
    """The flipped kernel ``k`` in ``dtype`` (each weight rounded once from
    float64) on the host, whose values the launch passes by value, and on
    ``device``, cached by the kernel's float64 bytes, shape, dtype and
    device so that a call copies nothing."""
    k = np.ascontiguousarray(k, np.float64)
    return _cached_weights(k.tobytes(), k.shape, dtype, device)


@functools.lru_cache(maxsize=256)
def stencil_route(n0, n1, n2, inner, k0, k1, k2, itemsize, run=0,
                  unrolled=True):
    """'unrolled' or 'generic' where the kernel takes these extents in
    shared-memory tiles (the window unrolled at compile time, or runtime
    tap loops), 'direct' where it reads device memory directly (the plan
    in csrc/stencil.cu)."""
    fn = _build.function('nd_stencil_tiled', 'iiiqiiiiii')
    route = fn(n0, n1, n2, inner, k0, k1, k2, itemsize, run, int(unrolled))
    if route < 0:
        raise ValueError('stencil run %r or item size %r not built'
                         % (run, itemsize))
    return _ROUTES[route]


def stencil_tiled(n0, n1, n2, inner, k0, k1, k2, itemsize):
    """True where the kernel takes these extents in shared-memory tiles,
    False where it takes the direct route."""
    return stencil_route(n0, n1, n2, inner, k0, k1, k2, itemsize) != 'direct'


def stencil(x, kernel, mode='reflect', cval=0.0):
    """VALID correlation of a contiguous ``(outer, n0, n1, n2, inner)``
    tensor with the already-FLIPPED ``(k0, k1, k2)`` ``kernel`` over n0,
    n1 and n2 (see the module docstring); the output has ``x``'s shape
    and dtype."""
    k = _check(x, kernel, mode)
    if x.device.type == 'cpu':
        return stencil_plain(x, k, mode, cval)
    if x.device.type != 'cuda':
        raise ValueError('stencil runs on cuda or cpu tensors, not %s'
                         % x.device)
    host, w = _weights(k, x.dtype, x.device)
    out = torch.empty_like(x)
    name = 'nd_stencil_f32' if x.dtype == torch.float32 else 'nd_stencil_f64'
    fn = _build.function(name, 'ppqiiiqppiiiidiip')
    index = x.device.index
    guard = torch.cuda.device(index) if index != torch.cuda.current_device() \
        else contextlib.nullcontext()
    with guard:
        err = fn(x.data_ptr(), out.data_ptr(), *x.shape, w.data_ptr(),
                 host.ctypes.data, *k.shape, MODES[mode], float(cval), RUN,
                 int(UNROLLED), torch._C._cuda_getCurrentRawStream(index))
    _build.bump(globals(), 'launches')
    _build.check(name, err)
    return out
