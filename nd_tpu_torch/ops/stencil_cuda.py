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
windows. Each block stages a tile's halo box and the weights in shared
memory and forms every output of the tile there; a kernel too large for
any tile reads device memory directly. See the source for the design.

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

import functools

import numpy as np
import torch

from .. import _build
from .conv import pad_reflect

__all__ = ['stencil', 'stencil_plain', 'stencil_tiled', 'MODES',
           'launches']

MODES = {'reflect': 0, 'mirror': 1, 'nearest': 2, 'constant': 3,
         'wrap': 4}

launches = 0           # stencil kernel launches since import (or reset)


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
def _device_weights(weights, shape, dtype, device):
    """The flipped kernel on the card in the kernel's dtype (each weight
    rounded once from float64), cached so that a call copies nothing."""
    return torch.tensor(weights, dtype=dtype, device=device).reshape(shape)


@functools.lru_cache(maxsize=256)
def stencil_tiled(n0, n1, n2, inner, k0, k1, k2, itemsize):
    """True where the kernel takes these extents in shared-memory tiles,
    False where it takes the direct route (the plan in csrc/stencil.cu)."""
    fn = _build.function('nd_stencil_tiled', 'iiiqiiii')
    return bool(fn(n0, n1, n2, inner, k0, k1, k2, itemsize))


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
    w = _device_weights(tuple(np.asarray(k, np.float64).ravel().tolist()),
                        k.shape, x.dtype, x.device)
    out = torch.empty_like(x)
    name = 'nd_stencil_f32' if x.dtype == torch.float32 else 'nd_stencil_f64'
    fn = _build.function(name, 'ppqiiiqpiiiidp')
    outer, n0, n1, n2, inner = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), outer, n0, n1, n2, inner,
                 w.data_ptr(), *k.shape, MODES[mode], float(cval), stream)
    _build.bump(globals(), 'launches')
    _build.check(name, err)
    return out
