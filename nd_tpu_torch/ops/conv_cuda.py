"""Separable VALID correlation over two or three adjacent axes: the
tiled ``sepconv`` CUDA kernel (``csrc/sepconv.cu``) behind two entry
points, and their plain PyTorch versions.

  - ``sepconv2``: two axes of an ``(outer, n0, n1, inner)`` view (the
    kernel with one tap of weight 1 on its third axis). Replaces
    ``nd_tpu/ops/conv_pallas.py`` ``padless_convolve``,
    ``rowfused_convolve`` and the two-axis case of
    ``separable_convolve_pallas``.
  - ``sepconv3``: three axes of an ``(n0, n1, n2, inner)`` view, n2
    (time) first, then n0, then n1. Replaces the three-axis case of
    ``separable_convolve_pallas``.

On the H100 the kernel is bound by device-memory bytes (one read and one
write per element). Each block stages a tile's raw halo box in shared
memory (cp.async, the boundary mapped only on edge tiles) and runs the
passes there; no padded copy is written. Tap vectors of any length are
taken: up to ``INLINE_TAPS`` per axis travel in the launch parameters,
longer ones as device buffers (cached per tap vector, dtype and device)
that each block copies into shared memory. See the source for the
design.

Dtypes: float32 and float64 run as they are; float16 and bfloat16 are
computed in float32 (the plain version does the same) and returned in
their own dtype. Each entry point runs its kernel for a CUDA tensor and
the plain version for a CPU tensor; for any other device, dtype or
layout it raises. Launches are counted per entry point: ``launches``
(two axes) and ``launches3``; ``launches_long`` counts those of either
with a tap vector longer than ``INLINE_TAPS`` (the long-tap route).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .conv import _shift_add_valid, pad_reflect

__all__ = ['sepconv2', 'sepconv2_plain', 'sepconv3', 'sepconv3_plain',
           'INLINE_TAPS', 'MODES', 'LOW_PRECISION', 'launches', 'launches3']

INLINE_TAPS = 64       # kInlineTaps in csrc/sepconv.cu
# computed in float32, returned in their own dtype
LOW_PRECISION = (torch.float16, torch.bfloat16)
MODES = {'reflect': 0, 'mirror': 1, 'nearest': 2, 'constant': 3,
         'wrap': 4}

launches = 0           # sepconv2 kernel launches since import (or reset)
launches3 = 0          # sepconv3 kernel launches since import (or reset)
launches_long = 0      # of either, those with long taps (weights in smem)


def reset_launches():
    global launches, launches3, launches_long
    launches = 0
    launches3 = 0
    launches_long = 0


def _count_long(*vectors):
    if max(len(w) for w in vectors) > INLINE_TAPS:
        _build.bump(globals(), 'launches_long')


def _taps(taps):
    """(float64 taps, uniform, apply_scale) for the kernel, cached per tap
    vector: the analysis costs more host time than a small launch."""
    return _taps_of(tuple(np.asarray(taps, np.float64).ravel().tolist()))


@functools.lru_cache(maxsize=256)
def _taps_of(taps):
    t = np.ascontiguousarray(taps, np.float64)
    if t.size < 1:
        raise ValueError('sepconv takes at least one tap per axis')
    t.flags.writeable = False
    uniform = bool(np.allclose(t, t[0]))
    return t, uniform, uniform and t[0] != 1.0


@functools.lru_cache(maxsize=64)
def _device_taps(taps, dtype, device):
    """A tap vector longer than ``INLINE_TAPS`` on the card in the
    kernel's dtype (each weight rounded once from float64, as the kernel
    rounds its inline weights), cached so that a call copies nothing."""
    return torch.tensor(taps, dtype=dtype, device=device)


def _long_ptr(w, x):
    """The device weights of a tap vector the kernel does not take
    inline, else None."""
    if len(w) <= INLINE_TAPS:
        return None
    return _device_taps(tuple(w.tolist()), x.dtype, x.device).data_ptr()


def _check(x, mode, name='sepconv2'):
    if not isinstance(x, torch.Tensor) or x.ndim != 4:
        raise ValueError('%s takes a 4-d tensor' % name)
    if x.dtype not in (torch.float32, torch.float64) + LOW_PRECISION:
        raise TypeError('%s takes float32, float64, float16 or bfloat16, '
                        'got %s' % (name, x.dtype))
    if not x.is_contiguous():
        raise ValueError('%s takes a contiguous tensor' % name)
    if mode not in MODES:
        raise ValueError('unsupported boundary mode %r' % (mode,))
    if max(x.shape[:3]) >= 2 ** 31 or x.shape[2] * x.shape[3] >= 2 ** 31:
        raise ValueError('%s takes n0, n1, n2 and the row length below '
                         '2**31' % name)


def _in_float32(fn, x, *args):
    """``fn`` over a float16 or bfloat16 ``x`` computed in float32, the
    result cast back to ``x``'s dtype."""
    return fn(x.to(torch.float32).contiguous(), *args).to(x.dtype)


def sepconv2_plain(x, taps0, taps1, mode='reflect', cval=0.0):
    """Plain PyTorch version of the kernel: boundary gathered by index
    (the kernel's own mapping), then ``_shift_add_valid`` over axis 1
    (taps0) and axis 2 (taps1) — the kernel's add order."""
    _check(x, mode)
    if x.dtype in LOW_PRECISION:
        return _in_float32(sepconv2_plain, x, taps0, taps1, mode, cval)
    k0, k1 = len(np.ravel(taps0)), len(np.ravel(taps1))
    out = pad_reflect(x, ((0, 0), ((k0 - 1) // 2, k0 // 2),
                          ((k1 - 1) // 2, k1 // 2), (0, 0)), mode, cval)
    out = _shift_add_valid(out, np.ravel(taps0), 1)
    return _shift_add_valid(out, np.ravel(taps1), 2)


def sepconv2(x, taps0, taps1, mode='reflect', cval=0.0):
    """Separable VALID correlation of a contiguous ``(outer, n0, n1,
    inner)`` tensor over n0 with ``taps0`` and n1 with ``taps1``
    (already-FLIPPED weights; output ``o`` reads input
    ``o - (k-1)//2 .. o + k//2``, outside positions by ``mode``).
    Taps of any length; where two axes of more than ``INLINE_TAPS`` taps
    each find no tile that fits the shared memory, it raises."""
    _check(x, mode)
    if x.device.type == 'cpu':
        return sepconv2_plain(x, taps0, taps1, mode, cval)
    if x.device.type != 'cuda':
        raise ValueError('sepconv2 runs on cuda or cpu tensors, not %s'
                         % x.device)
    if x.dtype in LOW_PRECISION:
        return _in_float32(sepconv2, x, taps0, taps1, mode, cval)
    w0, u0, s0 = _taps(taps0)
    w1, u1, s1 = _taps(taps1)
    out = torch.empty_like(x)
    name = 'nd_sepconv_f32' if x.dtype == torch.float32 \
        else 'nd_sepconv_f64'
    fn = _build.function(name, 'ppqiiqpiiipiiippidp')
    outer, n0, n1, inner = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), outer, n0, n1, inner,
                 w0.ctypes.data, len(w0), int(u0), int(s0),
                 w1.ctypes.data, len(w1), int(u1), int(s1),
                 _long_ptr(w0, x), _long_ptr(w1, x),
                 MODES[mode], float(cval), stream)
    _build.bump(globals(), 'launches')
    _count_long(w0, w1)
    _build.check(name, err)
    return out


def _pads(k):
    return ((k - 1) // 2, k // 2)


def sepconv3_plain(x, taps0, taps1, taps2, mode='reflect', cval=0.0):
    """Plain PyTorch version of the three-axis kernel: every axis padded
    with the boundary mode (cval everywhere outside in 'constant'), then
    ``_shift_add_valid`` over n2 (taps2), n0 (taps0) and n1 (taps1), in
    that order."""
    _check(x, mode, 'sepconv3')
    if x.dtype in LOW_PRECISION:
        return _in_float32(sepconv3_plain, x, taps0, taps1, taps2, mode,
                           cval)
    t0, t1, t2 = (np.ravel(t) for t in (taps0, taps1, taps2))
    out = pad_reflect(x, (_pads(len(t0)), _pads(len(t1)), _pads(len(t2)),
                          (0, 0)), mode, cval)
    out = _shift_add_valid(out, t2, 2)
    out = _shift_add_valid(out, t0, 0)
    return _shift_add_valid(out, t1, 1)


def sepconv3(x, taps0, taps1, taps2, mode='reflect', cval=0.0):
    """Separable VALID correlation of a contiguous ``(n0, n1, n2, inner)``
    tensor over n2 with ``taps2`` first, then n0 with ``taps0`` and n1
    with ``taps1`` (already-FLIPPED weights; output ``o`` reads input
    ``o - (k-1)//2 .. o + k//2``, outside positions by ``mode``)."""
    _check(x, mode, 'sepconv3')
    if x.device.type == 'cpu':
        return sepconv3_plain(x, taps0, taps1, taps2, mode, cval)
    if x.device.type != 'cuda':
        raise ValueError('sepconv3 runs on cuda or cpu tensors, not %s'
                         % x.device)
    if x.dtype in LOW_PRECISION:
        return _in_float32(sepconv3, x, taps0, taps1, taps2, mode, cval)
    taps = [_taps(t) for t in (taps0, taps1, taps2)]
    out = torch.empty_like(x)
    name = 'nd_sepconv3_f32' if x.dtype == torch.float32 \
        else 'nd_sepconv3_f64'
    fn = _build.function(name, 'ppiiiq' + 'piii' * 3 + 'ppp' + 'idp')
    n0, n1, n2, inner = x.shape
    args = []
    for w, uniform, scale in taps:
        args += [w.ctypes.data, len(w), int(uniform), int(scale)]
    args += [_long_ptr(w, x) for w, _, _ in taps]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n0, n1, n2, inner, *args,
                 MODES[mode], float(cval), stream)
    _build.bump(globals(), 'launches3')
    _count_long(*(w for w, _, _ in taps))
    _build.check(name, err)
    return out
