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
passes there; no padded copy is written. See the source for the design.

Each entry point runs its kernel for a CUDA tensor and the plain version
for a CPU tensor; for any other device, dtype or layout it raises.
Launches are counted per entry point: ``launches`` (two axes) and
``launches3``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .conv import _shift_add_valid, pad_reflect

__all__ = ['sepconv2', 'sepconv2_plain', 'sepconv3', 'sepconv3_plain',
           'MAX_TAPS', 'MODES', 'launches', 'launches3']

MAX_TAPS = 64          # kMaxTaps in csrc/sepconv.cu
MODES = {'reflect': 0, 'mirror': 1, 'nearest': 2, 'constant': 3,
         'wrap': 4}

launches = 0           # sepconv2 kernel launches since import (or reset)
launches3 = 0          # sepconv3 kernel launches since import (or reset)


def reset_launches():
    global launches, launches3
    launches = 0
    launches3 = 0


def _taps(taps):
    """(float64 taps, uniform, apply_scale) for the kernel, cached per tap
    vector: the analysis costs more host time than a small launch."""
    return _taps_of(tuple(np.asarray(taps, np.float64).ravel().tolist()))


@functools.lru_cache(maxsize=256)
def _taps_of(taps):
    t = np.ascontiguousarray(taps, np.float64)
    if not 1 <= t.size <= MAX_TAPS:
        raise ValueError('sepconv takes 1..%d taps per axis, got %d'
                         % (MAX_TAPS, t.size))
    t.flags.writeable = False
    uniform = bool(np.allclose(t, t[0]))
    return t, uniform, uniform and t[0] != 1.0


def _check(x, mode, name='sepconv2'):
    if not isinstance(x, torch.Tensor) or x.ndim != 4:
        raise ValueError('%s takes a 4-d tensor' % name)
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError('%s takes float32 or float64, got %s'
                        % (name, x.dtype))
    if not x.is_contiguous():
        raise ValueError('%s takes a contiguous tensor' % name)
    if mode not in MODES:
        raise ValueError('unsupported boundary mode %r' % (mode,))
    if max(x.shape[:3]) >= 2 ** 31 or x.shape[2] * x.shape[3] >= 2 ** 31:
        raise ValueError('%s takes n0, n1, n2 and the row length below '
                         '2**31' % name)


def sepconv2_plain(x, taps0, taps1, mode='reflect', cval=0.0):
    """Plain PyTorch version of the kernel: boundary gathered by index
    (the kernel's own mapping), then ``_shift_add_valid`` over axis 1
    (taps0) and axis 2 (taps1) — the kernel's add order."""
    _check(x, mode)
    k0, k1 = len(np.ravel(taps0)), len(np.ravel(taps1))
    out = pad_reflect(x, ((0, 0), ((k0 - 1) // 2, k0 // 2),
                          ((k1 - 1) // 2, k1 // 2), (0, 0)), mode, cval)
    out = _shift_add_valid(out, np.ravel(taps0), 1)
    return _shift_add_valid(out, np.ravel(taps1), 2)


def sepconv2(x, taps0, taps1, mode='reflect', cval=0.0):
    """Separable VALID correlation of a contiguous ``(outer, n0, n1,
    inner)`` tensor over n0 with ``taps0`` and n1 with ``taps1``
    (already-FLIPPED weights; output ``o`` reads input
    ``o - (k-1)//2 .. o + k//2``, outside positions by ``mode``)."""
    _check(x, mode)
    if x.device.type == 'cpu':
        return sepconv2_plain(x, taps0, taps1, mode, cval)
    if x.device.type != 'cuda':
        raise ValueError('sepconv2 runs on cuda or cpu tensors, not %s'
                         % x.device)
    w0, u0, s0 = _taps(taps0)
    w1, u1, s1 = _taps(taps1)
    out = torch.empty_like(x)
    name = 'nd_sepconv_f32' if x.dtype == torch.float32 \
        else 'nd_sepconv_f64'
    fn = _build.function(name, 'ppqiiqpiiipiiiidp')
    outer, n0, n1, inner = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), outer, n0, n1, inner,
                 w0.ctypes.data, len(w0), int(u0), int(s0),
                 w1.ctypes.data, len(w1), int(u1), int(s1),
                 MODES[mode], float(cval), stream)
    global launches
    launches += 1
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
    taps = [_taps(t) for t in (taps0, taps1, taps2)]
    out = torch.empty_like(x)
    name = 'nd_sepconv3_f32' if x.dtype == torch.float32 \
        else 'nd_sepconv3_f64'
    fn = _build.function(name, 'ppiiiq' + 'piii' * 3 + 'idp')
    n0, n1, n2, inner = x.shape
    args = []
    for w, uniform, scale in taps:
        args += [w.ctypes.data, len(w), int(uniform), int(scale)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n0, n1, n2, inner, *args,
                 MODES[mode], float(cval), stream)
    global launches3
    launches3 += 1
    _build.check(name, err)
    return out
