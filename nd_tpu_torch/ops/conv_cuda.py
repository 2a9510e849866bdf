"""Separable VALID correlation over two or three adjacent axes: the
tiled ``sepconv`` CUDA kernel (``csrc/sepconv.cu``) and the long-tap
one-axis kernel (``csrc/sepconv_long.cu``) behind two entry points, and
their plain PyTorch versions.

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
that each block copies into shared memory. A ``sepconv2`` call whose
first axis is one unscaled tap (weight 1) and whose second has more
than ``INLINE_TAPS`` taps — the one-axis pass ``ops/conv.py`` sends for
a long axis — runs the long-tap kernel instead: register runs of R
outputs per thread, one broadcast weight per tap, blocks of whole rows
or lines (``_long_plan`` picks them from the shapes). See the sources
for the designs.

Dtypes: float32 and float64 run as they are; float16 and bfloat16 are
computed in float32 (the plain version does the same) and returned in
their own dtype. Each entry point runs its kernel for a CUDA tensor and
the plain version for a CPU tensor; for any other device, dtype or
layout it raises. Launches are counted per kernel: ``launches`` (the
tiled kernel from ``sepconv2``) and ``launches3`` (from ``sepconv3``);
``launches_long`` counts those of either with a tap vector longer than
``INLINE_TAPS`` (the tiled kernel's long-tap route, a long axis beside
a short one); ``launches_long_axis`` the long-tap kernel.
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

LONG_RUN_ROWS = 16     # kRowsRun in csrc/sepconv_long.cu
LONG_RUN_LINES = 8     # kLinesRun
SMEM_MAX = 232448      # shared memory a block may use on the H100
LONG_BUDGET = 112 * 1024   # two blocks per SM

launches = 0           # sepconv2: tiled kernel launches since import/reset
launches3 = 0          # sepconv3: tiled kernel launches since import/reset
launches_long = 0      # of either, those with long taps (weights in smem)
launches_long_axis = 0     # sepconv2: long-tap kernel launches


def reset_launches():
    global launches, launches3, launches_long, launches_long_axis
    launches = 0
    launches3 = 0
    launches_long = 0
    launches_long_axis = 0


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


def long_smem(route, k, n, inner, per_block, nb, itemsize):
    """Shared-memory bytes of a block of the long-tap kernel
    (``smem_bytes`` in csrc/sepconv_long.cu): the weights, and on the
    'lines' route ``per_block`` lines' windows (ceil(n/R) R + k - 1
    positions of ``inner`` columns) and outputs, each line at an odd
    stride, and the window's index table (int32); on the 'rows' route
    the ``nb + k - 1`` input rows of ``per_block`` columns."""
    if route == 'lines':
        nw = -(-n // LONG_RUN_LINES) * LONG_RUN_LINES + k - 1
        return (k + per_block * (((nw * inner) | 1) + ((n * inner) | 1))) \
            * itemsize + nw * 4
    return (k + (nb + k - 1) * per_block) * itemsize


def _round32(v):
    return max(32, -(-int(v) // 32) * 32)


@functools.lru_cache(maxsize=256)
def _long_plan(lines, n, inner, k, itemsize):
    """The long-tap kernel's blocks for a (lines, n, inner) pass with k
    taps. 'lines' where inner < 32 and a whole line's window fits: up to
    64 lines a block (fewer where they would not fit ``LONG_BUDGET``, then
    ``SMEM_MAX``), a thread per (line, column, run of
    ``LONG_RUN_LINES``). Otherwise 'rows': ``per_block`` columns (all of
    an inner of at most 64, else 32; fewer where the rows would not fit)
    by ``nb`` outputs (512 down to 16, the most that fit, no more than n
    rounded up to ``LONG_RUN_ROWS``), a thread per (column, run of
    ``LONG_RUN_ROWS``), 256 threads at most. Returns ``dict(route,
    per_block, nb, threads, smem, blocks)``; raises ValueError when the
    taps fit no block."""
    if inner < 32:
        for budget in (LONG_BUDGET, SMEM_MAX):
            fixed = long_smem('lines', k, n, inner, 0, 0, itemsize)
            per_line = long_smem('lines', k, n, inner, 1, 0, itemsize) \
                - fixed
            per_block = min(64, lines, (budget - fixed) // per_line)
            if per_block >= 1:
                runs = -(-n // LONG_RUN_LINES)
                return dict(route='lines', per_block=per_block, nb=0,
                            threads=min(512, _round32(per_block * inner
                                                      * runs)),
                            smem=long_smem('lines', k, n, inner, per_block,
                                           0, itemsize),
                            blocks=-(-lines // per_block))
    top = inner if inner <= 64 else 32
    most = -(-n // LONG_RUN_ROWS) * LONG_RUN_ROWS
    for budget in (LONG_BUDGET, SMEM_MAX):
        for per_block in [c for c in (top, 32, 16, 8, 4, 2, 1) if c <= top]:
            for nb in (512, 256, 128, 64, 32, 16):
                nb = min(nb, most)
                smem = long_smem('rows', k, n, inner, per_block, nb,
                                 itemsize)
                if smem <= budget:
                    return dict(route='rows', per_block=per_block, nb=nb,
                                threads=min(256, _round32(
                                    per_block * nb // LONG_RUN_ROWS)),
                                smem=smem,
                                blocks=lines * -(-n // nb)
                                * -(-inner // per_block))
    raise ValueError('sepconv: %d taps fit no block of the long-tap kernel'
                     % k)


def _long_axis(x, w1, u1, s1, mode, cval):
    """The long-tap kernel over n1 of a checked CUDA ``(outer, n0, n1,
    inner)`` tensor whose n0 pass is one unscaled tap: one pass over the
    ``(outer * n0, n1, inner)`` lines."""
    outer, n0, n1, inner = x.shape
    plan = _long_plan(outer * n0, n1, inner, len(w1), x.element_size())
    out = torch.empty_like(x)
    name = 'nd_sepconv_long_f32' if x.dtype == torch.float32 \
        else 'nd_sepconv_long_f64'
    fn = _build.function(name, 'ppqiqpiiididiiiip')
    taps = None if u1 else _device_taps(tuple(w1.tolist()), x.dtype,
                                        x.device).data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), outer * n0, n1, inner, taps,
                 len(w1), int(u1), int(s1), float(w1[0]), MODES[mode],
                 float(cval), int(plan['route'] == 'lines'),
                 plan['per_block'], plan['nb'], plan['threads'], stream)
    _build.bump(globals(), 'launches_long_axis')
    _build.check(name, err)
    return out


def _entry(fn, x, taps0, taps1, mode, cval):
    """The checks of a ``sepconv2`` entry point: the plain version for a
    CPU tensor, float16 and bfloat16 in float32; None for a CUDA tensor
    of float32 or float64, which the caller launches."""
    _check(x, mode)
    if x.device.type == 'cpu':
        return sepconv2_plain(x, taps0, taps1, mode, cval)
    if x.device.type != 'cuda':
        raise ValueError('sepconv2 runs on cuda or cpu tensors, not %s'
                         % x.device)
    if x.dtype in LOW_PRECISION:
        return _in_float32(fn, x, taps0, taps1, mode, cval)
    return None


def sepconv2(x, taps0, taps1, mode='reflect', cval=0.0):
    """Separable VALID correlation of a contiguous ``(outer, n0, n1,
    inner)`` tensor over n0 with ``taps0`` and n1 with ``taps1``
    (already-FLIPPED weights; output ``o`` reads input
    ``o - (k-1)//2 .. o + k//2``, outside positions by ``mode``).
    Taps of any length; one unscaled tap over n0 with more than
    ``INLINE_TAPS`` over n1 runs the long-tap kernel, anything else the
    tiled one; where two axes of more than ``INLINE_TAPS`` taps each find
    no tile that fits the shared memory, it raises."""
    out = _entry(sepconv2, x, taps0, taps1, mode, cval)
    if out is not None:
        return out
    if takes_long_axis(taps0, taps1):
        return _long_axis(x, *_taps(taps1), mode, cval)
    return _tiled(x, taps0, taps1, mode, cval)


def takes_long_axis(taps0, taps1):
    """Whether :func:`sepconv2` runs the long-tap kernel for these taps:
    one tap of weight 1 over n0 (the one-axis pass of ``ops/conv.py``)
    and more than ``INLINE_TAPS`` over n1."""
    w0, _, _ = _taps(taps0)
    return len(w0) == 1 and w0[0] == 1.0 and len(_taps(taps1)[0]) \
        > INLINE_TAPS


def sepconv2_tiled(x, taps0, taps1, mode='reflect', cval=0.0):
    """:func:`sepconv2` through the tiled kernel whatever the taps (its
    long-tap route for taps past ``INLINE_TAPS``)."""
    out = _entry(sepconv2_tiled, x, taps0, taps1, mode, cval)
    return _tiled(x, taps0, taps1, mode, cval) if out is None else out


def _tiled(x, taps0, taps1, mode, cval):
    """One launch of the tiled kernel over a checked CUDA tensor."""
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
