"""Spatial non-local means: the ``nlmeans`` CUDA kernel
(``csrc/nlmeans.cu``) and its plain PyTorch version.

Replaces ``nd_tpu/ops/nlmeans_pallas.py``: ``_nlmeans_padless`` and
``_nlmeans_rowfused`` (their shared body ``_kernel``). On the H100 the
kernel is bound by arithmetic and L1 traffic — the patch distances,
(2r+1)^2-1 offsets times (2f+1)^2 patch pixels times nv variables per
output — while device memory sees one read and one write of the cube.
One thread per output (y, x, t); the reflect boundary is rebuilt by
index mapping. See the source for the design.

``nlmeans_spatial`` runs the kernel for a CUDA tensor and the plain
version for a CPU tensor; for any other device, dtype or layout it
raises.
"""

from __future__ import annotations

import torch

from .. import _build
from .nlmeans import nlmeans_plain

__all__ = ['nlmeans_spatial', 'nlmeans_spatial_plain', 'launches']

launches = 0           # kernel launches since import (or reset)


def reset_launches():
    global launches
    launches = 0


def _check(arr, r, f):
    if not isinstance(arr, torch.Tensor) or arr.ndim != 4:
        raise ValueError('nlmeans_spatial takes a 4-d (y, x, t, var) '
                         'tensor')
    if arr.dtype not in (torch.float32, torch.float64):
        raise TypeError('nlmeans_spatial takes float32 or float64, got %s'
                        % arr.dtype)
    if not arr.is_contiguous():
        raise ValueError('nlmeans_spatial takes a contiguous tensor')
    if len(r) != 2 or len(f) != 2 or min(*r, *f) < 0:
        raise ValueError('r and f are two non-negative radii (y, x)')
    for name, ext, pad in (('dim 0', arr.shape[0], r[0] + f[0]),
                           ('dim 1', arr.shape[1], r[1] + f[1])):
        if pad >= ext:
            raise ValueError('r + f (%d) must be smaller than %s size (%d)'
                             % (pad, name, ext))


def nlmeans_spatial_plain(arr, r, f, sigma, h, n_eff=-1.0):
    """Plain PyTorch version of the kernel (the r2 = f2 = 0 case of
    :func:`nd_tpu_torch.ops.nlmeans.nlmeans_plain`)."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f)
    return nlmeans_plain(arr, (r[0], r[1], 0), (f[0], f[1], 0), sigma, h,
                         n_eff)


def nlmeans_spatial(arr, r, f, sigma, h, n_eff=-1.0):
    """Spatial NLMeans of a contiguous ``(y, x, t, var)`` tensor over
    (y, x), joint over the variables; t is batched."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f)
    if arr.device.type == 'cpu':
        return nlmeans_spatial_plain(arr, r, f, sigma, h, n_eff)
    if arr.device.type != 'cuda':
        raise ValueError('nlmeans_spatial runs on cuda or cpu tensors, '
                         'not %s' % arr.device)
    ny, nx, nt, nv = arr.shape
    out = torch.empty_like(arr)
    name = 'nd_nlmeans_f32' if arr.dtype == torch.float32 \
        else 'nd_nlmeans_f64'
    fn = _build.function(name, 'ppiiiiiiiidddp')
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream(arr.device).cuda_stream
        err = fn(arr.data_ptr(), out.data_ptr(), ny, nx, nt, nv,
                 r[0], r[1], f[0], f[1], float(sigma), float(h),
                 float(n_eff), stream)
    global launches
    launches += 1
    _build.check(name, err)
    return out
