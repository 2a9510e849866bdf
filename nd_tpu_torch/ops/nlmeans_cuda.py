"""Non-local means: the ``nlmeans`` CUDA kernel (``csrc/nlmeans.cu``)
and its plain PyTorch version, through two entry points.

  - ``nlmeans_spatial``: windows over (y, x), t batched. Replaces
    ``nd_tpu/ops/nlmeans_pallas.py`` ``_nlmeans_padless`` and
    ``_nlmeans_rowfused``.
  - ``nlmeans_3d``: windows over any of (d0, d1, d2), the reflect
    boundary on d2 (time) too. Replaces the tiled branch of
    ``nlmeans_pallas`` (temporal and full 3-D windows).

All three TPU variants share the body ``_kernel``; on the card one
kernel serves both entry points (the spatial one is its r2 = f2 = 0
case). On the H100 the kernel is bound by arithmetic and L1 traffic —
offsets times patch pixels times nv variables per output — while device
memory sees one read and one write of the cube. One thread per output
(y, x, t); the reflect boundary is rebuilt by index mapping. See the
source for the design.

Each entry point runs the kernel for a CUDA tensor and the plain version
for a CPU tensor; for any other device, dtype or layout it raises.
Launches are counted per entry point: ``launches`` (spatial) and
``launches_3d``.
"""

from __future__ import annotations

import torch

from .. import _build
from .nlmeans import nlmeans_plain

__all__ = ['nlmeans_spatial', 'nlmeans_spatial_plain', 'nlmeans_3d',
           'nlmeans_3d_plain', 'launches', 'launches_3d']

launches = 0           # nlmeans_spatial kernel launches since import
launches_3d = 0        # nlmeans_3d kernel launches since import


def reset_launches():
    global launches, launches_3d
    launches = 0
    launches_3d = 0


def _check(arr, r, f, name):
    if not isinstance(arr, torch.Tensor) or arr.ndim != 4:
        raise ValueError('%s takes a 4-d (y, x, t, var) tensor' % name)
    if arr.dtype not in (torch.float32, torch.float64):
        raise TypeError('%s takes float32 or float64, got %s'
                        % (name, arr.dtype))
    if not arr.is_contiguous():
        raise ValueError('%s takes a contiguous tensor' % name)
    if len(r) != len(f) or min(*r, *f) < 0:
        raise ValueError('r and f are non-negative radii, one per axis')
    for i, (ri, fi) in enumerate(zip(r, f)):
        if ri + fi >= arr.shape[i] and ri + fi > 0:
            raise ValueError('r + f (%d) must be smaller than dim %d size '
                             '(%d)' % (ri + fi, i, arr.shape[i]))


def _launch(arr, r, f, sigma, h, n_eff):
    """One launch of the kernel over a checked CUDA tensor; r and f are
    (r0, r1, r2) and (f0, f1, f2)."""
    ny, nx, nt, nv = arr.shape
    out = torch.empty_like(arr)
    name = 'nd_nlmeans_f32' if arr.dtype == torch.float32 \
        else 'nd_nlmeans_f64'
    fn = _build.function(name, 'ppiiiiiiiiiidddp')
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream(arr.device).cuda_stream
        err = fn(arr.data_ptr(), out.data_ptr(), ny, nx, nt, nv,
                 r[0], r[1], r[2], f[0], f[1], f[2], float(sigma),
                 float(h), float(n_eff), stream)
    _build.check(name, err)
    return out


def nlmeans_spatial_plain(arr, r, f, sigma, h, n_eff=-1.0):
    """Plain PyTorch version of the kernel (the r2 = f2 = 0 case of
    :func:`nd_tpu_torch.ops.nlmeans.nlmeans_plain`)."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f, 'nlmeans_spatial')
    return nlmeans_plain(arr, (r[0], r[1], 0), (f[0], f[1], 0), sigma, h,
                         n_eff)


def nlmeans_spatial(arr, r, f, sigma, h, n_eff=-1.0):
    """Spatial NLMeans of a contiguous ``(y, x, t, var)`` tensor over
    (y, x), joint over the variables; t is batched."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f, 'nlmeans_spatial')
    if len(r) != 2:
        raise ValueError('nlmeans_spatial takes two radii (y, x)')
    if arr.device.type == 'cpu':
        return nlmeans_spatial_plain(arr, r, f, sigma, h, n_eff)
    if arr.device.type != 'cuda':
        raise ValueError('nlmeans_spatial runs on cuda or cpu tensors, '
                         'not %s' % arr.device)
    global launches
    launches += 1
    return _launch(arr, (r[0], r[1], 0), (f[0], f[1], 0), sigma, h, n_eff)


def nlmeans_3d_plain(arr, r, f, sigma, h, n_eff=-1.0):
    """Plain PyTorch version of the kernel with a (d0, d1, d2) window
    (:func:`nd_tpu_torch.ops.nlmeans.nlmeans_plain`)."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f, 'nlmeans_3d')
    return nlmeans_plain(arr, r, f, sigma, h, n_eff)


def nlmeans_3d(arr, r, f, sigma, h, n_eff=-1.0):
    """NLMeans of a contiguous ``(d0, d1, d2, var)`` tensor with a search
    window ``r`` and patch ``f`` over the three axes (``r = (r0, r1,
    r2)``), joint over the variables, the numpy 'reflect' boundary on
    every axis."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f, 'nlmeans_3d')
    if len(r) != 3:
        raise ValueError('nlmeans_3d takes three radii (d0, d1, d2)')
    if arr.device.type == 'cpu':
        return nlmeans_3d_plain(arr, r, f, sigma, h, n_eff)
    if arr.device.type != 'cuda':
        raise ValueError('nlmeans_3d runs on cuda or cpu tensors, not %s'
                         % arr.device)
    global launches_3d
    launches_3d += 1
    return _launch(arr, r, f, sigma, h, n_eff)
