"""Non-local means: the ``nlmeans`` CUDA kernel (``csrc/nlmeans.cu``)
and its plain PyTorch version, through two entry points.

  - ``nlmeans_spatial``: windows over (y, x), t batched. Replaces
    ``nd_tpu/ops/nlmeans_pallas.py`` ``_nlmeans_padless`` and
    ``_nlmeans_rowfused``.
  - ``nlmeans_3d``: windows over any of (d0, d1, d2), the reflect
    boundary on d2 (time) too. Replaces the tiled branch of
    ``nlmeans_pallas`` (temporal and full 3-D windows).

All three TPU variants share the body ``_kernel``; on the card one
tiled kernel serves both entry points (the spatial one is its r2 = f2 =
0 case) and keeps that body's algorithm: each unordered offset pair
once, separable patch sums, one exp per D-extended position used for
both directions. On the H100 it is bound by arithmetic and shared-memory
traffic; one block per output tile holds its reflect-mapped halo tile in
shared memory. ``_tile_plan`` picks the tile and the route from the
shapes: windows whose halo tile of every variable fits no block (wide
3-D windows) take the global-halo route, which keeps only the scratch
planes in shared memory and reads the neighbours from device memory.
See the source for the design.

Dtypes: float32 and float64 run as they are; float16 and bfloat16 are
computed in float32 (the plain version does the same) and returned in
their own dtype. Each entry point runs the kernel for a CUDA tensor and
the plain version for a CPU tensor; for any other device, dtype or
layout it raises. Launches are counted per entry point: ``launches``
(spatial) and ``launches_3d``; ``launches_wide`` counts those of either
that took the global-halo route.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .. import _build
from .conv_cuda import LOW_PRECISION, _in_float32
from .nlmeans import nlmeans_plain

__all__ = ['nlmeans_spatial', 'nlmeans_spatial_plain', 'nlmeans_3d',
           'nlmeans_3d_plain', 'launches', 'launches_3d']

launches = 0           # nlmeans_spatial kernel launches since import
launches_3d = 0        # nlmeans_3d kernel launches since import
launches_wide = 0      # of either, those on the global-halo route


def reset_launches():
    global launches, launches_3d, launches_wide
    launches = 0
    launches_3d = 0
    launches_wide = 0


def _check(arr, r, f, name):
    if not isinstance(arr, torch.Tensor) or arr.ndim != 4:
        raise ValueError('%s takes a 4-d (y, x, t, var) tensor' % name)
    if arr.dtype not in (torch.float32, torch.float64) + LOW_PRECISION:
        raise TypeError('%s takes float32, float64, float16 or bfloat16, '
                        'got %s' % (name, arr.dtype))
    if not arr.is_contiguous():
        raise ValueError('%s takes a contiguous tensor' % name)
    if len(r) != len(f) or min(*r, *f) < 0:
        raise ValueError('r and f are non-negative radii, one per axis')
    for i, (ri, fi) in enumerate(zip(r, f)):
        if ri + fi >= arr.shape[i] and ri + fi > 0:
            raise ValueError('r + f (%d) must be smaller than dim %d size '
                             '(%d)' % (ri + fi, i, arr.shape[i]))


OUTS_PER_THREAD = 2         # kOut in csrc/nlmeans.cu
SMEM_MAX = 232448           # shared memory a block may use on the H100
SMEM_BUDGET = 112 * 1024    # two blocks per SM
_TILE_SIDES = (4, 8, 16, 32)
_TILE_T = (1, 2, 4, 8, 16)


def tile_smem(tile, r, f, nv, itemsize, route='staged'):
    """Shared-memory bytes of a block of the kernel (``tile_sizes`` in
    csrc/nlmeans.cu): on the 'staged' route the (ty + 2(ry+fy),
    tx + 2(rx+fx), tt + 2(rt+ft)) halo tile of all ``nv`` variables, on
    both routes two scratch planes of the largest D-extended patch
    region (T + r + 2f per axis)."""
    halo = 1
    region = 1
    for t, ri, fi in zip(tile, r, f):
        halo *= t + 2 * (ri + fi)
        region *= t + ri + 2 * fi
    return (nv * halo * (route == 'staged') + 2 * region) * itemsize


@functools.lru_cache(maxsize=256)
def _tile_plan(shape, r, f, itemsize):
    """The route, the output tile ``(ty, tx, tt)`` of one block and its
    shared memory, chosen from the shapes: the least work per output —
    the D-extended region a pair evaluates, averaged over the pairs,
    times the share of outputs that fall outside a ragged array — among
    tiles of 128 to 1024 outputs (64 to 512 threads, ``OUTS_PER_THREAD``
    each) within ``SMEM_BUDGET`` (two blocks per SM), else the smallest
    such tile within ``SMEM_MAX``. Ties take the smaller shared memory.
    The 'staged' route (the halo tile of every variable in shared
    memory) where any tile fits it, else the 'global' route (only the
    scratch planes; wide windows). Returns ``dict(route, tile, threads,
    smem, blocks)``; raises ValueError when no tile fits either route.
    Cached per call signature: the search costs milliseconds of host
    time, more than a spatial launch."""
    dims = tuple(int(v) for v in shape[:3])
    nv = int(shape[3])
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    pairs = [d for d in itertools.product(*[range(-ri, ri + 1) for ri in r])
             if d > (0, 0, 0)] or [(0, 0, 0)]
    for route in ('staged', 'global'):
        best = None
        for tile in itertools.product(_TILE_SIDES, _TILE_SIDES, _TILE_T):
            outs = tile[0] * tile[1] * tile[2]
            if not 128 <= outs <= 512 * OUTS_PER_THREAD:
                continue
            smem = tile_smem(tile, r, f, nv, itemsize, route)
            if smem > SMEM_MAX:
                continue
            work = sum(np.prod([t + abs(di) + 2 * fi for t, di, fi
                                in zip(tile, d, f)]) for d in pairs)
            covered = np.prod([-(-n // t) * t for n, t in zip(dims, tile)])
            cost = work / len(pairs) / outs * covered / np.prod(dims)
            key = (smem > SMEM_BUDGET, cost if smem <= SMEM_BUDGET else smem,
                   smem)
            if best is None or key < best[0]:
                best = (key, tile, smem)
        if best is not None:
            break
    else:
        raise ValueError('nlmeans: no tile fits the shared memory for %d '
                         'variables at r=%r, f=%r' % (nv, r, f))
    _, tile, smem = best
    outs = tile[0] * tile[1] * tile[2]
    blocks = int(np.prod([-(-n // t) for n, t in zip(dims, tile)]))
    return dict(route=route, tile=tile, threads=outs // OUTS_PER_THREAD,
                smem=smem, blocks=blocks)


def _launch(arr, r, f, sigma, h, n_eff):
    """One launch of the kernel over a checked CUDA tensor; r and f are
    (r0, r1, r2) and (f0, f1, f2)."""
    ny, nx, nt, nv = arr.shape
    plan = _tile_plan(tuple(arr.shape), tuple(r), tuple(f),
                      arr.element_size())
    out = torch.empty_like(arr)
    name = 'nd_nlmeans_f32' if arr.dtype == torch.float32 \
        else 'nd_nlmeans_f64'
    fn = _build.function(name, 'ppiiiiiiiiiiiiiidddp')
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream(arr.device).cuda_stream
        err = fn(arr.data_ptr(), out.data_ptr(), ny, nx, nt, nv,
                 r[0], r[1], r[2], f[0], f[1], f[2], *plan['tile'],
                 int(plan['route'] == 'global'), float(sigma), float(h),
                 float(n_eff), stream)
    if plan['route'] == 'global':
        _build.bump(globals(), 'launches_wide')
    _build.check(name, err)
    return out


def nlmeans_spatial_plain(arr, r, f, sigma, h, n_eff=-1.0):
    """Plain PyTorch version of the kernel (the r2 = f2 = 0 case of
    :func:`nd_tpu_torch.ops.nlmeans.nlmeans_plain`)."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f, 'nlmeans_spatial')
    if arr.dtype in LOW_PRECISION:
        return _in_float32(nlmeans_spatial_plain, arr, r, f, sigma, h, n_eff)
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
    if arr.dtype in LOW_PRECISION:
        return _in_float32(nlmeans_spatial, arr, r, f, sigma, h, n_eff)
    _build.bump(globals(), 'launches')
    return _launch(arr, (r[0], r[1], 0), (f[0], f[1], 0), sigma, h, n_eff)


def nlmeans_3d_plain(arr, r, f, sigma, h, n_eff=-1.0):
    """Plain PyTorch version of the kernel with a (d0, d1, d2) window
    (:func:`nd_tpu_torch.ops.nlmeans.nlmeans_plain`)."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    _check(arr, r, f, 'nlmeans_3d')
    if arr.dtype in LOW_PRECISION:
        return _in_float32(nlmeans_3d_plain, arr, r, f, sigma, h, n_eff)
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
    if arr.dtype in LOW_PRECISION:
        return _in_float32(nlmeans_3d, arr, r, f, sigma, h, n_eff)
    _build.bump(globals(), 'launches_3d')
    return _launch(arr, r, f, sigma, h, n_eff)
