"""Non-local means: the ``nlmeans`` CUDA kernels (``csrc/nlmeans.cu``,
``csrc/nlmeans_wide.cu``) and their plain PyTorch version, through two
entry points.

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
shared memory. ``_tile_plan`` picks the kernel and its tile from the
shapes: windows whose halo tile of every variable fits no block (wide
3-D windows) take the wide-window kernel, which pads the cube once into
a scratch buffer, evaluates every offset of the window at its own
outputs and keeps the padded rows of one dy of offsets in a ring in
shared memory (``_wide_plan``). See the sources for the designs.

Dtypes: float32 and float64 run as they are; float16 and bfloat16 are
computed in float32 (the plain version does the same) and returned in
their own dtype. Each entry point runs the kernel for a CUDA tensor and
the plain version for a CPU tensor; for any other device, dtype or
layout it raises. Launches are counted per kernel and entry point:
``launches`` (spatial) and ``launches_3d`` count the tiled kernel,
``launches_wide`` the wide-window kernel from either entry point.
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

launches = 0           # nlmeans_spatial: tiled kernel launches
launches_3d = 0        # nlmeans_3d: tiled kernel launches
launches_wide = 0      # either entry point: wide-window kernel launches


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
WIDE_MAX_E = 8              # kMaxE in csrc/nlmeans_wide.cu
WIDE_MAX_OUT = 2            # kMaxOut
WIDE_MAX_THREADS = 512
WIDE_FAST_TAPS = 7          # kFastTaps: patch widths the unrolled builds take
WIDE_RUN = 4                # kRun: a fused thread's run of t (y) outputs
WIDE_GROUP = 4              # kGroup: dt offsets a window of the fused build
_WIDE_SIDES = (1, 2, 4, 8, 16, 32)
_WIDE_T = (1, 2, 4, 8, 16)
_WIDE_BLOCK_COST = 2048     # a block's fixed cost per offset (syncs, loop)


def tile_smem(tile, r, f, nv, itemsize):
    """Shared-memory bytes of a block of the tiled kernel (``tile_sizes``
    in csrc/nlmeans.cu): the (ty + 2(ry+fy), tx + 2(rx+fx),
    tt + 2(rt+ft)) halo tile of all ``nv`` variables and two scratch
    planes of the largest D-extended patch region (T + r + 2f per
    axis)."""
    halo = 1
    region = 1
    for t, ri, fi in zip(tile, r, f):
        halo *= t + 2 * (ri + fi)
        region *= t + ri + 2 * fi
    return (nv * halo + 2 * region) * itemsize


def ring_row(sx, st):
    """Positions of one ring row of the wide-window kernel (``ring_row``
    in csrc/nlmeans_wide.cu): sx x positions at the odd stride st | 1,
    padded to 1 mod 8 so that consecutive rows fall in distinct banks."""
    n = sx * (st | 1)
    return n + (9 - n % 8) % 8


def wide_smem(tile, r, f, nv, itemsize, ring=True, fused=False):
    """Shared-memory bytes of a block of the wide-window kernel
    (``wide_elems`` in csrc/nlmeans_wide.cu): with ``ring``, ty + 2fy + 1
    padded rows of every variable (:func:`ring_row` positions each); the
    region's squared differences (tile + 2f per axis) and the planes
    after the t and the y pass, or in the ``fused`` build the planes
    after t (its t at an odd stride) and after y (two, by window parity)
    of each of a window's ``WIDE_GROUP`` dt offsets; for nv other than 4
    the own box (the region) of every variable and the tile's
    accumulators."""
    ty, tx, tt = tile
    ry, rx, rt = r
    fy, fx, ft = f
    ey, ex, et = ty + 2 * fy, tx + 2 * fx, tt + 2 * ft
    rows = (ey + 1) * ring_row(tx + 2 * (rx + fx), tt + 2 * (rt + ft)) \
        * nv if ring else 0
    planes = WIDE_GROUP * (ey * ex * (tt | 1) + 2 * ty * ex * tt) if fused \
        else ey * ex * et + ey * ex * tt + ty * ex * tt
    generic = 0 if nv == 4 else (ey * ex * et + ty * tx * tt) * nv
    return (rows + planes + generic) * itemsize


def wide_fused(tile, f, nv, itemsize, ring):
    """Whether the wide-window kernel's fused build takes the tile:
    float32, nv = 4, the ring, patch passes of at most
    ``WIDE_FAST_TAPS`` taps, ty + 2 fy <= 32 (a warp holds whole region
    columns) and the warps for every run of ``WIDE_RUN`` t outputs within
    ``WIDE_MAX_THREADS``."""
    return (itemsize == 4 and nv == 4 and ring
            and 2 * max(f) + 1 <= WIDE_FAST_TAPS
            and tile[0] + 2 * f[0] <= 32
            and _fused_threads(tile, f) <= WIDE_MAX_THREADS)


def _fused_runs(tile, f):
    ty, tx, tt = tile
    return (ty + 2 * f[0]) * (tx + 2 * f[1]) * -(-tt // WIDE_RUN)


def _fused_threads(tile, f):
    """The fused build's threads for its runs: a unit (one x column and
    t run of the region, its ty + 2 fy rows on consecutive lanes) never
    spans two warps."""
    ty, tx, tt = tile
    ey = ty + 2 * f[0]
    units = (tx + 2 * f[1]) * -(-tt // WIDE_RUN)
    return 32 * -(-units // (32 // ey)) if ey <= 32 else 1 << 30


def wide_threads(tile, f, fused=False):
    """Threads of a block of the wide-window kernel: a multiple of 32 with
    one output each up to 512, at most ``WIDE_MAX_OUT`` outputs each, and
    ``WIDE_MAX_E`` region positions each (the kernel's register arrays)
    or, in the ``fused`` build, whole warps for its runs
    (:func:`_fused_threads`)."""
    nout = int(np.prod(tile))
    region = int(np.prod([t + 2 * fi for t, fi in zip(tile, f)]))
    need = max(min(nout, WIDE_MAX_THREADS), -(-nout // WIDE_MAX_OUT),
               _fused_threads(tile, f) if fused
               else -(-region // WIDE_MAX_E))
    return -(-need // 32) * 32


def _wide_cost(tile, f, nv, fused=False):
    """Work per output and offset of the wide-window kernel: the squared
    differences over the region (the fused build: over each run of
    ``WIDE_RUN`` t outputs and its 2 ft halo), the t and y passes over
    their planes, the x pass, weight and weighted add at each output, and
    a block's fixed cost."""
    ty, tx, tt = tile
    fy, fx, ft = f
    ey, ex, et = ty + 2 * fy, tx + 2 * fx, tt + 2 * ft
    run_in = _fused_runs(tile, f) * (min(tt, WIDE_RUN) + 2 * ft) if fused \
        else ey * ex * et
    work = run_in * 3 * nv + ty * tx * tt * (2 * fx + 2 * nv + 12) \
        + _WIDE_BLOCK_COST * (1 + (ft > 0) + (fy > 0))
    if ft > 0:
        work += ey * ex * tt * (2 * ft + 1)
    if fy > 0:
        work += ty * ex * tt * (2 * fy + 1)
    return work / (ty * tx * tt)


@functools.lru_cache(maxsize=256)
def _wide_plan(shape, r, f, itemsize):
    """The wide-window kernel's tile ``(ty, tx, tt)``, threads and build,
    chosen from the shapes: among tiles of up to 1024 outputs whose ring
    of padded rows fits ``SMEM_MAX``, the fused build's where one takes
    them (:func:`wide_fused`), and the least work per output
    (``_wide_cost``, times the share of outputs that fall outside a
    ragged array); else (windows of about 40 positions or more on two
    axes) among tiles that fit without the ring, the partner then read
    from the padded cube. Ties take the smaller shared memory. Returns
    ``dict(route='wide', ring, fused, tile, threads, smem, blocks,
    padded)``, ``padded`` the scratch cube's (y, x, t) extents: whole
    tiles plus r + f on each side; raises ValueError when no tile
    fits."""
    dims = tuple(int(v) for v in shape[:3])
    nv = int(shape[3])
    for ring in (True, False):
        best = None
        for tile in itertools.product(_WIDE_SIDES, _WIDE_SIDES, _WIDE_T):
            if np.prod(tile) > WIDE_MAX_OUT * WIDE_MAX_THREADS:
                continue
            fused = wide_fused(tile, f, nv, itemsize, ring)
            threads = wide_threads(tile, f, fused)
            smem = wide_smem(tile, r, f, nv, itemsize, ring, fused)
            if threads > WIDE_MAX_THREADS or smem > SMEM_MAX:
                continue
            covered = np.prod([-(-n // t) * t for n, t in zip(dims, tile)])
            cost = _wide_cost(tile, f, nv, fused) * covered / np.prod(dims)
            key = (not fused, cost, smem)
            if best is None or key < best[0]:
                best = (key, tile)
        if best is not None:
            break
    else:
        raise ValueError('nlmeans: no tile fits the shared memory for %d '
                         'variables at r=%r, f=%r' % (nv, r, f))
    return wide_plan_of(shape, r, f, itemsize, best[1], ring)


def wide_plan_of(shape, r, f, itemsize, tile, ring, fused=None):
    """The wide-window kernel's plan dict for a given tile, ring choice
    and build (by default the fused one where it takes the tile): what
    ``_wide_plan`` returns for its pick."""
    if fused is None:
        fused = wide_fused(tile, f, int(shape[3]), itemsize, ring)
    dims = tuple(int(v) for v in shape[:3])
    blocks = int(np.prod([-(-n // t) for n, t in zip(dims, tile)]))
    padded = tuple(-(-n // t) * t + 2 * (ri + fi)
                   for n, t, ri, fi in zip(dims, tile, r, f))
    return dict(route='wide', ring=ring, fused=fused, tile=tuple(tile),
                threads=wide_threads(tile, f, fused),
                smem=wide_smem(tile, r, f, int(shape[3]), itemsize, ring,
                               fused),
                blocks=blocks, padded=padded)


@functools.lru_cache(maxsize=256)
def _tile_plan(shape, r, f, itemsize):
    """The kernel and its block, chosen from the shapes. The tiled kernel
    ('staged': the halo tile of every variable in shared memory) where a
    tile fits: the least work per output — the D-extended region a pair
    evaluates, averaged over the pairs, times the share of outputs that
    fall outside a ragged array — among tiles of 128 to 1024 outputs (64
    to 512 threads, ``OUTS_PER_THREAD`` each) within ``SMEM_BUDGET`` (two
    blocks per SM), else the smallest such tile within ``SMEM_MAX``. Ties
    take the smaller shared memory. Returns ``dict(route='staged', tile,
    threads, smem, blocks)``. Where no tile fits (wide windows), the
    wide-window kernel's plan (:func:`_wide_plan`); raises ValueError
    when that fits no tile either. Cached per call signature: the search
    costs milliseconds of host time, more than a spatial launch."""
    dims = tuple(int(v) for v in shape[:3])
    nv = int(shape[3])
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    pairs = [d for d in itertools.product(*[range(-ri, ri + 1) for ri in r])
             if d > (0, 0, 0)] or [(0, 0, 0)]
    best = None
    for tile in itertools.product(_TILE_SIDES, _TILE_SIDES, _TILE_T):
        outs = tile[0] * tile[1] * tile[2]
        if not 128 <= outs <= 512 * OUTS_PER_THREAD:
            continue
        smem = tile_smem(tile, r, f, nv, itemsize)
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
    if best is None:
        return _wide_plan(tuple(shape), r, f, itemsize)
    _, tile, smem = best
    outs = tile[0] * tile[1] * tile[2]
    blocks = int(np.prod([-(-n // t) for n, t in zip(dims, tile)]))
    return dict(route='staged', tile=tile, threads=outs // OUTS_PER_THREAD,
                smem=smem, blocks=blocks)


def _launch(arr, r, f, sigma, h, n_eff, counter, plan=None):
    """One launch over a checked CUDA tensor; r and f are (r0, r1, r2) and
    (f0, f1, f2). The plan (``_tile_plan``'s unless given) picks the
    kernel; ``counter`` is the entry point's count of the tiled kernel."""
    ny, nx, nt, nv = arr.shape
    if plan is None:
        plan = _tile_plan(tuple(arr.shape), tuple(r), tuple(f),
                          arr.element_size())
    out = torch.empty_like(arr)
    with torch.cuda.device(arr.device):
        stream = torch.cuda.current_stream(arr.device).cuda_stream
        if plan['route'] == 'wide':
            pad = torch.empty(plan['padded'] + (nv,), dtype=arr.dtype,
                              device=arr.device)
            name = 'nd_nlmeans_wide_f32' if arr.dtype == torch.float32 \
                else 'nd_nlmeans_wide_f64'
            fn = _build.function(name, 'ppp' + 'i' * 16 + 'dddp')
            err = fn(arr.data_ptr(), pad.data_ptr(), out.data_ptr(), ny, nx,
                     nt, nv, *r, *f, *plan['tile'], plan['threads'],
                     int(plan['ring']), int(plan['fused']), float(sigma),
                     float(h), float(n_eff), stream)
            _build.bump(globals(), 'launches_wide')
        else:
            name = 'nd_nlmeans_f32' if arr.dtype == torch.float32 \
                else 'nd_nlmeans_f64'
            fn = _build.function(name, 'ppiiiiiiiiiiiiidddp')
            err = fn(arr.data_ptr(), out.data_ptr(), ny, nx, nt, nv,
                     *r, *f, *plan['tile'], float(sigma), float(h),
                     float(n_eff), stream)
            _build.bump(globals(), counter)
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
    return _launch(arr, (r[0], r[1], 0), (f[0], f[1], 0), sigma, h, n_eff,
                   'launches')


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
    return _launch(arr, r, f, sigma, h, n_eff, 'launches_3d')
