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
route of two kernels serves both entry points (the spatial one is the
r2 = f2 = 0 case) and keeps that body's arithmetic: each unordered
offset pair once, separable patch sums over t, then y, then x, its
forward then its backward term. On the H100 it is bound by instruction
issue. One block per output tile holds its reflect-mapped halo tile in
shared memory; each warp's lanes run along x, each thread owns a run of
outputs along y (and two t where the patch reaches along t), and every
offset pair is evaluated in registers: squared differences, the t and y
passes, the x pass by warp shuffles, the weights, both terms. The
'ring' route (``_ring_plan``): ``nlmeans_ring`` weighs each output's
two directions at the output, ``nlmeans_ring_pairs`` (spatial windows
of 4 float32 variables at f = 1 or 2, :func:`pair_build`) each pair
once and hands the backward weight to the lane dx to the right.
``_tile_plan`` picks the route and its tile from the shapes: windows
whose halo tile of every variable fits no block, or whose patch radius
passes ``RING_FMAX`` on y or t or ``RING_FXMAX`` on x, take the
wide-window kernel, which pads the cube once into a scratch buffer,
evaluates every offset of the window at its own outputs and keeps the
padded rows of one dy of offsets in a ring in shared memory
(``_wide_plan``). See the sources for the designs.

Dtypes: float32 and float64 run as they are; float16 and bfloat16 are
computed in float32 (the plain version does the same) and returned in
their own dtype. Each entry point runs the kernel for a CUDA tensor and
the plain version for a CPU tensor; for any other device, dtype or
layout it raises. Launches are counted per kernel and entry point:
``launches`` (spatial) and ``launches_3d`` count the ring route,
``launches_wide`` the wide-window kernel from either entry point. While
a trace records, every CUDA call adds its y x t outputs to the
``nlmeans.outputs`` counter of :mod:`nd_tpu_torch.tracing`, and a call
on the ring route to ``nlmeans.outputs_ring`` too.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from .. import _build
from ..tracing import count
from .conv_cuda import LOW_PRECISION, _in_float32
from .nlmeans import nlmeans_plain

__all__ = ['nlmeans_spatial', 'nlmeans_spatial_plain', 'nlmeans_3d',
           'nlmeans_3d_plain', 'launches', 'launches_3d']

launches = 0           # nlmeans_spatial: ring route launches
launches_3d = 0        # nlmeans_3d: ring route launches
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


SMEM_MAX = 232448           # shared memory a block may use on the H100
SMEM_BUDGET = 112 * 1024    # two blocks per SM
RING_LANES = 32             # a warp's lanes along x
RING_FMAX = 3               # kFMax in csrc/nlmeans.cu: fy and ft
RING_FXMAX = 8              # kFxMax: fx
RING_MAX_THREADS = 256      # kMaxThreads
PAIR_RMAX = 2               # kPairRMax: ry of the pair kernel's builds
_RING_WARPS = (1, 2, 4, 8)
_RING_PAIR_COST = 120       # the plan's weights: a pair at an output
_RING_LOAD_COST = 40        # against a halo position's copy
WIDE_MAX_E = 8              # kMaxE in csrc/nlmeans_wide.cu
WIDE_MAX_OUT = 2            # kMaxOut
WIDE_MAX_THREADS = 512
WIDE_FAST_TAPS = 7          # kFastTaps: patch widths the unrolled builds take
WIDE_RUN = 4                # kRun: a fused thread's run of t (y) outputs
WIDE_GROUP = 4              # kGroup: dt offsets a window of the fused build
_WIDE_SIDES = (1, 2, 4, 8, 16, 32)
_WIDE_T = (1, 2, 4, 8, 16)
_WIDE_BLOCK_COST = 2048     # a block's fixed cost per offset (syncs, loop)


def pair_build(shape, r, f, itemsize):
    """Whether the ring route runs the pair kernel (``pair_build`` in
    csrc/nlmeans.cu): spatial windows of 4 float32 variables with fy = fx
    in (1, 2), 1 <= ry <= ``PAIR_RMAX`` and rx + fx <= ``RING_FXMAX``;
    each pair's weight is then evaluated once for both directions."""
    return (itemsize == 4 and int(shape[3]) == 4 and r[2] == f[2] == 0
            and f[0] == f[1] and f[0] in (1, 2) and 1 <= r[0] <= PAIR_RMAX
            and r[1] + f[1] <= RING_FXMAX)


def ring_run(shape, r, f, itemsize):
    """``(R, C, tx)``: the outputs a thread of the ring route owns along y
    and along t, and a warp's outputs along x (the kernels' ``R``, ``C``
    and ``tx``): 4 x 2 where the patch reaches along t, else 8 x 1; the
    32 lanes less fx on each side (rx + fx for the pair kernel)."""
    R, C = (4, 2) if f[2] > 0 else (8, 1)
    lx = r[1] + f[1] if pair_build(shape, r, f, itemsize) else f[1]
    return R, C, RING_LANES - 2 * lx


def ring_smem(tile, r, f, nv, itemsize):
    """Shared-memory bytes of a block of the ring route (``recs`` in
    csrc/nlmeans.cu's ``launch``): the halo tile of all ``nv`` variables,
    ty + 2(ry+fy) rows, the 32 lanes and rx on each side along x, and
    tt + 2(rt+ft) along t."""
    ty, _, tt = tile
    return nv * itemsize * (ty + 2 * (r[0] + f[0])) \
        * (RING_LANES + 2 * r[1]) * (tt + 2 * (r[2] + f[2]))


def _ring_plan(shape, r, f, itemsize):
    """The ring route's plan, or None where it takes no tile: a patch
    radius past ``RING_FMAX`` on y or t or ``RING_FXMAX`` on x, or a
    halo tile that fits no block. Among blocks of 1 to 8 runs of warps
    along y and t (``RING_MAX_THREADS``) within ``SMEM_MAX``, those
    within ``SMEM_BUDGET`` (two blocks per SM) first, then the least
    work: every pair at each output the tiles cover (ragged arrays
    included) and each block's halo load; ties take the smaller shared
    memory. Returns ``dict(route='ring', pairs, tile, threads, smem,
    blocks)``: ``pairs`` for the pair kernel (:func:`pair_build`), ty a
    multiple of R, tt of C and tx as :func:`ring_run` gives them, one
    warp per run of a lane's outputs."""
    if f[0] > RING_FMAX or f[2] > RING_FMAX or f[1] > RING_FXMAX:
        return None
    dims = tuple(int(v) for v in shape[:3])
    nv = int(shape[3])
    R, C, tx = ring_run(shape, r, f, itemsize)
    pairs = max((np.prod([2 * ri + 1 for ri in r]) - 1) // 2, 1)
    best = None
    for wy, wt in itertools.product(_RING_WARPS, _RING_WARPS):
        if RING_LANES * wy * wt > RING_MAX_THREADS:
            continue
        tile = (R * wy, tx, C * wt)
        smem = ring_smem(tile, r, f, nv, itemsize)
        if smem > SMEM_MAX:
            continue
        blocks = np.prod([-(-n // t) for n, t in zip(dims, tile)])
        cost = blocks * (np.prod(tile) * pairs * _RING_PAIR_COST
                         + smem // (nv * itemsize) * _RING_LOAD_COST)
        key = (smem > SMEM_BUDGET, cost, smem)
        if best is None or key < best[0]:
            best = (key, tile)
    if best is None:
        return None
    _, tile = best
    return dict(route='ring', pairs=pair_build(shape, r, f, itemsize),
                tile=tile,
                threads=RING_LANES * (tile[0] // R) * (tile[2] // C),
                smem=ring_smem(tile, r, f, nv, itemsize),
                blocks=int(np.prod([-(-n // t) for n, t in zip(dims, tile)])))


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
    """The kernel and its block, chosen from the shapes: the ring kernel
    where it takes the shape (:func:`_ring_plan`: ``dict(route='ring',
    tile, threads, smem, blocks)``), else the wide-window kernel's plan
    (:func:`_wide_plan`); raises ValueError when that fits no tile
    either. Cached per call signature: the search costs a millisecond of
    host time, more than a spatial launch."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    plan = _ring_plan(tuple(shape), r, f, itemsize)
    if plan is None:
        return _wide_plan(tuple(shape), r, f, itemsize)
    return plan


def _launch(arr, r, f, sigma, h, n_eff, counter, plan=None):
    """One launch over a checked CUDA tensor; r and f are (r0, r1, r2) and
    (f0, f1, f2). The plan (``_tile_plan``'s unless given) picks the
    kernel; ``counter`` is the entry point's count of the ring route."""
    ny, nx, nt, nv = arr.shape
    if plan is None:
        plan = _tile_plan(tuple(arr.shape), tuple(r), tuple(f),
                          arr.element_size())
    out = torch.empty_like(arr)
    count('nlmeans.outputs', ny * nx * nt)
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
            count('nlmeans.outputs_ring', ny * nx * nt)
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
