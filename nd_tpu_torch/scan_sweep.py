"""The forced-plan sweeps behind ``ops.change_scan_cuda._scan_plan`` and
``ops.change_cuda._round_plan``, and the sepconv kernel's tap routes.

    python -m nd_tpu_torch.scan_sweep [scan|round|taps|library|stencil|routes]
                                          # default: scan, round, taps

scan: runs the long-series scan kernel with every plan of
``change_scan_cuda.plan_candidates`` on ``chip_smoke.py``'s long stack
(1024 x 1024 x 56) and path-B stack (256 x 512 x 200), and on 256 x 512
stacks at k = 16, 100 and 256 (the same generator).

round: runs the round kernel (``csrc/omnibus.cu``) with every plan of
``change_cuda.round_plan_candidates`` (resident, streamed chunks) on
``chip_smoke.py``'s bench cube (1024 x 1024 x 12, the exact mode's
capped pass with margins, and uncapped without margins, as
``stat_dtype='float32'`` runs it), on the long stack at k = 56 with 14
rounds, and on 256 x 512 stacks at k = 16, 20, 24, 28, 32, 40, 48 and
100 (capped, margins): the lengths around ``change_cuda.RESIDENT_K``,
where the chosen plan turns from resident to streamed.

taps: times the sepconv rows of ``chip_smoke.py`` (the multilook and
stacked two-axis rows of the bench cube and of the long stack, the
three-axis Gaussian and boxcar of path C) with their short tap vectors
passed by value (the default) and forced onto the long-tap route
(``conv_cuda.INLINE_TAPS`` set to 0: device buffers copied into each
block's shared memory), alternating the two four times; the two outputs
must be bit-equal.

library: the library yardstick of the long-tap route (``chip_smoke.py``
phase 15, ``GaussianFilter(dims=('y', 'x', 'time'), sigma=16)``, 129
taps per axis, on the long stack's C11): cuDNN's conv3d (TF32 off) of
the tensor padded as the kernel pads it with the full 129 x 129 x 129
kernel (one call; the port never calls it), and the three one-axis
conv3d passes; each output within n * 2**-24 * max|x| of the kernel's
(float32 sums of n terms, weights summing to 1). One call each, CUDA events, the first cold and a
second where the first took under two minutes. Too slow for
``chip_smoke.py``'s time limit.

stencil (not in the default set): times the stencil kernel
(``csrc/stencil.cu``) at ``chip_smoke.py`` S1's shapes, the 5 x 5 disk
over the stacked views that ``ConvolutionFilter`` launches for the four
variables (4 x 1024 x 1024 x 11, x 12, x 3) and over the bench cube's
(1, y, x, 48) view, the 27-point Laplacian over (y, x, time) of the long
stack's C11, and over the 11-wide stacked view the 3 x 3 and 7 x 7 disks
and a random 4 x 3 x 2 kernel (its last axis over time); each output
must equal ``stencil_plain``'s. Per row: four medians of 5 single calls
(CUDA events around one call, the wrapper's host work included), the
device time a launch over 50 back-to-back calls, and the kernel's device
time under ``torch.profiler``; then the back-to-back time at each run
length (``stencil_cuda.RUN`` 8, 16) and, for a window with an
unrolled build, the unrolled and the generic build in turns (unrolled,
generic, generic, unrolled; ``stencil_cuda.UNROLLED``). A tree without
those knobs (an older checkout) prints the first line only. Run it from
two checkouts in one call to compare two versions of the kernel.

routes (not in the default set): the two wide-window rows of
``chip_smoke.py``, phases 15 and 16, on its long stack: each of the
three one-axis passes of ``GaussianFilter(dims=('y', 'x', 'time'),
sigma=16)`` (129 taps; the (1, outer, n, inner) views of ``ops/conv.py``
over C11, each pass fed the previous one's output) through ``sepconv2``
and, where the tree has it, through ``sepconv2_tiled`` (the tiled
kernel's long-tap route), each bit-equal to ``sepconv2_plain``; and
``nlmeans_3d`` at r = (10, 10, 3), f = 3 on the 128 x 128 x 56 x 4
slab, within rtol 1e-5, atol 1e-6 of ``nlmeans_3d_plain``, then at five
forced tiles, fused and unfused where the build takes them. Medians of 7
(NLMeans: 3) CUDA-event timings of one call after a warm-up, in turns
(sepconv2, tiled, tiled, sepconv2), the launch counters each call
moved, and the nvcc lines of the two wide-window sources. Route-blind:
copied into an older checkout it times that tree's routes, so two
checkouts in one call compare the parent's routes with the change's.

Each plan's flags and margins must be bit-equal to the plain version's
(a failure raises); its time is the median of 5 CUDA-event timings of
one kernel call after one warm-up. Prints one line per shape and plan,
fastest first, with the plan's shared memory and blocks per SM, then
the chosen plan's time and rank. Every line ends with the card's name
and power limit. Without a CUDA device it exits non-zero.
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .ops import change_cuda as rnd
from .ops import change_scan_cuda as scan


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _report(label, rows, chosen, key, smem_limit, card):
    rows.sort(key=lambda r: r[0])
    for ms, plan in rows:
        print('%s %s smem %6d (%d blocks/SM by smem): %.4f ms | %s'
              % (label, ' '.join('%s %s' % (k, plan[k]) for k in key),
                 plan['smem'],
                 min(smem_limit // max(plan['smem'], 1),
                     2048 // plan['threads']), ms, card), flush=True)
    keys = [tuple(p[k] for k in key) for _, p in rows]
    rank = keys.index(tuple(chosen[k] for k in key))
    print('%s chosen plan %r: %.4f ms, rank %d of %d (best %.4f ms) | %s'
          % (label, keys[rank], rows[rank][0], rank + 1, len(rows),
             rows[0][0], card), flush=True)


def _round_sweep(cs, card, dev):
    shapes = [(cs.NY, cs.NX, cs.K, cs.SEED, True),
              (cs.NY, cs.NX, cs.K, cs.SEED, False),
              (cs.NY, cs.NX, cs.KL, cs.SEED + 3, True),
              (256, 512, 16, 4, True), (256, 512, 20, 5, True),
              (256, 512, 24, 6, True), (256, 512, 28, 10, True),
              (256, 512, 32, 11, True), (256, 512, 40, 7, True),
              (256, 512, 48, 8, True), (256, 512, 100, 9, True)]
    for ny, nx, k, seed, margins in shapes:
        vals = torch.from_numpy(cs.make_cube(
            ny, nx, k, seed=seed, step=2.5 if k == cs.K else 5.0,
            burst=k != cs.K)).to(dev)
        rounds = rnd._round_cap(k) if margins else k - 1
        ref = rnd.omnibus_plain(vals, *rnd.omnibus_tables(k, 9, 0.99), 9.0,
                                rounds, margins)

        def call(plan):
            return rnd.change_detection_fast(
                vals, 0.99, n=9, return_margin=margins, return_packed=True,
                max_rounds=rounds, plan=plan)
        rows = []
        for plan in rnd.round_plan_candidates(k, ny * nx):
            got = call(plan)
            torch.cuda.synchronize()
            gp, gm = got if margins else (got, None)
            same = bool((gp == ref[0]).all()) and (not margins or bool(
                (gm.view(torch.int32) == ref[1].view(torch.int32)).all()))
            if not same:
                raise RuntimeError('round plan %r at k=%d differs from the '
                                   'plain version' % (plan, k))
            rows.append((_ms(lambda: call(plan)), plan))
        _report('round %dx%dx%d %s' % (ny, nx, k, 'capped+margins' if margins
                                       else 'flags'), rows,
                rnd._round_plan(k, ny * nx), ('threads', 'T', 'nbuf'),
                rnd.SMEM_MAX - rnd.STATIC_SMEM, card)
        del vals, ref


def _taps_sweep(cs, card, dev):
    import numpy as np
    from .ops import conv_cuda
    from .ops.conv import _separable_factors, gaussian_kernel1d
    cube = torch.from_numpy(cs.make_cube(cs.NY, cs.NX, cs.K)).to(dev)
    stack = torch.from_numpy(cs.make_cube(cs.NY, cs.NX, cs.KL,
                                          seed=cs.SEED + 3, step=5.0,
                                          burst=True)).to(dev)
    ml = _separable_factors(np.flip(np.ones((3, 3), np.float32) / 9))
    box = _separable_factors(np.ones((3, 3)) / 9)
    c11v = stack[..., 0].contiguous().reshape(cs.NY, cs.NX, cs.KL, 1)
    rows = [
        ('multilook (1,y,x,48)', conv_cuda.sepconv2,
         cube.reshape(1, cs.NY, cs.NX, cs.K * 4), ml),
        ('stacked (4,y,x,12)', conv_cuda.sepconv2,
         cube.permute(3, 0, 1, 2).contiguous(), box),
        ('path A multilook (4,y,x,56)', conv_cuda.sepconv2,
         stack.permute(3, 0, 1, 2).contiguous(), box),
        ('Gaussian sigma 1 (y,x,56,1)', conv_cuda.sepconv3, c11v,
         (gaussian_kernel1d(1.0),) * 3),
        ('boxcar w 3 (y,x,56,1)', conv_cuda.sepconv3, c11v,
         tuple(_separable_factors(np.ones((3, 3, 3)) / 27)))]
    inline = conv_cuda.INLINE_TAPS
    for label, fn, x, taps in rows:
        def by_value():
            return fn(x, *taps)

        def forced():
            conv_cuda.INLINE_TAPS = 0
            try:
                return fn(x, *taps)
            finally:
                conv_cuda.INLINE_TAPS = inline
        if not bool((by_value() == forced()).all()):
            raise RuntimeError('sepconv %s: the long-tap route differs from '
                               'the inline taps' % label)
        ms = {'by value': [], 'forced long-tap route': []}
        for _ in range(4):
            ms['by value'].append(_ms(by_value))
            ms['forced long-tap route'].append(_ms(forced))
        for route, times in ms.items():
            print('taps %s %s: %s ms (median %.4f) | %s'
                  % (label, route, ' '.join('%.4f' % t for t in times),
                     statistics.median(times), card), flush=True)


def back_to_back_ms(fn, n=50, reps=5):
    """ms a call of n back-to-back calls between one event pair (median of
    reps after one warm-up run): the device time of a launch, the
    wrapper's host work hidden behind the previous launch."""
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def profiler_ms(fn, name, n=20):
    """The mean device time of the kernels whose name holds ``name`` under
    torch.profiler over n calls (after one warm-up call), over the events
    it caught: a process's earlier profiler windows can leave a later one
    without some events (chip_smoke.py phase 17)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    if not spans:
        raise RuntimeError('torch.profiler caught no %r kernel' % name)
    return sum(spans) / 1e3 / len(spans)


def _disk(r):
    """The flipped (2r+1, 2r+1, 1) disk of radius**2 <= r*r + 1 (r = 2:
    chip_smoke.DISK), zero taps included."""
    import numpy as np
    ax = np.arange(-r, r + 1)
    d = (ax[:, None] ** 2 + ax[None, :] ** 2 <= r * r + 1).astype(float)
    return (d / d.sum())[:, :, None]


def _stencil_sweep(cs, card, dev):
    import numpy as np
    from .ops import stencil_cuda
    cube = torch.from_numpy(cs.make_cube(cs.NY, cs.NX, cs.K)).to(dev)
    stack = torch.from_numpy(cs.make_cube(cs.NY, cs.NX, cs.KL,
                                          seed=cs.SEED + 3, step=5.0,
                                          burst=True)).to(dev)
    disk = np.flip(cs.DISK)[:, :, None]

    def stacked(c, k):
        return c[:, :, :k].permute(3, 0, 1, 2).contiguous().reshape(
            4, cs.NY, cs.NX, 1, k)
    comp = stacked(stack, 11)
    rows = [('disk stacked (4,y,x,1,11)', comp, disk),
            ('disk stacked (4,y,x,1,12)', stacked(cube, cs.K), disk),
            ('disk stacked (4,y,x,1,3)', stacked(cube, cs.K // 4), disk),
            ('disk bench (1,y,x,1,48)',
             cube.reshape(1, cs.NY, cs.NX, 1, cs.K * 4), disk),
            ('Laplace27 C11 (1,y,x,56,1)',
             stack[..., 0].contiguous().reshape(1, cs.NY, cs.NX, cs.KL, 1),
             np.flip(cs.LAPLACE27)),
            ('disk3 stacked (4,y,x,1,11)', comp, _disk(1)),
            ('disk7 stacked (4,y,x,1,11)', comp, _disk(3)),
            ('random 4x3x2 stacked (4,y,x,11,1)',
             comp.reshape(4, cs.NY, cs.NX, 11, 1),
             np.random.RandomState(cs.SEED + 14).rand(4, 3, 2) - 0.3)]
    knobs = hasattr(stencil_cuda, 'UNROLLED')    # a tree before the knobs
    for label, x, k in rows:
        def call():
            return stencil_cuda.stencil(x, k)
        ref = stencil_cuda.stencil_plain(x, k)
        if not torch.equal(call(), ref):
            raise RuntimeError('stencil %s differs from its plain version'
                               % label)
        if knobs:
            route = stencil_cuda.stencil_route(*x.shape[1:], *k.shape,
                                               x.element_size())
        else:
            route = 'tiled' if stencil_cuda.stencil_tiled(
                *x.shape[1:], *k.shape, x.element_size()) else 'direct'
        times = [_ms(call) for _ in range(4)]
        print('stencil %s k %s (%s): single call %s ms (median %.4f); '
              'back-to-back %.4f ms a launch; profiler device %.4f ms a '
              'launch | %s'
              % (label, 'x'.join(map(str, k.shape)), route,
                 ' '.join('%.4f' % t for t in times),
                 statistics.median(times), back_to_back_ms(call),
                 profiler_ms(call, 'stencil'), card), flush=True)
        if not knobs:
            continue
        runs = {}
        try:
            for run in (8, 16):
                stencil_cuda.RUN = run
                if not torch.equal(call(), ref):
                    raise RuntimeError('stencil %s run %d differs from its '
                                       'plain version' % (label, run))
                runs[run] = back_to_back_ms(call)
        finally:
            stencil_cuda.RUN = 0
        print('stencil %s runs (back-to-back ms a launch): %s | %s'
              % (label, ', '.join('R=%d %.4f' % kv for kv in runs.items()),
                 card), flush=True)
        if route != 'unrolled':
            continue
        ab = {True: [], False: []}
        try:
            for unrolled in (True, False, False, True):
                stencil_cuda.UNROLLED = unrolled
                if not torch.equal(call(), ref):
                    raise RuntimeError('stencil %s unrolled=%s differs '
                                       'from its plain version'
                                       % (label, unrolled))
                ab[unrolled].append(back_to_back_ms(call))
        finally:
            stencil_cuda.UNROLLED = True
        print('stencil %s unrolled %s | generic %s ms a launch '
              '(back-to-back, in turns): generic / unrolled x%.3f | %s'
              % (label, ' '.join('%.4f' % t for t in ab[True]),
                 ' '.join('%.4f' % t for t in ab[False]),
                 min(ab[False]) / min(ab[True]), card), flush=True)
        del ref


def _library_sweep(cs, card, dev):
    import numpy as np
    import torch.nn.functional as F
    from .ops import conv_cuda
    from .ops.conv import gaussian_kernel1d, pad_reflect
    stack = torch.from_numpy(cs.make_cube(cs.NY, cs.NX, cs.KL,
                                          seed=cs.SEED + 3, step=5.0,
                                          burst=True)).to(dev)
    c11 = stack[..., 0].contiguous()
    del stack
    g = np.flip(gaussian_kernel1d(16.0))                    # 129 taps
    lo, hi = (len(g) - 1) // 2, len(g) // 2
    ref = c11.reshape(cs.NY, cs.NX, cs.KL, 1)
    for ax in range(3):        # the route's three one-axis passes
        shape = ref.shape
        view = (1, int(np.prod(shape[:ax])), shape[ax],
                int(np.prod(shape[ax + 1:])))
        ref = conv_cuda.sepconv2(ref.contiguous().reshape(view), np.ones(1),
                                 g).reshape(shape)
    ref = ref[..., 0]
    xin = pad_reflect(c11, [(lo, hi)] * 3)[None, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        def once(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end)

        w1 = torch.tensor(np.ascontiguousarray(g), dtype=torch.float32,
                          device=dev)
        passes = [w1.reshape(1, 1, -1, 1, 1), w1.reshape(1, 1, 1, -1, 1),
                  w1.reshape(1, 1, 1, 1, -1)]

        def separable():
            out = xin
            for w in passes:
                out = F.conv3d(out, w)
            return out

        full_w = torch.einsum('i,j,k->ijk', w1, w1, w1)[None, None]
        # float32 sums of n terms (weights summing to 1) may round apart
        # by up to n * 2**-24 * max|x|: 1e-5 for the 129-term passes, 0.13
        # max|x| for the 2.1 M-term single call
        top = float(c11.abs().max())
        for label, fn, terms in (
                ('three one-axis conv3d passes', separable, 3 * len(g)),
                ('one conv3d, 129x129x129 kernel',
                 lambda: F.conv3d(xin, full_w), len(g) ** 3)):
            out, ms = once(fn)
            diff = float((out[0, 0] - ref).abs().max())
            if diff > max(1e-5, terms * 2.0 ** -24 * top):
                raise RuntimeError('%s differs from the kernel by %g'
                                   % (label, diff))
            times = [ms]
            if ms < 120e3:
                times.append(once(fn)[1])
            print('library %s on %s float32: %s ms (cold first); max abs '
                  'diff %.3g to the long-tap route | %s'
                  % (label, tuple(c11.shape),
                     ' '.join('%.3f' % t for t in times), diff, card),
                  flush=True)
            del out
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _routes(cs, card, dev):
    import numpy as np
    from . import _build
    from .ops import conv_cuda, nlmeans_cuda
    from .ops.conv import gaussian_kernel1d
    info = _build.build_info()
    keep = False
    for ln in info['log'].splitlines():
        if 'Compiling entry function' in ln:
            keep = 'nlmeans_wide' in ln or 'sepconv_long' in ln
        if keep and ('Compiling' in ln or 'registers' in ln or 'spill' in ln
                     or 'stack frame' in ln):
            print('routes ptxas: ' + ln.strip())
    print('routes: kernels built=%s in %.1f s from %s'
          % (info['built'], info['seconds'], ', '.join(info['sources'])),
          flush=True)
    stack = torch.from_numpy(cs.make_cube(cs.NY, cs.NX, cs.KL,
                                          seed=cs.SEED + 3, step=5.0,
                                          burst=True)).to(dev)

    def moved(fn, mod):
        before = {k: v for k, v in vars(mod).items()
                  if k.startswith('launches') and isinstance(v, int)}
        fn()
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in vars(mod).items()
                if k in before and v != before[k]}

    g16 = np.flip(gaussian_kernel1d(16.0))
    tiled = getattr(conv_cuda, 'sepconv2_tiled', None)
    x = stack[..., 0].contiguous()
    for ax, name in enumerate(('y', 'x', 'time')):
        shape = x.shape
        view = x.reshape(1, int(np.prod(shape[:ax])), shape[ax],
                         int(np.prod(shape[ax + 1:])))
        ref = conv_cuda.sepconv2_plain(view, np.ones(1), g16)
        calls = {'sepconv2': lambda: conv_cuda.sepconv2(view, np.ones(1),
                                                        g16)}
        if tiled is not None:
            calls['sepconv2_tiled'] = lambda: tiled(view, np.ones(1), g16)
        for label, fn in calls.items():
            diff = float((fn() - ref).abs().max())
            if diff != 0:
                raise RuntimeError('routes: %s pass %s differs from the plain '
                                   'version by %g' % (label, name, diff))
        ms = {label: [] for label in calls}
        order = list(calls) + list(reversed(list(calls)))
        for label in order:
            ms[label].append(_ms(calls[label], reps=7))
        for label in calls:
            print('routes GaussianFilter sigma=16 pass %s %s %s: %s ms (min '
                  '%.4f); launches %s; max abs diff 0 to the plain pass | %s'
                  % (name, tuple(view.shape), label,
                     ' '.join('%.4f' % t for t in ms[label]),
                     min(ms[label]), moved(calls[label], conv_cuda), card),
                  flush=True)
        x = ref.reshape(shape)
        del ref
    rw, fw = (10, 10, 3), (3, 3, 3)
    slab = stack[:128, :128].contiguous()

    def wide():
        return nlmeans_cuda.nlmeans_3d(slab, rw, fw, 2.0, 3.0)
    ref = nlmeans_cuda.nlmeans_3d_plain(slab, rw, fw, 2.0, 3.0)
    got = wide()
    excess = float(((got - ref).abs() - (1e-6 + 1e-5 * ref.abs())).max())
    if not (bool(torch.isfinite(got).all()) and excess <= 0):
        raise RuntimeError('routes: nlmeans_3d wide exceeds rtol 1e-5, atol '
                           '1e-6 of the plain version by %g' % excess)
    print('routes nlmeans_3d r=%r f=%r on %s: %s ms; plan %s; launches %s; '
          'max abs diff %.3g, max |diff| / (1e-6 + 1e-5 |ref|) %.3f | %s'
          % (rw, fw, tuple(slab.shape),
             ' '.join('%.3f' % _ms(wide, reps=3) for _ in range(2)),
             nlmeans_cuda._tile_plan(tuple(slab.shape), rw, fw, 4),
             moved(wide, nlmeans_cuda), float((got - ref).abs().max()),
             float(((got - ref).abs() / (1e-6 + 1e-5 * ref.abs())).max()),
             card), flush=True)
    # the wide-window kernel at other tiles and builds (where the tree has
    # them): fewer threads a block against the same work
    plan_of = getattr(nlmeans_cuda, 'wide_plan_of', None)
    for tile in ((8, 8, 8), (8, 16, 4), (4, 16, 8), (4, 8, 8), (8, 8, 4)):
        for fused in (True, False):
            if plan_of is None:
                break
            plan = plan_of(tuple(slab.shape), rw, fw, 4, tile, True, fused)
            region = np.prod([t + 2 * fi for t, fi in zip(tile, fw)])
            if plan['smem'] > nlmeans_cuda.SMEM_MAX or (
                    fused and not nlmeans_cuda.wide_fused(tile, fw, 4, 4,
                                                          True)) or (
                    not fused and region > nlmeans_cuda.WIDE_MAX_E
                    * plan['threads']):
                continue

            def forced(plan=plan):
                return nlmeans_cuda._launch(slab, rw, fw, 2.0, 3.0, -1.0,
                                            'launches_3d', plan)
            diff = float(((forced() - ref).abs()
                          - (1e-6 + 1e-5 * ref.abs())).max())
            if diff > 0:
                raise RuntimeError('routes: forced plan %r exceeds the '
                                   'tolerance by %g' % (plan, diff))
            print('routes nlmeans_3d wide tile %r %s: %d threads, %d bytes '
                  'of shared memory: %.3f ms | %s'
                  % (tile, 'fused' if fused else 'unfused', plan['threads'],
                     plan['smem'], _ms(forced, reps=3), card), flush=True)


def main():
    if not torch.cuda.is_available():
        print('scan_sweep: needs a CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    which = sys.argv[1:] or ['scan', 'round', 'taps']
    if 'round' in which:
        _round_sweep(cs, card, dev)
    if 'taps' in which:
        _taps_sweep(cs, card, dev)
    if 'library' in which:
        _library_sweep(cs, card, dev)
    if 'stencil' in which:
        _stencil_sweep(cs, card, dev)
    if 'routes' in which:
        _routes(cs, card, dev)
    if 'scan' not in which:
        return 0
    shapes = [(cs.NY, cs.NX, cs.KL, cs.SEED + 3), (cs.BNY, cs.BNX, cs.BK,
                                                   cs.SEED + 2),
              (256, 512, 16, 7), (256, 512, 100, 8), (256, 512, 256, 9)]
    for ny, nx, k, seed in shapes:
        vals = torch.from_numpy(cs.make_cube(ny, nx, k, seed=seed,
                                             step=5.0, burst=True)).to(dev)
        tabs = scan.scan_tables(k, 9, 0.99)
        ref_p, ref_m = scan.scan_plain(vals, tabs, 9.0)
        chosen = scan._scan_plan(k, ny * nx)
        rows = []
        for plan in scan.plan_candidates(k, ny * nx):
            got_p, got_m = scan.scan_kernel(vals, tabs, 9.0, plan)
            torch.cuda.synchronize()
            same = bool((got_p == ref_p).all()) and bool(
                (got_m.view(torch.int32) == ref_m.view(torch.int32)).all())
            if not same:
                raise RuntimeError('plan %r at k=%d differs from the plain '
                                   'version' % (plan, k))
            rows.append((_ms(lambda: scan.scan_kernel(vals, tabs, 9.0, plan)),
                         plan))
        _report('scan %dx%dx%d' % (ny, nx, k), rows, chosen,
                ('threads', 'T', 'nbuf'), scan.SMEM_MAX, card)
        del vals, ref_p, ref_m
    return 0


if __name__ == '__main__':
    sys.exit(main())
