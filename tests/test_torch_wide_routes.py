"""The host plans of the two wide-window kernels, on the CPU: the
wide-window NLMeans kernel (``csrc/nlmeans_wide.cu``, ``_wide_plan``)
and the long-tap one-axis kernel (``csrc/sepconv_long.cu``,
``_long_plan``).

No CUDA kernel runs here. Each kernel's index arithmetic is replayed in
numpy, loop for loop, on small cubes: which padded row each ring slot
holds when a dy of offsets reads it, the region, pass and output
indices, the long-tap kernel's register runs, row blocks, line windows
and index table. The replays must give the plain versions' results:
NLMeans within rtol 1e-12, atol 1e-13 in float64 (the kernel adds the
offsets in another order than the plain version's pairs), the long-tap
passes bit for bit in float32 (the same operations in the same order).
"""

import itertools

import numpy as np
import pytest
import torch

from nd_tpu_torch.ops import conv_cuda, nlmeans_cuda
from nd_tpu_torch.ops.conv import _edge_src, gaussian_kernel1d, pad_reflect
from nd_tpu_torch.ops.nlmeans import nlmeans_plain

MODES = ['reflect', 'mirror', 'nearest', 'constant', 'wrap']

# the card tests' WIDE shapes (tests/test_torch_cuda.py) and the chip
# smoke's phase-16 slab
WIDE = [((24, 26, 9, 4), (10, 10, 3), (3, 3, 3), 4),
        ((12, 13, 12, 4), (5, 5, 5), (2, 2, 2), 8),
        ((12, 13, 12, 8), (5, 5, 5), (2, 2, 2), 4),
        ((13, 14, 10, 4), (4, 4, 4), (3, 3, 3), 8),
        ((23, 27, 11, 4), (10, 10, 3), (3, 3, 3), 4),
        ((22, 25, 6, 4), (10, 10, 2), (3, 3, 3), 4),
        ((128, 128, 56, 4), (10, 10, 3), (3, 3, 3), 4)]


def _reflect_src(j, n):
    """csrc/nlmeans_wide.cu reflect_src."""
    j = np.abs(j)
    j = np.where(j >= n, 2 * n - 2 - j, j)
    return np.clip(j, 0, n - 1)


@pytest.mark.parametrize('shape,r,f,itemsize', WIDE)
def test_wide_plan_covers_every_output_once_and_fits(shape, r, f, itemsize):
    plan = nlmeans_cuda._tile_plan(shape, r, f, itemsize)
    assert plan['route'] == 'wide' and plan['ring']
    ny, nx, nt, nv = shape
    ty, tx, tt = plan['tile']
    # the kernel's block order: t fastest, then x, then y
    nbt, nbx = -(-nt // tt), -(-nx // tx)
    count = np.zeros((ny, nx, nt), np.int64)
    for b in range(plan['blocks']):
        y0, x0, t0 = (b // nbt // nbx) * ty, (b // nbt % nbx) * tx, \
            (b % nbt) * tt
        count[y0:y0 + ty, x0:x0 + tx, t0:t0 + tt] += 1
    assert (count == 1).all()
    # shared memory as csrc/nlmeans_wide.cu wide_elems counts it
    ey, ex, et = ty + 2 * f[0], tx + 2 * f[1], tt + 2 * f[2]
    sx, st = tx + 2 * (r[1] + f[1]), tt + 2 * (r[2] + f[2])
    sts = st if st % 2 else st + 1          # the ring's odd x stride
    row = sx * sts + (9 - sx * sts % 8) % 8  # a row's positions, 1 mod 8
    assert row % 8 == 1 and 0 <= row - sx * sts < 8
    planes = 4 * (ey * ex * (tt | 1) + 2 * ty * ex * tt) if plan['fused'] \
        else ey * ex * et + ey * ex * tt + ty * ex * tt
    elems = (ey + 1) * row * nv + planes + (
        0 if nv == 4 else (ey * ex * et + ty * tx * tt) * nv)
    assert plan['smem'] == elems * itemsize <= nlmeans_cuda.SMEM_MAX
    # the register arrays: 2 outputs a thread; the fused build (float32,
    # nv = 4, f <= 3) a run of 4 t outputs of a region column, the
    # others 8 region positions a thread
    threads = plan['threads']
    assert threads % 32 == 0 and 32 <= threads <= 512
    assert ty * tx * tt <= 2 * threads
    assert plan['fused'] == (itemsize == 4 and nv == 4 and max(f) <= 3)
    if plan['fused']:
        # a warp holds whole units (an x column's t run, its ey rows)
        assert ey <= 32 and 32 * -(-(ex * -(-tt // 4)) // (32 // ey)) \
            <= threads
    else:
        assert ey * ex * et <= 8 * threads
    assert threads == nlmeans_cuda.wide_threads(plan['tile'], f,
                                                plan['fused'])
    # the padded cube: whole tiles plus r + f on each side
    assert plan['padded'] == tuple(-(-n // t) * t + 2 * (ri + fi) for
                                   n, t, ri, fi in zip(shape, plan['tile'],
                                                       r, f))


@pytest.mark.parametrize('shape,r,f,itemsize', WIDE)
def test_wide_ring_holds_every_row_each_offset_reads(shape, r, f, itemsize):
    plan = nlmeans_cuda._tile_plan(shape, r, f, itemsize)
    ty, tx, tt = plan['tile']
    ry, rx, rt = r
    fy, fx, ft = f
    ey, ex, et = ty + 2 * fy, tx + 2 * fx, tt + 2 * ft
    sx, st = tx + 2 * (rx + fx), tt + 2 * (rt + ft)
    rs = ey + 1
    held = {L % rs: L for L in range(ey)}
    for a in range(2 * ry + 1):
        arriving = None
        if a < 2 * ry:                    # in flight during this dy
            arriving = (a + ey) % rs
            assert held.get(arriving, -1) < a    # its old row is done
        for i in range(ey):                # region rows and output rows
            slot = (a + i) % rs
            assert slot != arriving and held[slot] == a + i
        if arriving is not None:
            held[arriving] = a + ey
    # x and t: region position +- the window stays inside the slab
    assert rx + (ex - 1) + rx == sx - 1 and rt + (et - 1) + rt == st - 1
    # the padded rows the block's ring loads stay in the padded cube
    assert (-(-shape[0] // ty) - 1) * ty + ey + 2 * ry <= plan['padded'][0]


def _emulate_wide(arr, r, f, sigma, h, n_eff, plan):
    """csrc/nlmeans_wide.cu in numpy: the pad kernel, then per block the
    ring (or the padded cube), the region, the t, y and x passes through
    the kernel's flat indices, and the offsets in row-major order. Every
    partner read is checked against the reflect-mapped cube."""
    ny, nx, nt, nv = arr.shape
    ry, rx, rt = r
    fy, fx, ft = f
    ty, tx, tt = plan['tile']
    Py, Px, Pt = ry + fy, rx + fx, rt + ft
    NY, NX, NT = plan['padded']
    pad = arr[_reflect_src(np.arange(NY) - Py, ny)][
        :, _reflect_src(np.arange(NX) - Px, nx)][
        :, :, _reflect_src(np.arange(NT) - Pt, nt)]
    ey, ex, et = ty + 2 * fy, tx + 2 * fx, tt + 2 * ft
    sx, st = tx + 2 * Px, tt + 2 * Pt
    rs = ey + 1
    nr, nout = ey * ex * et, ty * tx * tt
    ntp, nyp = ey * ex * tt, ty * ex * tt
    dsq_norm = float(nv * (2 * fy + 1) * (2 * fx + 1) * (2 * ft + 1))
    e = np.arange(nr)
    ek, ej, ei = e % et, (e // et) % ex, e // (et * ex)
    q = np.arange(ntp)
    tsrc = q + (q // tt) * 2 * ft
    o = np.arange(nout)
    ot, ox, oy = o % tt, (o // tt) % tx, o // (tt * tx)
    out = np.empty_like(arr)
    nbt, nbx = -(-nt // tt), -(-nx // tx)
    for b in range(plan['blocks']):
        t0, x0, y0 = (b % nbt) * tt, (b // nbt % nbx) * tx, \
            (b // nbt // nbx) * ty
        ring = np.full((rs, sx, st, nv), np.nan)
        held = np.full(rs, -1)

        def load(L):
            ring[L % rs] = pad[y0 + L, x0:x0 + sx, t0:t0 + st]
            held[L % rs] = L

        def partner(L, lx, lt):
            assert (lx >= 0).all() and (lx < sx).all() \
                and (lt >= 0).all() and (lt < st).all()
            if plan['ring']:
                assert (held[L % rs] == L).all()
                got = ring[L % rs, lx, lt]
            else:
                got = pad[y0 + L, x0 + lx, t0 + lt]
            want = arr[_reflect_src(y0 + L - Py, ny),
                       _reflect_src(x0 + lx - Px, nx),
                       _reflect_src(t0 + lt - Pt, nt)]
            assert np.array_equal(got, want)
            return got
        for L in range(ey):
            load(L)
        own = pad[y0 + ry + ei, x0 + rx + ej, t0 + rt + ek]
        # fused: a thread per run (i1, j1, k1), x fastest; its own values
        nch = -(-tt // 4)
        e1 = np.arange(ey * ex * nch)
        runs = (e1 // ex % ey, e1 % ex, e1 // (ex * ey) * 4)
        own_runs = [pad[y0 + ry + runs[0], x0 + rx + runs[1],
                        np.minimum(t0 + rt + runs[2] + kk, NT - 1)]
                    for kk in range(4 + 2 * ft)]
        acc = np.zeros((nout, nv))
        wsum = np.zeros(nout)
        wx = np.zeros(nout)
        for a in range(2 * ry + 1):
            dy = a - ry
            for dx, dt in itertools.product(range(-rx, rx + 1),
                                            range(-rt, rt + 1)):
                if (dy, dx, dt) == (0, 0, 0):
                    continue
                if plan['fused']:
                    Y = _fused_passes(own_runs, partner, a, dx, dt, runs,
                                      plan, r, f, nv)
                else:
                    bv = partner(a + ei, rx + ej + dx, rt + ek + dt)
                    d = own[:, 0] - bv[:, 0]
                    s = d * d
                    for v in range(1, nv):
                        d = own[:, v] - bv[:, v]
                        s = s + d * d
                    X = s
                    if ft > 0:
                        Y = X[tsrc]
                        for u in range(1, 2 * ft + 1):
                            Y = Y + X[tsrc + u]
                    else:
                        Y = X
                if plan['fused'] and fy > 0:
                    Z = _fused_y(Y, plan, f, ex)
                elif fy > 0:
                    Z = Y[np.arange(nyp)]
                    for u in range(1, 2 * fy + 1):
                        Z = Z + Y[np.arange(nyp) + u * ex * tt]
                else:
                    Z = Y
                # the x pass; the fused t plane's odd stride where fy = 0
                zt = (tt | 1) if plan['fused'] and fy == 0 else tt
                zb = (oy * ex + ox) * zt + ot
                patch = Z[zb]
                for u in range(1, 2 * fx + 1):
                    patch = patch + Z[zb + u * zt]
                g = np.maximum(patch / dsq_norm - 2.0 * sigma ** 2, 0)
                w = np.exp(-g * (1.0 / h ** 2))
                wsum = wsum + w
                wx = wx + w * w if n_eff >= 0 else np.maximum(w, wx)
                val = partner(a + fy + oy, Px + ox + dx, Pt + ot + dt)
                acc = acc + w[:, None] * val
            if plan['ring'] and a < 2 * ry:
                load(a + ey)
        if n_eff >= 0:
            disc = n_eff * wsum * wsum - n_eff * n_eff * wx + n_eff * wx
            w_self = (wsum + np.sqrt(disc)) / (n_eff - 1)
        else:
            w_self = np.where(wx == 0, 1.0, wx)
        center = pad[y0 + Py + oy, x0 + Px + ox, t0 + Pt + ot]
        res = (acc + w_self[:, None] * center) / (wsum + w_self)[:, None]
        gy, gx, gt = y0 + oy, x0 + ox, t0 + ot
        keep = (gy < ny) & (gx < nx) & (gt < nt)
        out[gy[keep], gx[keep], gt[keep]] = res[keep]
    return out


def _fused_passes(own_runs, partner, a, dx, dt, runs, plan, r, f, nv):
    """The fused build's squared differences and t sums: each run's
    4 + 2 ft inputs in registers, 4 t sums into the plane (ey, ex, tt),
    its t at the odd stride tt | 1."""
    ry, rx, rt = r
    fy, fx, ft = f
    ty, tx, tt = plan['tile']
    ey, ex, tts = ty + 2 * fy, tx + 2 * fx, tt | 1
    i1, j1, k1 = runs
    n1 = np.minimum(tt - k1, 4)
    Y = np.full(ey * ex * tts, np.nan)
    sq = []
    for kk in range(4 + 2 * ft):
        live = kk < n1 + 2 * ft
        lt = np.where(live, rt + k1 + kk + dt, rt + dt)
        bv = partner(a + i1, rx + j1 + dx, lt)
        d = own_runs[kk][:, 0] - bv[:, 0]
        s = d * d
        for v in range(1, nv):
            d = own_runs[kk][:, v] - bv[:, v]
            s = s + d * d
        sq.append(np.where(live, s, 0.0))
    for o in range(4):
        s = sq[o]
        for u in range(1, 2 * ft + 1):
            s = s + sq[o + u]
        keep = o < n1
        Y[((i1 * ex + j1) * tts + k1 + o)[keep]] = s[keep]
    return Y


def _fused_y(Y, plan, f, ex):
    """The fused build's y pass: runs of 4 outputs along y of each
    (x, t) column of the plane after t."""
    ty, tx, tt = plan['tile']
    fy, tts = f[0], tt | 1
    plane = ex * tt
    Z = np.full(ty * plane, np.nan)
    for e2 in range(plane * -(-ty // 4)):
        col, y2 = e2 % plane, e2 // plane * 4
        n2 = min(ty - y2, 4)
        src = y2 * ex * tts + col // tt * tts + col % tt
        v = [Y[src + u * ex * tts] if u < n2 + 2 * fy else 0.0
             for u in range(4 + 2 * fy)]
        for o in range(n2):
            s = v[o]
            for u in range(1, 2 * fy + 1):
                s = s + v[o + u]
            Z[(y2 + o) * plane + col] = s
    return Z


REPLAY = [((9, 11, 7, 4), (2, 2, 1), (1, 1, 1), (4, 4, 2), True, -1.0),
          ((9, 11, 7, 4), (2, 2, 1), (1, 1, 1), (4, 4, 2), True, 4.0),
          ((8, 9, 11, 4), (2, 1, 1), (1, 1, 1), (4, 8, 8), True, -1.0),
          ((8, 6, 5, 3), (3, 1, 2), (1, 2, 0), (2, 4, 4), True, -1.0),
          ((7, 9, 6, 4), (2, 3, 1), (0, 1, 1), (4, 2, 4), False, -1.0),
          ((6, 7, 5, 2), (1, 2, 2), (2, 0, 0), (2, 8, 1), False, -1.0),
          ((5, 6, 4, 4), (4, 2, 3), (0, 0, 0), (1, 2, 4), True, -1.0)]


# each plan unfused, and fused where the fused build takes it (replayed
# in float64)
REPLAY_BUILDS = [c + (False,) for c in REPLAY] + [
    c + (True,) for c in REPLAY
    if nlmeans_cuda.wide_fused(c[3], c[2], c[0][3], 4, c[4])]


@pytest.mark.parametrize('shape,r,f,tile,ring,n_eff,fused', REPLAY_BUILDS)
def test_wide_kernel_replay_matches_plain(shape, r, f, tile, ring, n_eff,
                                          fused):
    a = np.random.RandomState(31).rand(*shape)
    plan = nlmeans_cuda.wide_plan_of(shape, r, f, 8, tile, ring, fused)
    got = _emulate_wide(a, r, f, 0.3, 0.4, n_eff, plan)
    ref = nlmeans_plain(torch.from_numpy(a), r, f, 0.3, 0.4, n_eff).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def test_wide_plan_drops_the_ring_only_when_no_row_fits():
    # forty positions each way on x and t: one padded row of four float32
    # variables alone is ~ (2*42+1)^2 * 16 bytes
    plan = nlmeans_cuda._tile_plan((20, 100, 100, 4), (1, 40, 40),
                                   (1, 2, 2), 4)
    assert plan['route'] == 'wide' and not plan['ring']
    assert nlmeans_cuda.wide_smem((1, 1, 1), (1, 40, 40), (1, 2, 2), 4, 4,
                                  True) > nlmeans_cuda.SMEM_MAX
    assert plan['smem'] <= nlmeans_cuda.SMEM_MAX


# ---- the long-tap one-axis kernel --------------------------------------------

LONG_TAPS = {'65 weighted': np.linspace(0.5, 1.5, 65),
             '129 uniform': np.ones(129) / 129,
             '129 unit': np.ones(129),
             'gaussian sigma 16': np.flip(gaussian_kernel1d(16.0))}
# (lines, n, inner) views of one-axis passes: the phase-15 passes cut to
# size (y: (1, n, big inner); x: (rows, n, 56); t: (lines, 56, 1)), a
# ragged test view, n < k on the lines route
VIEWS = [(1, 70, 300), (9, 75, 56), (300, 56, 1), (37, 53, 7), (5, 20, 3),
         (3, 200, 1)]


@pytest.mark.parametrize('view', VIEWS + [(1, 1024, 57344),
                                          (1024, 1024, 56),
                                          (1048576, 56, 1)])
@pytest.mark.parametrize('k', [65, 129, 257])
@pytest.mark.parametrize('itemsize', [4, 8])
def test_long_plan_runs_and_blocks_cover_the_pass(view, k, itemsize):
    lines, n, inner = view
    plan = conv_cuda._long_plan(lines, n, inner, k, itemsize)
    assert plan['smem'] == conv_cuda.long_smem(
        plan['route'], k, n, inner, plan['per_block'], plan['nb'],
        itemsize) <= conv_cuda.SMEM_MAX
    assert plan['threads'] % 32 == 0
    if plan['route'] == 'lines':
        assert inner < 32 and 1 <= plan['per_block'] <= 64
        assert plan['threads'] <= 512
        assert plan['blocks'] * plan['per_block'] >= lines \
            > (plan['blocks'] - 1) * plan['per_block']
        runs = -(-n // conv_cuda.LONG_RUN_LINES)
        assert runs * conv_cuda.LONG_RUN_LINES >= n
    else:
        R = conv_cuda.LONG_RUN_ROWS
        cb, nb = plan['per_block'], plan['nb']
        assert nb % R == 0 and nb <= max(512, R) and plan['threads'] <= 256
        assert cb <= (inner if inner <= 64 else 32)
        count = np.zeros((n, min(inner, 200)), np.int64)
        for i0 in range(0, n, nb):
            for c0 in range(0, min(inner, 200), cb):
                count[i0:i0 + nb, c0:c0 + cb] += 1
        assert (count == 1).all()
        assert plan['blocks'] == lines * -(-n // nb) * -(-inner // cb)
    # the phase-15 passes: whole 128-byte rows or whole lines, a halo
    # of at most 1.5 x the outputs, two blocks an SM
    if itemsize == 4 and k <= 129:
        assert plan['smem'] <= conv_cuda.LONG_BUDGET
        if view == (1, 1024, 57344):
            assert plan['route'] == 'rows' and plan['per_block'] == 32
            assert plan['nb'] + k - 1 <= 1.5 * plan['nb']
        if view == (1024, 1024, 56):
            assert plan['route'] == 'rows' and plan['per_block'] == 56
            assert plan['nb'] + k - 1 <= 1.5 * plan['nb']
        if view == (1048576, 56, 1):
            assert plan['route'] == 'lines' and plan['per_block'] == 64


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('n,k', [(56, 129), (5, 65), (1, 65), (2, 129),
                                 (70, 65)])
def test_long_window_table_maps_the_boundary(mode, n, k):
    table = long_window_table(n, k, mode)
    nw = -(-n // conv_cuda.LONG_RUN_LINES) * conv_cuda.LONG_RUN_LINES + k - 1
    assert table.shape == (nw,)
    # the window of a line is the line padded by the mode: what the plain
    # version reads (cval where the table says -1)
    line = torch.arange(1.0, n + 1.0, dtype=torch.float64)[None, :, None,
                                                         None]
    padded = pad_reflect(line, ((0, 0), ((k - 1) // 2, nw - n - (k - 1) // 2),
                                (0, 0), (0, 0)), mode, -7.0)
    want = padded[0, :, 0, 0].numpy()
    got = np.where(table < 0, -7.0, table + 1.0)
    assert np.array_equal(got, want)
    assert ((table >= 0) & (table < n) | (table == -1)).all()
    assert (table == -1).any() == (mode == 'constant' and k > 1)


def long_window_table(n, k, mode):
    """csrc/sepconv_long.cu's index table of the 'lines' route: for each
    window position j of a line (ceil(n/R) R + k - 1 of them), the source
    position of ``j - (k-1)//2`` under ``mode`` (``ops.conv._edge_src``,
    the kernel's edge_src), -1 for the constant fill."""
    nw = -(-n // conv_cuda.LONG_RUN_LINES) * conv_cuda.LONG_RUN_LINES + k - 1
    src = [_edge_src(j - (k - 1) // 2, n, mode) for j in range(nw)]
    return np.array([-1 if s is None else s for s in src], np.int64)


def _run_taps(get, w, k, uniform, R):
    """csrc/sepconv_long.cu run_taps over arrays of items: get(j) is the
    window position j of every item; float32 throughout."""
    win = [get(q) for q in range(R)]
    w = w.astype(np.float32)
    acc = [win[r] if uniform else win[r] * w[0] for r in range(R)]
    for jb in range(0, k, R):
        win = win[:R] + [get(jb + R + q) if jb + R + q < k + R - 1
                         else np.zeros_like(win[0]) for q in range(R)]
        for jj in range(R):
            j = jb + jj
            if 1 <= j < k:
                for r in range(R):
                    acc[r] = acc[r] + (win[jj + r] if uniform
                                       else win[jj + r] * w[j])
        win = win[R:]
    return acc


def _emulate_long(x, taps, mode, cval, plan):
    """csrc/sepconv_long.cu in numpy over a (lines, n, inner) float32
    array: the plan's blocks, staging, runs and stores."""
    lines, n, inner = x.shape
    w, uniform, apply_scale = conv_cuda._taps(taps)
    k, lo = len(w), (len(w) - 1) // 2
    scale = np.float32(w[0])
    cval = np.float32(cval)
    out = np.full_like(x, np.nan)
    if plan['route'] == 'rows':
        R, cb, nb = conv_cuda.LONG_RUN_ROWS, plan['per_block'], plan['nb']
        for m, i0, c0 in itertools.product(range(lines), range(0, n, nb),
                                           range(0, inner, cb)):
            live = min(cb, inner - c0)
            rows = nb + k - 1
            S = np.zeros((rows, cb), np.float32)
            for j in range(rows):
                src = _edge_src(i0 - lo + j, n, mode)
                S[j, :live] = cval if src is None else \
                    x[m, src, c0:c0 + live]
            for run in range(nb // R):
                if i0 + run * R >= n:
                    continue
                acc = _run_taps(lambda j: S[run * R + j, :live], w, k,
                                uniform, R)
                for r in range(R):
                    if i0 + run * R + r < n:
                        out[m, i0 + run * R + r, c0:c0 + live] = \
                            acc[r] * scale if apply_scale else acc[r]
        return out
    R, L = conv_cuda.LONG_RUN_LINES, plan['per_block']
    table = long_window_table(n, k, mode)
    runs = -(-n // R)
    for m0 in range(0, lines, L):
        block = x[m0:m0 + L]
        E = np.where(table[None, :, None] < 0, cval,
                     block[:, np.maximum(table, 0)])
        for run in range(runs):
            acc = _run_taps(lambda j: E[:, run * R + j], w, k, uniform, R)
            for r in range(R):
                if run * R + r < n:
                    out[m0:m0 + L, run * R + r] = \
                        acc[r] * scale if apply_scale else acc[r]
    return out


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('view', VIEWS)
@pytest.mark.parametrize('taps', sorted(LONG_TAPS))
def test_long_kernel_replay_is_bit_equal_to_plain(mode, view, taps):
    x = np.random.RandomState(32).rand(*view).astype(np.float32)
    w = LONG_TAPS[taps]
    plan = conv_cuda._long_plan(*view, len(w), 4)
    got = _emulate_long(x, w, mode, 0.5, plan)
    ref = conv_cuda.sepconv2_plain(torch.from_numpy(x)[None], np.ones(1), w,
                                   mode=mode, cval=0.5)[0].numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('taps0,taps1,long', [
    (np.ones(1), LONG_TAPS['gaussian sigma 16'], True),
    (np.ones(1), LONG_TAPS['65 weighted'], True),
    (np.ones(1), np.ones(64), False),                 # inline taps
    (np.full(1, 2.0), LONG_TAPS['65 weighted'], False),   # scaled tap
    (np.array([0.25, 0.5, 0.25]), LONG_TAPS['65 weighted'], False),
    (LONG_TAPS['65 weighted'], np.ones(1), False)])
def test_only_one_long_axis_takes_the_long_tap_kernel(taps0, taps1, long):
    # ops/conv.py's one-axis pass is (1, outer, n, inner) with one unit
    # tap over outer; a long axis beside a short one stays on the tiled
    # kernel's long-tap route
    assert conv_cuda.takes_long_axis(taps0, taps1) == long
