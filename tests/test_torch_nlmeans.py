"""Parity of nd_tpu_torch's NLMeans with nd_tpu's.

The same numpy inputs (from a seed) go through the JAX function and its
port; the spatial Pallas kernel runs in interpret mode. Tolerance for
float32: rtol 1e-5, atol 1e-6 (the patch sums and the exp run in
another order and implementation than the reference's).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd_tpu.filters import NLMeansFilter as JNLMeansFilter
from nd_tpu.ops.nlmeans import find_weight_vectorized as jfind
from nd_tpu.ops.nlmeans import nlmeans as jnlmeans
from nd_tpu.ops.nlmeans_pallas import nlmeans_spatial_pallas
from nd_tpu_torch.filters import NLMeansFilter
from nd_tpu_torch.core import from_jax_dataset
from nd_tpu_torch.ops import nlmeans_cuda
from nd_tpu_torch.ops.nlmeans import find_weight_vectorized, nlmeans

TOL = dict(rtol=1e-5, atol=1e-6)


def _data(shape, dtype=np.float32, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(dtype)


SHAPES = [(20, 17, 3, 4), (9, 40, 1, 2), (16, 128, 2, 4), (13, 11, 2, 6)]


@pytest.mark.parametrize('shape,rf', [((20, 17, 3, 4), (1, 1)),
                                      ((9, 40, 1, 2), (2, 1)),
                                      ((16, 128, 1, 4), (2, 2))])
def test_spatial_matches_pallas(shape, rf):
    # interpret mode is slow: three cases cover the row-fused (odd
    # widths) and padless (128-aligned) kernels; the XLA test below
    # covers the rest of the grid
    r, f = rf
    a = _data(shape)
    ref = np.asarray(nlmeans_spatial_pallas(
        jnp.asarray(a), (r, r), (f, f), 2.0, 3.0, -1.0, interpret=True))
    got = nlmeans(torch.from_numpy(a), (r, r, 0), (f, f, 0), 2.0, 3.0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('rf', [(1, 1), (2, 1), (2, 2)])
def test_spatial_matches_xla(shape, rf):
    r, f = rf
    a = _data(shape, seed=8)
    ref = np.asarray(jnlmeans(jnp.asarray(a), (r, r, 0), (f, f, 0), 2.0,
                              3.0))
    got = nlmeans(torch.from_numpy(a), (r, r, 0), (f, f, 0), 2.0, 3.0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize('r,f', [((1, 2, 0), (1, 0, 0)),
                                 ((2, 1, 0), (0, 1, 0))])
def test_anisotropic_matches_xla(r, f):
    a = _data((15, 19, 3, 4), seed=1)
    ref = np.asarray(jnlmeans(jnp.asarray(a), r, f, 0.5, 0.8))
    got = nlmeans(torch.from_numpy(a), r, f, 0.5, 0.8).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_n_eff_matches_xla():
    a = _data((16, 16, 2, 4), seed=2)
    ref = np.asarray(jnlmeans(jnp.asarray(a), (2, 2, 0), (1, 1, 0), 2.0,
                              2.0, 4.0))
    got = nlmeans(torch.from_numpy(a), (2, 2, 0), (1, 1, 0), 2.0, 2.0,
                  4.0).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize('r,f', [((1, 1, 1), (1, 1, 1)),
                                 ((0, 0, 2), (1, 1, 0))])
def test_temporal_windows_match_xla_on_cpu(r, f):
    a = _data((12, 10, 5, 3), seed=3)
    ref = np.asarray(jnlmeans(jnp.asarray(a), r, f, 0.5, 0.8))
    got = nlmeans(torch.from_numpy(a), r, f, 0.5, 0.8).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_float64_matches_xla():
    a = _data((11, 12, 2, 4), np.float64, seed=4)
    ref = np.asarray(jnlmeans(jnp.asarray(a), (2, 1, 0), (1, 1, 0), 0.3,
                              0.4))
    got = nlmeans(torch.from_numpy(a), (2, 1, 0), (1, 1, 0), 0.3,
                  0.4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def test_identity_and_window_checks():
    a = torch.from_numpy(_data((6, 7, 2, 2)))
    assert nlmeans(a, (0, 0, 0), (1, 1, 0), 1.0, 1.0) is a
    with pytest.raises(ValueError, match='must be smaller'):
        nlmeans(a, (3, 1, 0), (3, 1, 0), 1.0, 1.0)
    with pytest.raises(ValueError, match='must be smaller'):
        nlmeans_cuda.nlmeans_spatial(a, (1, 6), (1, 1), 1.0, 1.0)
    with pytest.raises(ValueError, match='4-D'):
        nlmeans(a[0], (1, 1, 0), (1, 1, 0), 1.0, 1.0)
    with pytest.raises(ValueError, match='cuda or cpu'):
        nlmeans_cuda.nlmeans_spatial(a.to('meta'), (1, 1), (1, 1), 1.0, 1.0)


def test_find_weight_matches_jax():
    rng = np.random.RandomState(5)
    ws = rng.rand(50) * 8
    sq = rng.rand(50) * 2
    ref = np.asarray(jfind(jnp.asarray(ws), jnp.asarray(sq),
                           jnp.asarray(4.0)))
    got = find_weight_vectorized(torch.from_numpy(ws), torch.from_numpy(sq),
                                 torch.tensor(4.0, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14)


def _jax_dataset(ny=14, nx=18, nt=3, seed=6):
    from nd_tpu.core import Dataset as JDataset
    rng = np.random.RandomState(seed)
    return JDataset({v: (('y', 'x', 'time'),
                         rng.rand(ny, nx, nt).astype(np.float32))
                     for v in ('C11', 'C12__re', 'C12__im', 'C22')},
                    coords={'time': np.arange(nt)})


@pytest.mark.parametrize('dims,r,f', [(('y', 'x'), 2, 1),
                                      (('y', 'x'), 1, 1),
                                      (('x', 'y'), (1, 2), 1)])
def test_filter_apply_matches_jax(dims, r, f):
    jds = _jax_dataset()
    ref = JNLMeansFilter(dims=dims, r=r, f=f, sigma=2, h=3).apply(jds)
    got = NLMeansFilter(dims=dims, r=r, f=f, sigma=2, h=3).apply(
        from_jax_dataset(jds, device='cpu'))
    assert list(got.data_vars) == list(ref.data_vars)
    for v in ref.data_vars:
        assert got[v].dims == ref[v].dims
        np.testing.assert_allclose(got[v].values, ref[v].values, **TOL)


@pytest.mark.parametrize('shape,r,f', [
    ((20, 17, 5, 4), (1, 1, 1), (1, 1, 1)),   # full 3-D window
    ((12, 16, 7, 3), (0, 0, 2), (1, 1, 0)),   # temporal-only radius
    ((10, 14, 5, 1), (1, 0, 1), (0, 1, 1)),   # active axes {0, 2}
    ((18, 15, 4, 4), (2, 1, 0), (1, 1, 1)),   # spatial r, temporal f
])
def test_3d_window_matches_pallas(shape, r, f):
    # tests/test_pallas.py's shapes: the tiled kernel (temporal or full
    # 3-D windows) in interpret mode against the port's 3-D entry point
    from nd_tpu.ops.nlmeans_pallas import nlmeans_pallas
    a = _data(shape, seed=5)
    ref = np.asarray(nlmeans_pallas(jnp.asarray(a), r, f, 0.6, 0.9, -1.0,
                                    interpret=True))
    got = nlmeans_cuda.nlmeans_3d(torch.from_numpy(a), r, f, 0.6, 0.9)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(
        nlmeans(torch.from_numpy(a), r, f, 0.6, 0.9).numpy(), got.numpy())


def test_3d_filter_apply_matches_jax():
    # NLMeansFilter(dims=('y', 'x', 'time')): the joint (y, x, t, var)
    # stack through the 3-D window, reflect on t too
    jds = _jax_dataset(ny=12, nx=14, nt=6, seed=9)
    kw = dict(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1, sigma=2, h=3)
    ref = JNLMeansFilter(**kw).apply(jds)
    nlmeans_cuda.reset_launches()
    got = NLMeansFilter(**kw).apply(from_jax_dataset(jds, device='cpu'))
    assert nlmeans_cuda.launches_3d == 0          # CPU: the plain version
    for v in ref.data_vars:
        assert got[v].dims == ref[v].dims
        np.testing.assert_allclose(got[v].values, ref[v].values, **TOL)


def test_3d_checks():
    a = torch.from_numpy(_data((6, 7, 3, 2)))
    with pytest.raises(ValueError, match='must be smaller'):
        nlmeans_cuda.nlmeans_3d(a, (1, 1, 2), (0, 0, 1), 1.0, 1.0)
    with pytest.raises(ValueError, match='three radii'):
        nlmeans_cuda.nlmeans_3d(a, (1, 1), (1, 1), 1.0, 1.0)
    with pytest.raises(ValueError, match='contiguous'):
        nlmeans_cuda.nlmeans_3d(a.transpose(0, 1), (1, 1, 1), (1, 1, 1),
                                1.0, 1.0)
    with pytest.raises(ValueError, match='cuda or cpu'):
        nlmeans_cuda.nlmeans_3d(a.to('meta'), (1, 1, 1), (1, 1, 1), 1.0,
                                1.0)


PLAN_CASES = [((1024, 1024, 56, 4), (2, 2, 1), (1, 1, 1)),   # path A
              ((4096, 4096, 12, 4), (2, 2, 0), (1, 1, 0)),   # README chain
              ((1024, 1024, 12, 4), (2, 2, 0), (2, 2, 0)),
              ((1024, 1024, 12, 4), (2, 2, 0), (1, 1, 0)),
              ((1024, 1024, 12, 4), (1, 1, 0), (1, 1, 0)),
              ((37, 53, 5, 4), (2, 2, 1), (1, 1, 1)),         # ragged
              ((4, 4, 3, 5), (2, 2, 1), (1, 1, 1)),           # r+f+1 dims
              ((21, 37, 3, 6), (2, 2, 0), (2, 2, 0)),         # generic nv
              ((37, 53, 9, 1), (0, 0, 2), (0, 0, 1)),         # (time,)
              ((37, 53, 9, 2), (0, 2, 1), (0, 1, 1)),         # (x, time)
              ((15, 19, 9, 4), (1, 1, 1), (3, 8, 3)),         # largest f
              ((24, 26, 9, 4), (10, 10, 3), (3, 3, 3)),       # wide
              ((20, 100, 100, 4), (1, 40, 40), (1, 2, 2))]    # wide, no ring


@pytest.mark.parametrize('shape,r,f', PLAN_CASES)
@pytest.mark.parametrize('itemsize', [4, 8])
def test_tile_plan_covers_every_output_once(shape, r, f, itemsize):
    plan = nlmeans_cuda._tile_plan(shape, r, f, itemsize)
    ty, tx, tt = plan['tile']
    ny, nx, nt, nv = shape
    # the kernels' block order: t fastest, then x, then y
    nbt, nbx = -(-nt // tt), -(-nx // tx)
    count = np.zeros((ny, nx, nt), np.int64)
    for b in range(plan['blocks']):
        y0, x0, t0 = (b // nbt // nbx) * ty, (b // nbt % nbx) * tx, \
            (b % nbt) * tt
        count[y0:y0 + ty, x0:x0 + tx, t0:t0 + tt] += 1
    assert (count == 1).all()
    assert plan['smem'] <= nlmeans_cuda.SMEM_MAX
    assert plan['threads'] % 32 == 0 and plan['threads'] >= 32
    # the ring route where its patch radii and its smallest block fit
    R, C, tx_run = nlmeans_cuda.ring_run(shape, r, f, itemsize)
    assert (R, C) == ((4, 2) if f[2] else (8, 1))
    pairs = itemsize == 4 and nv == 4 and f[2] == r[2] == 0 \
        and f[0] == f[1] in (1, 2) and 1 <= r[0] <= 2 and r[1] + f[1] <= 8
    assert tx_run == 32 - 2 * (f[1] + r[1] * pairs)
    ring = max(f[0], f[2]) <= nlmeans_cuda.RING_FMAX \
        and f[1] <= nlmeans_cuda.RING_FXMAX \
        and nlmeans_cuda.ring_smem((R, tx_run, C), r, f, nv,
                                   itemsize) <= nlmeans_cuda.SMEM_MAX
    assert plan['route'] == ('ring' if ring else 'wide')
    if plan['route'] == 'wide':
        return
    assert plan['pairs'] == pairs
    # a warp: 32 lanes along x, the tx inner ones outputs; a thread: R
    # outputs along y at C along t
    assert tx == tx_run and ty % R == 0 and tt % C == 0
    assert plan['threads'] == 32 * (ty // R) * (tt // C) \
        <= nlmeans_cuda.RING_MAX_THREADS
    assert plan['threads'] // 32 * tx * R * C == ty * tx * tt
    # the halo: r + f on y and t, the 32 lanes and rx on each side on x
    halo = (ty + 2 * (r[0] + f[0])) * (32 + 2 * r[1]) \
        * (tt + 2 * (r[2] + f[2]))
    assert plan['smem'] == nv * halo * itemsize


def _reflect_src(j, n):
    """csrc/nlmeans.cu reflect_src."""
    j = np.abs(j)
    j = np.where(j >= n, 2 * n - 2 - j, j)
    return np.clip(j, 0, n - 1)


def _emulate_ring(arr, r, f, sigma, h, n_eff, plan):
    """csrc/nlmeans.cu's ring route in numpy: per block the halo tile as
    the kernels' flat array (x fastest, then y, then t; nv values a
    position), per warp its 32 lanes as vectors (a shuffle indexes them
    modulo 32), each thread's rows, columns, passes and terms in the
    kernel's order through its flat offsets: ``nlmeans_ring`` (both
    directions at each output) or, where ``plan['pairs']``,
    ``nlmeans_ring_pairs`` (each pair's weight once, the backward one from the
    lane dx to the left). Every read is checked against the
    reflect-mapped cube."""
    ny, nx, nt, nv = arr.shape
    ry, rx, rt = r
    fy, fx, ft = f
    ty, tx, tt = plan['tile']
    R, C = (4, 2) if ft else (8, 1)
    lx = (32 - tx) // 2                   # lanes before the first output
    Py, Pt = ry + fy, rt + ft
    Ey, Ex, Et = ty + 2 * Py, 32 + 2 * rx, tt + 2 * Pt
    sY, sT = Ex * nv, Ey * Ex * nv
    dsq_norm = float(nv * (2 * fy + 1) * (2 * fx + 1) * (2 * ft + 1))
    offsets = [d for d in itertools.product(
        range(-ry, ry + 1), range(-rx, rx + 1), range(-rt, rt + 1))
        if d > (0, 0, 0)]
    lanes, var = np.arange(32), np.arange(nv)
    out = np.zeros_like(arr)
    written = np.zeros(arr.shape[:3], np.int64)
    nbt, nbx = -(-nt // tt), -(-nx // tx)

    def weight(p):
        return np.exp(-np.maximum(p / dsq_norm - 2 * sigma ** 2, 0)
                      * (1.0 / h ** 2))

    def xpass(py):
        px = py[(lanes - fx) % 32]
        for u in range(1, 2 * fx + 1):
            px = px + py[(lanes - fx + u) % 32]
        return px

    def sq(a, b):
        s = (a[:, 0] - b[:, 0]) ** 2
        for v in range(1, nv):
            s = s + (a[:, v] - b[:, v]) ** 2
        return s

    for b in range(plan['blocks']):
        t0, x0, y0 = (b % nbt) * tt, (b // nbt % nbx) * tx, \
            (b // nbt // nbx) * ty
        it, iy, ix = np.meshgrid(np.arange(Et), np.arange(Ey),
                                 np.arange(Ex), indexing='ij')
        tile = arr[_reflect_src(y0 - Py + iy, ny),
                   _reflect_src(x0 - lx - rx + ix, nx),
                   _reflect_src(t0 - Pt + it, nt)].ravel()
        for warp in range(plan['threads'] // 32):
            wy, wt = divmod(warp, tt // C)
            gx = x0 - lx + lanes
            gy0, gt0 = y0 + wy * R, t0 + wt * C
            base = (wt * C + rt) * sT + (wy * R + ry) * sY + (rx + lanes) * nv

            def rec(e, y, t, dx=0):
                assert (e >= 0).all() and (e + nv <= tile.size).all()
                got = tile[e[:, None] + var]
                want = arr[_reflect_src(y, ny), _reflect_src(gx + dx, nx),
                           _reflect_src(t, nt)]
                assert np.array_equal(got, want)
                return got

            acc = np.zeros((R, C, 32, nv))
            wsum = np.zeros((R, C, 32))
            wx = np.zeros((R, C, 32))

            def add(k, c, w, val):
                wsum[k, c] = wsum[k, c] + w
                wx[k, c] = wx[k, c] + w * w if n_eff >= 0 \
                    else np.where(w > wx[k, c], w, wx[k, c])
                acc[k, c] = acc[k, c] + w[:, None] * val

            for dy, dx, dt in offsets:
                doff = dt * sT + dy * sY + dx * nv
                if plan['pairs']:
                    # the weights at rows gy0 - dy .. gy0 + R - 1
                    S = [sq(rec(base + (j - dy) * sY, gy0 - dy - fy + j,
                                gt0),
                            rec(base + (j - dy) * sY + doff, gy0 - fy + j,
                                gt0, dx))
                         for j in range(R + dy + 2 * fy)]
                    W = []
                    for e in range(R + dy):
                        py = S[e]
                        for u in range(1, 2 * fy + 1):
                            py = py + S[e + u]
                        W.append(weight(xpass(py)))
                    for k in range(R):
                        ctr = base + (k + fy) * sY
                        add(k, 0, W[k + dy],
                            rec(ctr + doff, gy0 + k + dy, gt0, dx))
                        add(k, 0, W[k][(lanes - dx) % 32],
                            rec(ctr - doff, gy0 + k - dy, gt0, -dx))
                    continue
                pt = {}
                for j in range(R + 2 * fy):
                    y = gy0 - fy + j
                    s = []
                    for cc in range(C + 2 * ft):
                        t = gt0 - ft + cc
                        a = base + cc * sT + j * sY
                        ca = rec(a, y, t)
                        s.append((sq(ca, rec(a + doff, y + dy, t + dt, dx)),
                                  sq(ca, rec(a - doff, y - dy, t - dt,
                                             -dx))))
                    for c in range(C):
                        for d in range(2):
                            acc_t = s[c][d]
                            for u in range(1, 2 * ft + 1):
                                acc_t = acc_t + s[c + u][d]
                            pt[j, c, d] = acc_t
                for k in range(R):
                    for c in range(C):
                        ctr = base + (c + ft) * sT + (k + fy) * sY
                        for d, sgn in ((0, 1), (1, -1)):
                            acc_y = pt[k, c, d]
                            for u in range(1, 2 * fy + 1):
                                acc_y = acc_y + pt[k + u, c, d]
                            add(k, c, weight(xpass(acc_y)),
                                rec(ctr + sgn * doff, gy0 + k + sgn * dy,
                                    gt0 + c + sgn * dt, sgn * dx))
            for k in range(R):
                for c in range(C):
                    ok = (lanes >= lx) & (lanes < 32 - lx) & (gx < nx)
                    if gy0 + k >= ny or gt0 + c >= nt or not ok.any():
                        continue
                    if n_eff >= 0:
                        n = float(n_eff)
                        disc = n * wsum[k, c] * wsum[k, c] \
                            - n * n * wx[k, c] + n * wx[k, c]
                        with np.errstate(invalid='ignore'):
                            w_self = (wsum[k, c] + np.sqrt(disc)) / (n - 1)
                    else:
                        w_self = np.where(wx[k, c] == 0, 1.0, wx[k, c])
                    total = wsum[k, c] + w_self
                    center = rec(base + (c + ft) * sT + (k + fy) * sY,
                                 gy0 + k, gt0 + c)
                    res = (acc[k, c] + w_self[:, None] * center) \
                        / total[:, None]
                    out[gy0 + k, gx[ok], gt0 + c] = res[ok]
                    written[gy0 + k, gx[ok], gt0 + c] += 1
    assert (written == 1).all()
    return out


# spatial, 3-D, (time,) and (x, time) windows, any nv, the largest
# patch; the pair kernel's spatial windows (float32, nv = 4)
RING_CASES = [((11, 35, 3, 4), (2, 2, 0), (1, 1, 0), -1.0, 8),
              ((12, 33, 2, 4), (2, 2, 0), (2, 2, 0), 4.0, 8),
              ((9, 33, 6, 4), (2, 2, 1), (1, 1, 1), -1.0, 8),
              ((5, 7, 9, 3), (0, 0, 2), (0, 0, 1), 4.0, 8),
              ((6, 35, 7, 2), (0, 2, 1), (0, 1, 1), -1.0, 8),
              ((8, 19, 9, 1), (1, 1, 1), (3, 8, 3), -1.0, 8),
              ((11, 35, 3, 4), (2, 2, 0), (1, 1, 0), -1.0, 4),
              ((12, 33, 2, 4), (2, 2, 0), (2, 2, 0), 4.0, 4),
              ((19, 30, 2, 4), (1, 1, 0), (1, 1, 0), -1.0, 4)]


@pytest.mark.parametrize('shape,r,f,n_eff,itemsize', RING_CASES)
def test_ring_kernel_emulated_matches_plain(shape, r, f, n_eff, itemsize):
    # the ring route's flat offsets, lanes, runs and passes, through the
    # plan the shapes get, agree with the plain version (in float64)
    plan = nlmeans_cuda._tile_plan(shape, r, f, itemsize)
    assert plan['route'] == 'ring'
    assert plan['pairs'] == (itemsize == 4 and f[2] == 0 and shape[3] == 4)
    a = np.random.RandomState(61).rand(*shape)
    got = _emulate_ring(a, r, f, 0.3, 0.4, n_eff, plan)
    ref = nlmeans_cuda.nlmeans_3d_plain(torch.from_numpy(a), r, f, 0.3, 0.4,
                                        n_eff).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize('shape,r,f', PLAN_CASES[:4])
def test_tile_plan_fits_two_blocks_per_sm_at_the_path_shapes(shape, r, f):
    assert nlmeans_cuda._tile_plan(shape, r, f, 4)['smem'] \
        <= nlmeans_cuda.SMEM_BUDGET


def test_tile_plan_raises_when_nothing_fits():
    # past the ring route's patch radii, and the wide route's planes
    # overflow the block
    with pytest.raises(ValueError, match='no tile fits'):
        nlmeans_cuda._tile_plan((256, 256, 256, 1), (1, 1, 1),
                                (40, 40, 40), 8)


@pytest.mark.parametrize('r,f', [((2, 2, 1), (1, 1, 1)),
                                 ((2, 1, 0), (2, 1, 0))])
def test_plain_uses_each_offset_pair_once_in_both_directions(r, f):
    # the kernel's order (pairs, forward and backward terms, separable
    # patch sums) agrees with one pass per signed offset, the direct
    # definition, to f32 rounding
    import itertools
    a = torch.from_numpy(_data((9, 11, 5, 3), seed=58))
    got = nlmeans_cuda.nlmeans_3d_plain(a, r, f, 1.0, 1.5)
    pad = [ri + fi for ri, fi in zip(r, f)]
    P = np.pad(a.double().numpy(), [(p, p) for p in pad] + [(0, 0)],
               mode='reflect')
    D = a.shape[:3]
    norm = 3 * np.prod([2 * fi + 1 for fi in f])
    wsum = np.zeros(D)
    wmax = np.zeros(D)
    acc = np.zeros(a.shape)
    for off in itertools.product(*[range(-ri, ri + 1) for ri in r]):
        if off == (0, 0, 0):
            continue
        dsq = np.zeros(D)
        for u in itertools.product(*[range(-fi, fi + 1) for fi in f]):
            s1 = tuple(slice(p + ui, p + ui + n)
                       for p, ui, n in zip(pad, u, D))
            s2 = tuple(slice(p + ui + o, p + ui + o + n)
                       for p, ui, o, n in zip(pad, u, off, D))
            dsq += ((P[s1] - P[s2]) ** 2).sum(-1)
        w = np.exp(-np.maximum(dsq / norm - 2.0, 0) / 1.5 ** 2)
        vals = P[tuple(slice(p + o, p + o + n)
                       for p, o, n in zip(pad, off, D))]
        wsum += w
        wmax = np.maximum(wmax, w)
        acc += w[..., None] * vals
    w_self = np.where(wmax == 0, 1.0, wmax)
    center = P[tuple(slice(p, p + n) for p, n in zip(pad, D))]
    ref = (acc + w_self[..., None] * center) / (wsum + w_self)[..., None]
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
