"""Resampling on the caller's device: gathers, separable matmuls and
footprint statistics.

Counterpart of ``nd_tpu/ops/interp.py``. The destination grid is mapped
to fractional source pixel coordinates on the host in float64 numpy
(``grid_from_transforms``); the values are then gathered and
interpolated with PyTorch ops on the tensors' device. Every index is
clipped into the raster before it is used (on the card an index out of
range is a device-side assert, where JAX clamps). Nodata semantics are
the JAX package's: an out-of-range target yields ``cval`` and a
non-finite contributor yields NaN; a NaN coordinate is out of range.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.variable import as_tensor

__all__ = ['map_coordinates', 'grid_from_transforms',
           'separable_coords', 'axis_weights', 'matmul_resample',
           'footprint_axis', 'footprint_resample', 'FOOTPRINT_STATS',
           'full_f32_matmul']


def _catmull_weights(t):
    """Catmull-Rom (a = -0.5, the GDAL 'cubic' kernel) tap weights for
    offsets (-1, 0, 1, 2) at fraction ``t`` in [0, 1)."""
    w0 = ((-t + 2.0) * t - 1.0) * t * 0.5
    w1 = ((3.0 * t - 5.0) * t * t + 2.0) * 0.5
    w2 = ((-3.0 * t + 4.0) * t + 1.0) * t * 0.5
    w3 = (t - 1.0) * t * t * 0.5
    return (w0, w1, w2, w3)


def _bspline_weights(t):
    """Cubic B-spline tap weights for offsets (-1, 0, 1, 2) at
    fraction ``t`` in [0, 1) — GDAL's 'cubicspline', an approximating
    kernel (taps non-negative, summing to 1)."""
    u = 1.0 - t
    w0 = u * u * u / 6.0
    w1 = (3.0 * t * t * t - 6.0 * t * t + 4.0) / 6.0
    w2 = (3.0 * (u * u * u - 2.0 * u * u) + 4.0) / 6.0
    w3 = t * t * t / 6.0
    return (w0, w1, w2, w3)


_LANCZOS_A = 3   # GDAL's lanczos window (6x6 support)


def _lanczos_weights(t, xp=torch):
    """Normalized Lanczos-3 tap weights for offsets (-2..3) at fraction
    ``t`` in [0, 1); ``xp`` is ``torch`` for tensors, ``np`` for the
    host plans."""
    a = float(_LANCZOS_A)
    taps = []
    for off in range(-(_LANCZOS_A - 1), _LANCZOS_A + 1):
        x = t - off
        # sinc(x) * sinc(x/a) with the removable singularity at 0
        px = np.pi * x
        safe = xp.where(x == 0, 1.0, px)
        w = xp.where(
            x == 0, 1.0,
            a * xp.sin(safe) * xp.sin(safe / a) / (safe * safe))
        taps.append(w)
    total = taps[0]
    for w in taps[1:]:
        total = total + w
    return [w / total for w in taps]


def _clip_index(v, size):
    """Integer indices from float ones, clipped into ``[0, size)`` (NaN
    to 0) before the cast: safe to index with on the card whatever the
    coordinates were."""
    return torch.nan_to_num(v, nan=0.0).clamp(0, size - 1).to(torch.int64)


def map_coordinates(values, rows, cols, method='bilinear', cval=np.nan,
                    device=None):
    """Sample ``values`` at fractional pixel coordinates.

    Parameters
    ----------
    values : tensor or array (..., H, W)
        Source raster(s); leading dims are batched. An array lands on
        ``device`` (default ``cuda``), a tensor stays where it is.
    rows, cols : tensors or arrays of identical shape S
        Fractional pixel coordinates to sample at (arrays land on
        ``values``' device).
    method : {'bilinear', 'nearest', 'cubic', 'cubic_spline', 'lanczos'}
        'cubic' is the Catmull-Rom 4x4 kernel (GDAL's cubic),
        'cubic_spline' the cubic B-spline, 'lanczos' the normalized
        Lanczos-3 6x6 window — all edge-clamped.
    cval : float
        Fill value for out-of-bounds samples (default NaN; 0 for an
        integer raster, which cannot hold NaN).

    Returns
    -------
    tensor (..., *S)
    """
    values = as_tensor(values, device)
    rows, cols = (as_tensor(a, values.device) for a in (rows, cols))
    if method in ('bilinear', 'cubic', 'cubic_spline', 'lanczos') \
            and not (values.is_floating_point() or values.is_complex()):
        # fractional weights need a float accumulator
        values = values.to(torch.float32)
    H, W = values.shape[-2], values.shape[-1]
    batch_shape = tuple(values.shape[:-2])
    out_shape = tuple(rows.shape)

    flat = values.reshape((-1, H * W))
    r = rows.reshape(-1)
    c = cols.reshape(-1)

    def take(ri, ci):
        return flat.index_select(1, ri * W + ci)

    if method == 'nearest':
        rr = torch.round(r)
        cr = torch.round(c)
        valid = (rr >= 0) & (rr <= H - 1) & (cr >= 0) & (cr <= W - 1)
        out = take(_clip_index(rr, H), _clip_index(cr, W))
        if out.is_floating_point() or out.is_complex():
            # +-inf source samples resolve to NaN (any non-finite
            # touched contributor yields NaN, as on the matmul path)
            out = out.masked_fill(torch.isinf(out), np.nan)
            fill = cval
        else:
            # integer rasters can't hold NaN: 0 is the nodata sentinel
            try:
                is_nan = bool(np.isnan(cval))
            except (TypeError, ValueError):
                is_nan = False
            fill = 0 if is_nan else cval
        out = out.masked_fill(~valid[None, :], fill)
    elif method in ('bilinear', 'cubic', 'cubic_spline', 'lanczos'):
        # tolerate float rounding at the raster boundary (identity
        # warps must keep edge pixels valid)
        eps = 1e-6
        valid = (r >= -eps) & (r <= H - 1 + eps) & \
            (c >= -eps) & (c <= W - 1 + eps)
        r = r.clamp(0, H - 1)
        c = c.clamp(0, W - 1)
        r0 = torch.floor(r)
        c0 = torch.floor(c)
        r0i = _clip_index(r0, H)
        c0i = _clip_index(c0, W)
        if method == 'bilinear':
            r1i = (r0i + 1).clamp(max=H - 1)
            c1i = (c0i + 1).clamp(max=W - 1)
            v00 = take(r0i, c0i)
            v01 = take(r0i, c1i)
            v10 = take(r1i, c0i)
            v11 = take(r1i, c1i)
            fr = (r - r0)[None, :].to(v00.dtype)
            fc = (c - c0)[None, :].to(v00.dtype)
            acc = (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
                   + v10 * fr * (1 - fc) + v11 * fr * fc)
        else:
            fr = (r - r0).to(flat.dtype)
            fc = (c - c0).to(flat.dtype)
            if method == 'cubic':
                wr, wc = _catmull_weights(fr), _catmull_weights(fc)
                first = -1
            elif method == 'cubic_spline':
                wr, wc = _bspline_weights(fr), _bspline_weights(fc)
                first = -1
            else:
                wr, wc = _lanczos_weights(fr), _lanczos_weights(fc)
                first = -(_LANCZOS_A - 1)
            # IEEE does the NaN bookkeeping: 0 * NaN = NaN, so every
            # touched non-finite contributor poisons the sum even at a
            # zero tap weight, as the matmul plan's contributor count
            acc = torch.zeros((flat.shape[0],) + tuple(r.shape),
                              dtype=flat.dtype, device=flat.device)
            for a in range(len(wr)):
                ra = (r0i + (a + first)).clamp(0, H - 1)
                for bb in range(len(wc)):
                    cb = (c0i + (bb + first)).clamp(0, W - 1)
                    w = (wr[a] * wc[bb])[None, :]
                    acc = acc + take(ra, cb) * w
        # an inf contributor surfaces as inf or NaN (0 * inf); both
        # become NaN so every path agrees
        out = acc.masked_fill(torch.isinf(acc), np.nan)
        out = out.masked_fill(~valid[None, :], cval)
    else:
        raise ValueError('unknown method %r' % method)

    return out.reshape(batch_shape + out_shape)


def separable_coords(rows, cols, atol=1e-6):
    """Detect a separable warp: ``rows`` varies only along axis 0 and
    ``cols`` only along axis 1 (within ``atol`` source pixels).

    True for every axis-aligned affine warp and for CRS pairs whose
    forward map factors per axis (e.g. geographic <-> Mercator).
    Returns ``(rows_1d, cols_1d)`` host arrays, or None.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    r1 = rows[:, :1]
    c1 = cols[:1, :]
    if np.all(np.abs(rows - r1) <= atol) \
            and np.all(np.abs(cols - c1) <= atol):
        return r1[:, 0], c1[0]
    return None


def axis_weights(coords, size, method):
    """Per-axis interpolation operator for a separable resample (host
    numpy, as ``nd_tpu``'s).

    Returns ``(W, Wm, valid)``: ``W`` (n_dst, size) float32 weights
    (rows sum to 1), ``Wm`` the contributor-count matrix (an entry per
    touched source sample, weight-independent: zero-weight neighbours
    count, as in the gather's NaN propagation), and ``valid`` the
    in-range mask along this axis.
    """
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    W = np.zeros((n, size), np.float32)
    Wm = np.zeros((n, size), np.float32)
    rng = np.arange(n)
    if method == 'nearest':
        idx = np.round(coords).astype(np.int64)
        valid = (idx >= 0) & (idx < size)
        idxc = np.clip(idx, 0, size - 1)
        W[rng, idxc] = 1.0
        Wm[rng, idxc] = 1.0
        return W, Wm, valid
    eps = 1e-6
    valid = (coords >= -eps) & (coords <= size - 1 + eps)
    r = np.clip(coords, 0, size - 1)
    r0 = np.floor(r)
    r0i = r0.astype(np.int64)
    if method == 'bilinear':
        fr = (r - r0).astype(np.float32)
        r1i = np.minimum(r0i + 1, size - 1)
        np.add.at(W, (rng, r0i), 1.0 - fr)
        np.add.at(W, (rng, r1i), fr)
        np.add.at(Wm, (rng, r0i), 1.0)
        np.add.at(Wm, (rng, r1i), 1.0)
        return W, Wm, valid
    if method in ('cubic', 'cubic_spline', 'lanczos'):
        fr = r - r0
        if method == 'cubic':
            taps = _catmull_weights(fr)
            first = -1
        elif method == 'cubic_spline':
            taps = _bspline_weights(fr)
            first = -1
        else:
            taps = _lanczos_weights(fr, xp=np)
            first = -(_LANCZOS_A - 1)
        for a in range(len(taps)):
            idx = np.clip(r0i + (a + first), 0, size - 1)
            np.add.at(W, (rng, idx), np.asarray(taps[a], np.float32))
            np.add.at(Wm, (rng, idx), 1.0)
        return W, Wm, valid
    if method == 'average':
        # GDAL's downsampling average: uniform over the source samples
        # whose centers fall inside the destination cell's footprint
        # (width = the coordinate step), normalized by the count
        step = np.abs(np.diff(coords))
        s = max(1.0, float(np.median(step))) if len(step) else 1.0
        lo = np.ceil(coords - s / 2.0 - 1e-9).astype(np.int64)
        hi = np.floor(coords + s / 2.0 - 1e-9).astype(np.int64)
        # never an empty window: degenerate cells take the nearest
        empty = hi < lo
        near = np.round(coords).astype(np.int64)
        lo = np.where(empty, near, lo)
        hi = np.where(empty, near, hi)
        span = int((hi - lo).max()) + 1 if n else 1
        for off in range(span):
            idx = lo + off
            inside = (idx <= hi) & (idx >= 0) & (idx < size)
            np.add.at(W, (rng[inside], idx[inside]), 1.0)
            np.add.at(Wm, (rng[inside], idx[inside]), 1.0)
        counts = W.sum(axis=1)
        valid = valid & (counts > 0)
        counts = np.where(counts > 0, counts, 1.0)
        W /= counts[:, None]
        return W, Wm, valid
    raise ValueError('unknown method %r' % method)


def _precision_flags():
    """(object, attribute, full-precision value) of each switch that
    selects float32 matmul precision: the per-backend ``fp32_precision``
    of PyTorch releases that have it (cuBLAS, and oneDNN on the CPU),
    else the legacy cuBLAS ``allow_tf32``."""
    cublas = torch.backends.cuda.matmul
    if not hasattr(cublas, 'fp32_precision'):
        return [(cublas, 'allow_tf32', False)]
    flags = [(cublas, 'fp32_precision', 'ieee')]
    onednn = getattr(torch.backends.mkldnn, 'matmul', None)
    if onednn is not None and hasattr(onednn, 'fp32_precision'):
        flags.append((onednn, 'fp32_precision', 'ieee'))
    return flags


@contextlib.contextmanager
def full_f32_matmul():
    """float32 matmuls at full precision inside the block (no TF32 on
    the card, no reduced-precision passes on the CPU); the caller's
    setting is restored on the way out."""
    flags = _precision_flags()
    prev = [getattr(obj, attr) for obj, attr, _ in flags]
    for obj, attr, value in flags:
        setattr(obj, attr, value)
    try:
        yield
    finally:
        for (obj, attr, _), value in zip(flags, prev):
            setattr(obj, attr, value)


def _separable(wy, V, wx):
    """``wy @ V @ wx.T`` over the last two axes of ``V``: the column
    product first (``V @ wx.T``, contracting the source columns), then
    the row product (``wy @ .``, contracting the source rows)."""
    return torch.matmul(wy, torch.matmul(V, wx.transpose(0, 1)))


def matmul_resample(values, wy, wym, wx, wxm, valid_y, valid_x, cval,
                    expected, skipna=False, device=None):
    """Separable resample as two matmuls per operator.

    ``out[..., i, j] = sum_hw wy[i, h] * values[..., h, w] * wx[j, w]``
    with the gather path's semantics: out-of-range along either axis
    yields ``cval``; any non-finite touched source sample (``expected``
    of them, counted through the weight-independent ``wym``/``wxm``)
    yields NaN. The products run in ``values``' dtype at full float32
    precision (:func:`full_f32_matmul`), columns first.

    ``skipna=True`` (the 'average' method) switches to a NaN-skipping
    weighted mean instead: non-finite contributors drop out of the
    normalization, and a cell with no finite contributor is NaN.

    Arrays land on ``device`` (``values``; default ``cuda``) and on
    ``values``' device (the plan); tensors stay where they are.
    """
    values = as_tensor(values, device)
    wy, wym, wx, wxm, valid_y, valid_x = (
        as_tensor(a, values.device)
        for a in (wy, wym, wx, wxm, valid_y, valid_x))
    dt = values.dtype
    wy, wym, wx, wxm = (w.to(dt) for w in (wy, wym, wx, wxm))
    finite = torch.isfinite(values)
    Vs = values.masked_fill(~finite, 0)
    with full_f32_matmul():
        num = _separable(wy, Vs, wx)
        if skipna:
            den = _separable(wy, finite.to(dt), wx)
            empty = ~(den > 1e-12)
            out = (num / den.masked_fill(empty, 1.0)).masked_fill(empty,
                                                                  np.nan)
        else:
            cnt = _separable(wym, finite.to(dt), wxm)
            out = num.masked_fill(~(cnt > expected - 0.5), np.nan)
    in_range = valid_y[:, None] & valid_x[None, :]
    return out.masked_fill(~in_range, cval)


# ---------------------------------------------------------------------------
# Footprint (order-statistic) resampling — GDAL's mode / min / max /
# med / q1 / q3 / sum / rms for downsampling warps
# ---------------------------------------------------------------------------

FOOTPRINT_STATS = ('mode', 'min', 'max', 'med', 'q1', 'q3', 'sum',
                   'rms')

# contributors per destination pixel beyond this would sort/scan huge
# windows per pixel — a deliberate >32x-per-axis downsample should
# coarsen first
FOOTPRINT_SPAN_CAP = 1024


def footprint_axis(coords, size, fallback_step=1.0):
    """Per-axis contributor plan for the footprint statistics (host
    numpy, as ``nd_tpu``'s).

    Same footprint model as 'average' (see ``axis_weights``). Returns
    ``(idx, inside, valid)``: ``idx`` (n, span) clipped int32 source
    indices, ``inside`` (n, span) the contributor mask, ``valid`` (n,)
    the destination in-range mask. ``fallback_step`` (the affine scale
    ratio) is the cell width of a single-pixel axis.
    """
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    step = np.abs(np.diff(coords))
    s = max(1.0, float(np.median(step)) if len(step)
            else float(fallback_step))
    lo = np.ceil(coords - s / 2.0 - 1e-9).astype(np.int64)
    hi = np.floor(coords + s / 2.0 - 1e-9).astype(np.int64)
    empty = hi < lo
    near = np.round(coords).astype(np.int64)
    lo = np.where(empty, near, lo)
    hi = np.where(empty, near, hi)
    span = int((hi - lo).max()) + 1 if n else 1
    idx = lo[:, None] + np.arange(span)[None, :]
    inside = (idx <= hi[:, None]) & (idx >= 0) & (idx < size)
    valid = inside.any(axis=1)
    return (np.clip(idx, 0, size - 1).astype(np.int32), inside, valid)


def _masked_mode(win, ok):
    """Most frequent finite value per window (last axis); ties go to
    the smallest value. O(s) run lengths on the sorted window."""
    s = win.shape[-1]
    ws = torch.sort(win.masked_fill(~ok, np.inf), dim=-1).values
    pos = torch.arange(s, device=win.device)
    ones = torch.ones(ws.shape[:-1] + (1,), dtype=torch.bool,
                      device=win.device)
    new_run = torch.cat([ones, ws[..., 1:] != ws[..., :-1]], dim=-1)
    # first index of each element's run (cummax of run-start marks)
    start = torch.cummax(torch.where(new_run, pos, 0), dim=-1).values
    # last index: reversed cummin of the run-end marks
    end_mark = torch.cat([new_run[..., 1:], ones], dim=-1)
    rev = torch.flip(torch.where(end_mark, pos, s - 1), dims=(-1,))
    end = torch.flip(torch.cummin(rev, dim=-1).values, dims=(-1,))
    length = torch.where(torch.isfinite(ws), end - start + 1, 0)
    # argmax returns the FIRST maximum: the smallest value, since the
    # window is sorted ascending
    mode = torch.gather(ws, -1, torch.argmax(length, dim=-1,
                                             keepdim=True))[..., 0]
    return mode.masked_fill(~ok.any(dim=-1), np.nan)


def _masked_quantile(win, ok, q):
    """Linear-interpolated quantile ``q`` of each window's finite
    contributors, as ``jnp.nanquantile`` computes it (sort with NaN
    last, the position ``q * (count - 1)`` in the window's dtype, its
    floor and ceiling values weighted). A sort, where
    ``torch.nanquantile`` refuses inputs past 2^24 elements; an empty
    window is NaN."""
    ws = torch.sort(win.masked_fill(~ok, np.nan), dim=-1).values
    counts = ok.sum(dim=-1, keepdim=True).to(win.dtype)
    pos = q * (counts - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    top = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, top))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, top))
    low_v = torch.gather(ws, -1, low.to(torch.int64))
    high_v = torch.gather(ws, -1, high.to(torch.int64))
    return (low_v * low_w + high_v * high_w)[..., 0]


def footprint_resample(values, idx_y, in_y, valid_y, idx_x, in_x,
                       valid_x, stat, cval, device=None):
    """Footprint resample: GDAL's order-statistic methods on the
    sample-center footprint model (separable warps only).

    Each destination pixel reduces its (span_y x span_x) contributor
    window with ``stat``, skipping non-finite contributors. An in-range
    window with no finite contributor yields NaN; an out-of-range
    destination yields ``cval``. ``med``/``q1``/``q3`` interpolate
    linearly; ``mode`` resolves ties to the smallest value. The plan
    tensors (``idx_*``, ``in_*``, ``valid_*``) lie on ``values``'
    device; arrays land there (and ``values`` on ``device``, default
    ``cuda``).
    """
    values = as_tensor(values, device)
    idx_y, in_y, valid_y, idx_x, in_x, valid_x = (
        as_tensor(a, values.device)
        for a in (idx_y, in_y, valid_y, idx_x, in_x, valid_x))
    V = values
    dt = V.dtype
    ny, sy = idx_y.shape
    nx, sx = idx_x.shape
    lead = tuple(V.shape[:-2])
    A = V.index_select(-2, idx_y.reshape(-1).to(torch.int64))
    A = A.reshape(lead + (ny, sy, V.shape[-1]))
    B = A.index_select(-1, idx_x.reshape(-1).to(torch.int64))
    B = B.reshape(lead + (ny, sy, nx, sx))
    win = B.movedim(-3, -2).reshape(lead + (ny, nx, sy * sx))
    mask = (in_y[:, None, :, None] & in_x[None, :, None, :]).reshape(
        ny, nx, sy * sx)
    ok = mask & torch.isfinite(win)
    empty = ~ok.any(dim=-1)
    if stat == 'mode':
        out = _masked_mode(win, ok)
    elif stat == 'min':
        out = win.masked_fill(~ok, np.inf).amin(dim=-1)
    elif stat == 'max':
        out = win.masked_fill(~ok, -np.inf).amax(dim=-1)
    elif stat == 'sum':
        out = win.masked_fill(~ok, 0).sum(dim=-1)
    elif stat == 'rms':
        cnt = ok.sum(dim=-1)
        sq = (win * win).masked_fill(~ok, 0).sum(dim=-1)
        out = torch.sqrt(sq / cnt.clamp(min=1).to(dt))
    elif stat in ('med', 'q1', 'q3'):
        q = {'med': 0.5, 'q1': 0.25, 'q3': 0.75}[stat]
        out = _masked_quantile(win, ok, q)
    else:
        raise ValueError('unknown footprint stat %r' % (stat,))
    out = out.masked_fill(empty, np.nan)
    in_range = valid_y[:, None] & valid_x[None, :]
    return out.masked_fill(~in_range, cval)


def grid_from_transforms(dst_transform, dst_shape, src_transform,
                         src_crs=None, dst_crs=None):
    """Fractional source-pixel coordinates (host float64 numpy) for
    every destination pixel.

    Corner-grid convention: the coordinate of pixel (row, col) is
    ``transform * (col, row)``. The CRS transform runs as float64 numpy
    math (``nd_tpu_torch.crs.transform_coords``), as the JAX package
    runs it for its warp grids on every backend.
    """
    from ..crs import Affine, transform_coords

    height, width = dst_shape
    jj = np.arange(width, dtype=np.float64)
    ii = np.arange(height, dtype=np.float64)
    J, I = np.meshgrid(jj, ii)
    X = dst_transform.a * J + dst_transform.b * I + dst_transform.c
    Y = dst_transform.d * J + dst_transform.e * I + dst_transform.f

    if src_crs is not None and dst_crs is not None and \
            not (src_crs == dst_crs):
        X, Y = transform_coords(dst_crs, src_crs, X, Y, xp=np)

    inv = ~src_transform if isinstance(src_transform, Affine) \
        else ~Affine(*src_transform)
    cols = inv.a * X + inv.b * Y + inv.c
    rows = inv.d * X + inv.e * Y + inv.f
    return rows, cols
