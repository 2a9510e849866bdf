"""Polygon rasterization on the grid's device.

Counterpart of ``nd_tpu/ops/rasterize.py``. A pixel belongs to a polygon
when its centre passes the even-odd crossing test over all of the
polygon's edges (holes excluded), in float64 with the JAX package's
arithmetic, one PyTorch op a step, so that no multiply-add is contracted
and a centre that sits on an edge falls on the same side.

The test runs only over the rows and columns of each polygon's bounding
box, which gives the whole grid's masks:

- a row outside the box has no edge that straddles it;
- a centre right of the box is never left of an edge's crossing;
- a centre left of the box is left of every crossing of its row, and a
  closed ring crosses a row an even number of times.

Points and lines are burned on the host (the cell that holds a point,
the cells along a line) and the mask moves to the grid's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import variable
from ..core.variable import to_numpy, torch_dtype

__all__ = ['polygon_mask', 'rasterize_values']

# bytes of the (rows, columns, edges) comparison a call may hold at once
_COMPARE_BYTES = 256 << 20


def _edges_of(geom):
    """Stack all rings of a Polygon/MultiPolygon into edge arrays."""
    from ..vector.geometry import MultiPolygon, Polygon
    rings = []
    if isinstance(geom, Polygon):
        rings = [geom.exterior.as_array()] + \
            [h.as_array() for h in geom.interiors]
    elif isinstance(geom, MultiPolygon):
        for g in geom.geoms:
            rings.append(g.exterior.as_array())
            rings.extend(h.as_array() for h in g.interiors)
    else:
        raise TypeError('cannot rasterize %r' % type(geom))
    p0 = np.concatenate([r[:-1] for r in rings], axis=0)
    p1 = np.concatenate([r[1:] for r in rings], axis=0)
    return p0, p1


def _cell_sizes(coords):
    """Per-axis cell size from (possibly descending) center coords."""
    c = np.asarray(coords, np.float64)
    return float(np.abs(np.diff(c)).mean()) if len(c) > 1 else 1.0


def _point_mask(px, py, xs, ys, device):
    """Mask of the cells whose center is nearest to each point —
    rasterio's point burning (the cell containing the point). Computed
    on the host, returned on ``device``."""
    xs_np = np.asarray(xs, np.float64)
    ys_np = np.asarray(ys, np.float64)
    dx = _cell_sizes(xs_np) / 2
    dy = _cell_sizes(ys_np) / 2
    mask = np.zeros((len(ys_np), len(xs_np)), bool)
    for x, y in zip(np.atleast_1d(px), np.atleast_1d(py)):
        j = int(np.argmin(np.abs(xs_np - x)))
        i = int(np.argmin(np.abs(ys_np - y)))
        if abs(xs_np[j] - x) <= dx + 1e-12 and \
                abs(ys_np[i] - y) <= dy + 1e-12:
            mask[i, j] = True
    return torch.from_numpy(mask).to(device)


def _line_mask(coords, xs, ys, device):
    """Cells touched by the polyline: sample each segment at sub-cell
    spacing and burn the containing cells (matches rasterio's
    all-touched-along-the-line behavior closely)."""
    xs_np = np.asarray(xs, np.float64)
    ys_np = np.asarray(ys, np.float64)
    step = min(_cell_sizes(xs_np), _cell_sizes(ys_np)) / 2
    a = np.asarray(coords, np.float64)
    pts = [a[:1]]
    for p0, p1 in zip(a[:-1], a[1:]):
        seg = np.hypot(*(p1 - p0))
        n = max(int(np.ceil(seg / max(step, 1e-12))), 1)
        t = np.linspace(0, 1, n + 1)[1:, None]
        pts.append(p0 + t * (p1 - p0))
    pts = np.concatenate(pts, axis=0)
    return _point_mask(pts[:, 0], pts[:, 1], xs, ys, device)


def _grid(xs, ys, device=None):
    """The grid's coordinates on the host (float64 numpy) and its device:
    that of ``xs`` where it is a tensor, else ``device`` (default
    ``cuda``)."""
    if isinstance(xs, torch.Tensor):
        device = xs.device
    elif device is None:
        device = variable.DEFAULT_DEVICE
    return (np.asarray(to_numpy(xs), np.float64),
            np.asarray(to_numpy(ys), np.float64), torch.device(device))


def _span(coords, lo, hi):
    """The slice from the first to the last index whose coordinate lies
    in [lo, hi], in the coordinates' own order (ascending or
    descending), or None."""
    hit = np.flatnonzero((coords >= lo) & (coords <= hi))
    if not len(hit):
        return None
    return slice(int(hit[0]), int(hit[-1]) + 1)


def _parity(X, Y, p0, p1):
    """Even-odd test of every centre (Y[i], X[j]) against the edges
    ``p0 -> p1`` (float64 tensors on one device): a bool (len(Y), len(X))
    tensor. The comparison is taken a block of rows and edges at a time;
    crossings are whole numbers, so the blocks' sum is exact."""
    device = X.device
    # a horizontal edge straddles no row
    keep = p0[:, 1] != p1[:, 1]
    p0, p1 = p0[keep], p1[keep]
    ny, nx = len(Y), len(X)
    count = torch.zeros((ny, nx), dtype=torch.int32, device=device)
    if not len(p0) or not ny or not nx:
        return count.bool()
    eb = int(max(1, min(len(p0), _COMPARE_BYTES // max(nx, 1))))
    rb = int(max(1, min(ny, _COMPARE_BYTES // (nx * eb))))
    Xb = X[None, :, None]
    edges = torch.as_tensor(np.concatenate([p0, p1], axis=1),
                            device=device)
    for e0 in range(0, len(p0), eb):
        x0, y0, x1, y1 = edges[e0:e0 + eb].T[:, None, None, :]
        # nd_tpu/ops/rasterize.py _block_crossings, one op a step
        denom = y1 - y0
        dx = x1 - x0
        for r0 in range(0, ny, rb):
            Yb = Y[r0:r0 + rb, None, None]
            cond = (y0 <= Yb) != (y1 <= Yb)
            xint = Yb - y0
            xint = xint / denom
            xint = xint * dx
            xint = x0 + xint
            count[r0:r0 + rb] += (cond & (Xb < xint)).sum(
                -1, dtype=torch.int32)
    return (count % 2) == 1


def _box_mask(geom, xs_np, ys_np, X, Y):
    """``(rows, cols, mask)``: the mask of ``geom`` over the window of
    the grid that can hold it, or None where no centre can be inside.
    A polygon's window is its bounding box, widened by the nearest
    centre on either side in x (a crossing may round past the box by
    an ulp); a point's or a line's is the whole grid."""
    from ..vector.geometry import LineString, Point
    if isinstance(geom, Point):
        return slice(None), slice(None), _point_mask(
            geom.x, geom.y, xs_np, ys_np, X.device)
    if isinstance(geom, LineString):
        return slice(None), slice(None), _line_mask(
            geom.coords, xs_np, ys_np, X.device)
    p0, p1 = _edges_of(geom)
    pts = np.concatenate([p0, p1])
    xmin, xmax = pts[:, 0].min(), pts[:, 0].max()
    left = xs_np[xs_np < xmin]
    right = xs_np[xs_np > xmax]
    rows = _span(ys_np, pts[:, 1].min(), pts[:, 1].max())
    cols = _span(xs_np, left.max() if len(left) else xmin,
                 right.min() if len(right) else xmax)
    if rows is None or cols is None:
        return None
    return rows, cols, _parity(X[cols], Y[rows], p0, p1)


def polygon_mask(geom, xs, ys, device=None):
    """Boolean (len(ys), len(xs)) mask of the cells covered by ``geom``:
    pixel-center containment (even-odd rule, holes excluded) for
    polygons; the containing cell for points; cells along the path for
    linestrings. On the device of ``xs`` where it is a tensor, else on
    ``device`` (default ``cuda``).
    """
    xs_np, ys_np, device = _grid(xs, ys, device)
    X = torch.as_tensor(xs_np, device=device)
    Y = torch.as_tensor(ys_np, device=device)
    mask = torch.zeros((len(ys_np), len(xs_np)), dtype=torch.bool,
                       device=device)
    box = _box_mask(geom, xs_np, ys_np, X, Y)
    if box is not None:
        mask[box[0], box[1]] = box[2]
    return mask


def _burn_dtype(values, fill):
    dtype = np.result_type(*(np.asarray(v).dtype for v in values)) \
        if values else np.float64
    try:
        fill_dt = np.min_scalar_type(fill)
    except (TypeError, ValueError):
        fill_dt = np.asarray(fill).dtype
    return np.promote_types(dtype, fill_dt)


def rasterize_values(geom_value_pairs, xs, ys, fill=0, dtype=None,
                     device=None):
    """Burn (geometry, value) pairs onto a grid, later pairs on top.

    Mirrors rasterio.features.rasterize semantics (last geometry wins).
    Accepts any iterable of pairs (materialized once, so generators
    work); with ``dtype=None`` the output dtype covers BOTH the burn
    values and ``fill`` (``fill=np.nan`` over integer values promotes
    to float instead of silently burning 0). Each polygon rewrites only
    its bounding box. The grid lies on the device of ``xs`` where it is
    a tensor, else on ``device`` (default ``cuda``).
    """
    pairs = list(geom_value_pairs)
    if dtype is None:
        dtype = _burn_dtype([v for _, v in pairs], fill)
    dtype = torch_dtype(dtype)
    xs_np, ys_np, device = _grid(xs, ys, device)
    X = torch.as_tensor(xs_np, device=device)
    Y = torch.as_tensor(ys_np, device=device)
    out = torch.full((len(ys_np), len(xs_np)), fill, dtype=dtype,
                     device=device)
    for geom, value in pairs:
        box = _box_mask(geom, xs_np, ys_np, X, Y)
        if box is None:
            continue
        rows, cols, mask = box
        burn = torch.as_tensor(np.asarray(value)).to(device=device,
                                                     dtype=dtype)
        out[rows, cols] = torch.where(mask, burn, out[rows, cols])
    return out
