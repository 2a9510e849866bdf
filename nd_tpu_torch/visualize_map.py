"""Dependency-free cartographic map rendering.

Counterpart of ``nd_tpu/visualize_map.py``. :func:`render_map` draws the
dataset's footprint on an orthographic globe view (shaded disk,
graticule with degree labels, footprint polygon, geodesic scale bar)
straight into an RGB raster with the port's own projection engine
(``crs/proj.py``'s ortho family), datum math (``crs.transform_coords``)
and geodesics (``crs/geodesic.py``), host numpy in float64; OpenCV draws
only the 2-d lines and text. ``visualize.plot_map`` dispatches here
whenever cartopy is unavailable. The pixels equal the JAX package's.
cv2 is optional: without it :func:`render_map` raises ImportError.
"""

from __future__ import annotations

import math
import warnings

import numpy as np

__all__ = ['render_map']

# palette (RGB)
_SPACE = (16, 18, 30)
_OCEAN = (74, 112, 160)
_GRAT = (235, 235, 240)
_FOOT_FILL = (255, 40, 40)
_FOOT_EDGE = (30, 10, 10)
_INK = (20, 20, 24)
_HALO = (250, 250, 250)


def _cv2():
    try:
        import cv2
    except ImportError:
        raise ImportError('render_map requires opencv-python (cv2)') \
            from None
    return cv2


def _nice_ticks(lo, hi, n=6):
    """Round tick values covering [lo, hi] at a 1/2/2.5/5 x 10^k step."""
    span = max(hi - lo, 1e-9)
    raw = span / max(n, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    for mult in (1.0, 2.0, 2.5, 5.0, 10.0):
        step = mult * mag
        if span / step <= n:
            break
    first = math.ceil(lo / step) * step
    ticks = np.arange(first, hi + step * 1e-6, step)
    return np.round(ticks, 9), step


def _deg_label(value, is_lon):
    hemi = ('E' if value >= 0 else 'W') if is_lon \
        else ('N' if value >= 0 else 'S')
    v = abs(value)
    txt = '%g' % v
    return '%s\xb0%s' % (txt, hemi)


class _Frame:
    """View window in orthographic metres <-> pixel coordinates."""

    def __init__(self, x0, x1, y0, y1, width, height):
        self.x0, self.x1, self.y0, self.y1 = x0, x1, y0, y1
        self.w, self.h = width, height

    def to_pix(self, x, y):
        px = (np.asarray(x) - self.x0) / (self.x1 - self.x0) \
            * (self.w - 1)
        py = (self.y1 - np.asarray(y)) / (self.y1 - self.y0) \
            * (self.h - 1)
        return px, py

    def to_xy(self, px, py):
        x = self.x0 + np.asarray(px) / (self.w - 1) * (self.x1 - self.x0)
        y = self.y1 - np.asarray(py) / (self.h - 1) * (self.y1 - self.y0)
        return x, y


def _visible_runs(px, py, w, h, margin=2.0):
    """Split a projected polyline into runs of finite, in-view points."""
    ok = np.isfinite(px) & np.isfinite(py) \
        & (px >= -margin * w) & (px <= (1 + margin) * w) \
        & (py >= -margin * h) & (py <= (1 + margin) * h)
    runs = []
    start = None
    for i, flag in enumerate(ok):
        if flag and start is None:
            start = i
        elif not flag and start is not None:
            if i - start >= 2:
                runs.append((start, i))
            start = None
    if start is not None and len(ok) - start >= 2:
        runs.append((start, len(ok)))
    return runs


def _polyline(img, px, py, color, thickness=1):
    cv2 = _cv2()
    for a, b in _visible_runs(px, py, img.shape[1], img.shape[0]):
        pts = np.stack([px[a:b], py[a:b]], axis=1)
        pts = np.round(pts).astype(np.int32).reshape(-1, 1, 2)
        cv2.polylines(img, [pts], False, color, thickness,
                      lineType=cv2.LINE_AA)


def _edge_crossing(px, py, w, h, edge):
    """First crossing of the polyline with a view edge, or None.

    ``edge``: 'bottom'/'top' (horizontal y = h-1 / 0) or
    'left'/'right' (vertical x = 0 / w-1). Returns (x, y) pixel coords.
    """
    if edge in ('bottom', 'top'):
        level = (h - 1.0) if edge == 'bottom' else 0.0
        coord, other = py, px
        lim = w - 1.0
    else:
        level = 0.0 if edge == 'left' else (w - 1.0)
        coord, other = px, py
        lim = h - 1.0
    ok = np.isfinite(coord) & np.isfinite(other)
    for i in range(len(coord) - 1):
        if not (ok[i] and ok[i + 1]):
            continue
        c0, c1 = coord[i] - level, coord[i + 1] - level
        if c0 == c1 or (c0 > 0) == (c1 > 0):
            continue
        t = c0 / (c0 - c1)
        at = other[i] + t * (other[i + 1] - other[i])
        if -1.0 <= at <= lim + 1.0:
            return (at, level) if edge in ('bottom', 'top') \
                else (level, at)
    return None


def _put_label(img, text, xy, anchor='center'):
    cv2 = _cv2()
    font = cv2.FONT_HERSHEY_SIMPLEX
    scale, weight = 0.42, 1
    (tw, th), _ = cv2.getTextSize(text, font, scale, weight)
    x, y = xy
    if anchor == 'center':
        org = (int(round(x - tw / 2)), int(round(y + th / 2)))
    elif anchor == 'above':
        org = (int(round(x - tw / 2)), int(round(y - 4)))
    elif anchor == 'below':
        org = (int(round(x - tw / 2)), int(round(y + th + 4)))
    elif anchor == 'left':
        org = (int(round(x - tw - 5)), int(round(y + th / 2)))
    else:  # 'right'
        org = (int(round(x + 5)), int(round(y + th / 2)))
    h, w = img.shape[:2]
    org = (int(np.clip(org[0], 2, w - tw - 2)),
           int(np.clip(org[1], th + 2, h - 3)))
    cv2.putText(img, text, org, font, scale, _HALO, weight + 2,
                cv2.LINE_AA)
    cv2.putText(img, text, org, font, scale, _INK, weight,
                cv2.LINE_AA)


def render_map(ds, buffer=None, shape=(720, 720), graticule=True,
               footprint=True, scalebar=True, output=None):
    """Render the dataset's footprint on an orthographic globe view
    centred on it, with a shaded globe background, a graticule labelled
    in degrees where each meridian/parallel meets the view edge, and a
    geodesic scale bar measured with the port's ellipsoidal geodesics.

    Parameters
    ----------
    ds : Dataset or DataArray
        Georeferenced input (CRS + coords, like ``warp.get_extent``).
    buffer : float, optional
        Extra margin around the footprint as a fraction of its size
        (default 0.2).
    shape : tuple of int, optional
        Output (height, width) in pixels.
    graticule, footprint, scalebar : bool, optional
        Toggle the individual cartographic elements.
    output : str, optional
        PNG path; when given the image is also written to disk.

    Returns
    -------
    np.ndarray of uint8, shape (height, width, 3) — the RGB map.
    """
    cv2 = _cv2()
    from . import warp
    from .crs.crs import CRS, transform_coords
    from .crs.geodesic import geodesic_inverse
    from .crs.proj import ELLIPSOIDS

    h, w = int(shape[0]), int(shape[1])
    extent = warp.get_extent(ds)
    lon0 = (extent.left + extent.right) / 2.0
    lat0 = (extent.bottom + extent.top) / 2.0
    ortho = CRS.from_user_input(
        '+proj=ortho +lat_0=%.9f +lon_0=%.9f +x_0=0 +y_0=0 '
        '+ellps=WGS84 +units=m +no_defs' % (lat0, lon0))
    wgs84 = CRS.from_epsg(4326)

    # footprint ring, densified so projected edges curve correctly
    geom = warp.get_geometry(ds)
    ring = np.asarray(geom.exterior.coords, float)
    dense = []
    for (ax, ay), (bx, by) in zip(ring[:-1], ring[1:]):
        t = np.linspace(0.0, 1.0, 25, endpoint=False)
        dense.append(np.stack([ax + t * (bx - ax),
                               ay + t * (by - ay)], axis=1))
    dense = np.concatenate(dense + [ring[-1:]], axis=0)
    fx, fy = transform_coords(wgs84, ortho, dense[:, 0], dense[:, 1],
                              xp=np)
    okf = np.isfinite(fx) & np.isfinite(fy)
    if not okf.any():
        raise ValueError('footprint is not on the visible hemisphere')

    factor = 1.2 if buffer is None else 1.0 + float(buffer)
    cx = (fx[okf].min() + fx[okf].max()) / 2.0
    cy = (fy[okf].min() + fy[okf].max()) / 2.0
    half = max(fx[okf].max() - fx[okf].min(),
               fy[okf].max() - fy[okf].min()) / 2.0 * factor
    half = max(half, 1e3)   # degenerate (single-pixel) footprints
    a = ELLIPSOIDS['WGS84'].a
    half = min(half, 1.35 * a)    # cap: whole disk + margin
    hx = half * (w / max(w, h))
    hy = half * (h / max(w, h))
    frame = _Frame(cx - hx, cx + hx, cy - hy, cy + hy, w, h)

    # ---- background: shaded globe disk over space --------------------
    img = np.empty((h, w, 3), np.uint8)
    gx, gy = frame.to_xy(np.arange(w, dtype=float)[None, :],
                         np.arange(h, dtype=float)[:, None])
    rho2 = (gx / a) ** 2 + (gy / a) ** 2
    on_disk = rho2 <= 1.0
    shade = 0.55 + 0.45 * np.sqrt(np.clip(1.0 - rho2, 0.0, 1.0))
    for c in range(3):
        img[..., c] = np.where(
            on_disk, (shade * _OCEAN[c]).astype(np.uint8), _SPACE[c])

    # lon/lat range of the visible view (sparse boundary inverse)
    bx = np.linspace(0, w - 1.0, 13)
    by = np.linspace(0, h - 1.0, 13)
    pts = np.concatenate([
        np.stack([bx, np.zeros_like(bx)], 1),
        np.stack([bx, np.full_like(bx, h - 1.0)], 1),
        np.stack([np.zeros_like(by), by], 1),
        np.stack([np.full_like(by, w - 1.0), by], 1),
        np.stack([np.full(1, (w - 1) / 2.0), np.full(1, (h - 1) / 2.0)],
                 1)])
    vx, vy = frame.to_xy(pts[:, 0], pts[:, 1])
    vlon, vlat = transform_coords(ortho, wgs84, vx, vy, xp=np)
    okv = np.isfinite(vlon) & np.isfinite(vlat)
    if okv.sum() >= 2 and not okv.all():
        # view extends past the limb: the whole hemisphere is in frame
        lon_lo, lon_hi, lat_lo, lat_hi = -180.0, 180.0, -90.0, 90.0
    elif okv.any():
        lon_lo, lon_hi = float(vlon[okv].min()), float(vlon[okv].max())
        lat_lo, lat_hi = float(vlat[okv].min()), float(vlat[okv].max())
    else:                      # pragma: no cover — frame off the globe
        lon_lo, lon_hi, lat_lo, lat_hi = -180.0, 180.0, -90.0, 90.0

    # ---- graticule ----------------------------------------------------
    if graticule:
        lon_ticks, _ = _nice_ticks(lon_lo, lon_hi)
        lat_ticks, _ = _nice_ticks(lat_lo, lat_hi)
        lat_samp = np.linspace(max(lat_lo, -89.99), min(lat_hi, 89.99),
                               181)
        lon_samp = np.linspace(lon_lo, lon_hi, 361)
        labels = []
        for lon in lon_ticks:
            mx, my = transform_coords(
                wgs84, ortho, np.full_like(lat_samp, lon), lat_samp,
                xp=np)
            px, py = frame.to_pix(mx, my)
            _polyline(img, px, py, _GRAT)
            hit = _edge_crossing(px, py, w, h, 'bottom') \
                or _edge_crossing(px, py, w, h, 'top')
            if hit is not None:
                anchor = 'above' if hit[1] > h / 2 else 'below'
                labels.append((_deg_label(lon, True), hit, anchor))
        for lat in lat_ticks:
            mx, my = transform_coords(
                wgs84, ortho, lon_samp, np.full_like(lon_samp, lat),
                xp=np)
            px, py = frame.to_pix(mx, my)
            _polyline(img, px, py, _GRAT)
            hit = _edge_crossing(px, py, w, h, 'left') \
                or _edge_crossing(px, py, w, h, 'right')
            if hit is not None:
                anchor = 'right' if hit[0] < w / 2 else 'left'
                labels.append((_deg_label(lat, False), hit, anchor))
        for text, xy, anchor in labels:
            _put_label(img, text, xy, anchor)

    # ---- footprint polygon --------------------------------------------
    if footprint:
        px, py = frame.to_pix(fx, fy)
        ok = np.isfinite(px) & np.isfinite(py)
        if ok.sum() >= 3:
            poly = np.round(np.stack([px[ok], py[ok]], 1)) \
                .astype(np.int32).reshape(-1, 1, 2)
            overlay = img.copy()
            cv2.fillPoly(overlay, [poly], _FOOT_FILL,
                         lineType=cv2.LINE_AA)
            img[:] = cv2.addWeighted(overlay, 0.28, img, 0.72, 0.0)
            cv2.polylines(img, [poly], True, _FOOT_EDGE, 1,
                          lineType=cv2.LINE_AA)
        else:                  # pragma: no cover
            warnings.warn('footprint not visible in the rendered view')

    # ---- geodesic scale bar ---------------------------------------------
    if scalebar:
        sx = 0.08 * (w - 1)
        sy = 0.92 * (h - 1)
        seg = 0.25 * (w - 1)
        (x0m, y0m) = frame.to_xy(sx, sy)
        (x1m, y1m) = frame.to_xy(sx + seg, sy)
        lon_a, lat_a = transform_coords(ortho, wgs84,
                                        np.array([x0m, x1m]),
                                        np.array([y0m, y1m]), xp=np)
        if np.all(np.isfinite(lon_a)) and np.all(np.isfinite(lat_a)):
            s, _, _ = geodesic_inverse(
                math.radians(lon_a[0]), math.radians(lat_a[0]),
                math.radians(lon_a[1]), math.radians(lat_a[1]),
                ELLIPSOIDS['WGS84'])
            span_km = float(s) / 1000.0
            mag = 10.0 ** math.floor(math.log10(max(span_km, 1e-9)))
            length_km = float(int(span_km / mag) * mag) or mag
            bar_px = seg * length_km / span_km
            y0i, x0i, x1i = int(round(sy)), int(round(sx)), \
                int(round(sx + bar_px))
            cv2.rectangle(img, (x0i, y0i - 2), (x1i, y0i + 2), _INK,
                          -1)
            cv2.rectangle(img, (x0i, y0i - 2), (x1i, y0i + 2), _HALO,
                          1)
            if length_km >= 1.0:
                label = '%g km' % length_km
            else:
                label = '%g m' % (length_km * 1000.0)
            _put_label(img, label, ((x0i + x1i) / 2.0, y0i - 12),
                       'center')

    if output is not None:
        cv2.imwrite(output, img[:, :, ::-1])
    return img
