"""Minimal planar geometry types (the subset of shapely the package
needs).

Counterpart of ``nd_tpu/vector/geometry.py``, kept as the port's own
numpy copy: Point / LineString / Polygon (with holes) / MultiPolygon with
bounds, function transforms, point containment (even-odd rule) and
intersection tests. Rasterization runs on the grid's device
(:mod:`nd_tpu_torch.ops.rasterize`).
"""

from __future__ import annotations

import numpy as np

__all__ = ['Point', 'LineString', 'Polygon', 'MultiPolygon', 'box',
           'shape', 'mapping', 'transform_geom']


class Geometry:
    geom_type = 'Geometry'

    @property
    def bounds(self):
        xs, ys = self._all_coords()
        return (float(np.min(xs)), float(np.min(ys)),
                float(np.max(xs)), float(np.max(ys)))

    def intersects_bounds(self, other_bounds):
        l1, b1, r1, t1 = self.bounds
        l2, b2, r2, t2 = other_bounds
        return not (r1 < l2 or r2 < l1 or t1 < b2 or t2 < b1)

    def intersects(self, other):
        """Bounding-box intersection test followed by exact test for
        polygon/point combinations."""
        if isinstance(other, Point):
            return self.contains(other)
        return self.intersects_bounds(other.bounds)


class Point(Geometry):
    geom_type = 'Point'

    def __init__(self, x, y):
        self.x = float(x)
        self.y = float(y)

    def _all_coords(self):
        return np.array([self.x]), np.array([self.y])

    @property
    def coords(self):
        return [(self.x, self.y)]

    def contains(self, pt):
        """Point containment: coincidence (within float rounding)."""
        return (abs(self.x - pt.x) <= 1e-12 * max(1.0, abs(self.x))
                and abs(self.y - pt.y) <= 1e-12 * max(1.0, abs(self.y)))

    def __repr__(self):
        return 'Point(%g, %g)' % (self.x, self.y)


class LineString(Geometry):
    geom_type = 'LineString'

    def __init__(self, coords):
        self.coords = [(float(x), float(y)) for x, y in coords]

    def _all_coords(self):
        a = np.asarray(self.coords)
        return a[:, 0], a[:, 1]

    def contains(self, pt):
        """True when the point lies on one of the segments (within
        float rounding) — the meaningful 'intersects' for a curve."""
        a = np.asarray(self.coords)
        p0, p1 = a[:-1], a[1:]
        d = p1 - p0
        v = np.array([pt.x, pt.y]) - p0
        seg_len2 = np.maximum((d ** 2).sum(axis=1), 1e-300)
        t = np.clip((v * d).sum(axis=1) / seg_len2, 0.0, 1.0)
        nearest = p0 + t[:, None] * d
        dist2 = ((np.array([pt.x, pt.y]) - nearest) ** 2).sum(axis=1)
        scale = max(1.0, abs(pt.x), abs(pt.y))
        return bool(np.any(dist2 <= (1e-9 * scale) ** 2))


class _Ring:
    def __init__(self, coords):
        coords = [(float(x), float(y)) for x, y in coords]
        if coords and coords[0] != coords[-1]:
            coords = coords + [coords[0]]
        self.coords = coords

    def as_array(self):
        return np.asarray(self.coords)


class Polygon(Geometry):
    geom_type = 'Polygon'

    def __init__(self, shell, holes=None):
        if isinstance(shell, Polygon):
            self.exterior = shell.exterior
            self.interiors = shell.interiors
            return
        self.exterior = _Ring(list(shell))
        self.interiors = [_Ring(list(h)) for h in (holes or [])]

    def _all_coords(self):
        a = self.exterior.as_array()
        return a[:, 0], a[:, 1]

    @property
    def area(self):
        def ring_area(ring):
            a = ring.as_array()
            x, y = a[:, 0], a[:, 1]
            return 0.5 * np.sum(x[:-1] * y[1:] - x[1:] * y[:-1])
        area = abs(ring_area(self.exterior))
        for h in self.interiors:
            area -= abs(ring_area(h))
        return float(area)

    @property
    def centroid(self):
        a = self.exterior.as_array()[:-1]
        return Point(a[:, 0].mean(), a[:, 1].mean())

    def contains(self, pt):
        """Even-odd rule point-in-polygon."""
        def in_ring(ring, x, y):
            a = ring.as_array()
            x0, y0 = a[:-1, 0], a[:-1, 1]
            x1, y1 = a[1:, 0], a[1:, 1]
            cond = (y0 <= y) != (y1 <= y)
            with np.errstate(divide='ignore', invalid='ignore'):
                xint = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
            crossings = np.sum(cond & (x < xint))
            return crossings % 2 == 1
        if not in_ring(self.exterior, pt.x, pt.y):
            return False
        for h in self.interiors:
            if in_ring(h, pt.x, pt.y):
                return False
        return True

    def intersects(self, other):
        if isinstance(other, Point):
            return self.contains(other)
        if not self.intersects_bounds(other.bounds):
            return False
        if isinstance(other, Polygon):
            # exact-enough test: any vertex containment either way, or
            # bbox overlap with edge crossing approximated by sampling
            for x, y in other.exterior.coords:
                if self.contains(Point(x, y)):
                    return True
            for x, y in self.exterior.coords:
                if other.contains(Point(x, y)):
                    return True
            # fall back: bounding boxes overlap but no vertex inside —
            # check edge intersections
            return _edges_cross(self.exterior.as_array(),
                                other.exterior.as_array())
        return True

    def __repr__(self):
        return 'Polygon(%d vertices)' % (len(self.exterior.coords) - 1)


def _edges_cross(a, b):
    """Any segment of ring a crosses any segment of ring b."""
    def ccw(ax, ay, bx, by, cx, cy):
        return (cy - ay) * (bx - ax) > (by - ay) * (cx - ax)

    for i in range(len(a) - 1):
        p1, p2 = a[i], a[i + 1]
        x1, y1 = p1
        x2, y2 = p2
        q1 = b[:-1]
        q2 = b[1:]
        d1 = ccw(x1, y1, x2, y2, q1[:, 0], q1[:, 1]) != \
            ccw(x1, y1, x2, y2, q2[:, 0], q2[:, 1])
        d2 = np.array([ccw(qx1, qy1, qx2, qy2, x1, y1)
                       != ccw(qx1, qy1, qx2, qy2, x2, y2)
                       for (qx1, qy1), (qx2, qy2) in zip(q1, q2)])
        if np.any(d1 & d2):
            return True
    return False


class MultiPolygon(Geometry):
    geom_type = 'MultiPolygon'

    def __init__(self, polygons):
        self.geoms = [p if isinstance(p, Polygon) else Polygon(*p)
                      for p in polygons]

    def _all_coords(self):
        xs = np.concatenate([g._all_coords()[0] for g in self.geoms])
        ys = np.concatenate([g._all_coords()[1] for g in self.geoms])
        return xs, ys

    def contains(self, pt):
        return any(g.contains(pt) for g in self.geoms)

    def intersects(self, other):
        return any(g.intersects(other) for g in self.geoms)

    @property
    def area(self):
        return sum(g.area for g in self.geoms)


def box(minx, miny, maxx, maxy):
    """Axis-aligned rectangle polygon (shapely.geometry.box parity)."""
    return Polygon([(maxx, miny), (maxx, maxy), (minx, maxy),
                    (minx, miny)])


def shape(obj):
    """Build a geometry from a GeoJSON-like mapping."""
    t = obj['type']
    c = obj['coordinates']
    if t == 'Point':
        return Point(*c[:2])
    if t == 'LineString':
        return LineString(c)
    if t == 'Polygon':
        return Polygon(c[0], c[1:])
    if t == 'MultiPolygon':
        return MultiPolygon([Polygon(p[0], p[1:]) for p in c])
    raise ValueError('unsupported geometry type %r' % t)


def mapping(geom):
    """GeoJSON-like mapping from a geometry."""
    if isinstance(geom, Point):
        return {'type': 'Point', 'coordinates': (geom.x, geom.y)}
    if isinstance(geom, LineString):
        return {'type': 'LineString', 'coordinates': list(geom.coords)}
    if isinstance(geom, Polygon):
        return {'type': 'Polygon',
                'coordinates': [list(geom.exterior.coords)]
                + [list(h.coords) for h in geom.interiors]}
    if isinstance(geom, MultiPolygon):
        return {'type': 'MultiPolygon',
                'coordinates': [mapping(g)['coordinates']
                                for g in geom.geoms]}
    raise ValueError(type(geom))


def transform_geom(func, geom):
    """Apply ``func(xs, ys) -> (xs, ys)`` to all coordinates
    (shapely.ops.transform parity)."""
    if isinstance(geom, Point):
        x, y = func(np.array([geom.x]), np.array([geom.y]))
        return Point(float(np.asarray(x)[0]), float(np.asarray(y)[0]))
    if isinstance(geom, LineString):
        a = np.asarray(geom.coords)
        x, y = func(a[:, 0], a[:, 1])
        return LineString(zip(np.asarray(x), np.asarray(y)))
    if isinstance(geom, Polygon):
        def tx(ring):
            a = ring.as_array()
            x, y = func(a[:, 0], a[:, 1])
            return list(zip(np.asarray(x), np.asarray(y)))
        return Polygon(tx(geom.exterior),
                       [tx(h) for h in geom.interiors])
    if isinstance(geom, MultiPolygon):
        return MultiPolygon([transform_geom(func, g)
                             for g in geom.geoms])
    raise ValueError(type(geom))
