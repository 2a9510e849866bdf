"""2-D affine transforms for raster georeferencing.

The port's own copy of ``nd_tpu/crs/affine.py`` (numpy only: importing
any module of ``nd_tpu`` imports JAX). A from-scratch replacement for
the ``affine`` package. The transform maps pixel (col, row) to world
(x, y):

    x = a*col + b*row + c
    y = d*col + e*row + f
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ['Affine']


class Affine:
    """An affine transform (a, b, c, d, e, f)."""

    __slots__ = ('a', 'b', 'c', 'd', 'e', 'f')
    precision = 1e-9

    def __init__(self, a, b, c, d, e, f):
        self.a = float(a)
        self.b = float(b)
        self.c = float(c)
        self.d = float(d)
        self.e = float(e)
        self.f = float(f)

    # -- constructors -------------------------------------------------------
    @classmethod
    def identity(cls):
        return cls(1, 0, 0, 0, 1, 0)

    @classmethod
    def translation(cls, xoff, yoff):
        return cls(1, 0, xoff, 0, 1, yoff)

    @classmethod
    def scale(cls, sx, sy=None):
        if sy is None:
            sy = sx
        return cls(sx, 0, 0, 0, sy, 0)

    @classmethod
    def rotation(cls, angle_deg):
        ca = math.cos(math.radians(angle_deg))
        sa = math.sin(math.radians(angle_deg))
        return cls(ca, -sa, 0, sa, ca, 0)

    @classmethod
    def from_gdal(cls, c, a, b, f, d, e):
        """From GDAL geotransform order (c, a, b, f, d, e)."""
        return cls(a, b, c, d, e, f)

    def to_gdal(self):
        return (self.c, self.a, self.b, self.f, self.d, self.e)

    # -- algebra ---------------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Affine):
            s, o = self, other
            return Affine(
                s.a * o.a + s.b * o.d,
                s.a * o.b + s.b * o.e,
                s.a * o.c + s.b * o.f + s.c,
                s.d * o.a + s.e * o.d,
                s.d * o.b + s.e * o.e,
                s.d * o.c + s.e * o.f + s.f,
            )
        # apply to point(s): other = (x, y) possibly arrays
        x, y = other
        x = np.asarray(x)
        y = np.asarray(y)
        nx = self.a * x + self.b * y + self.c
        ny = self.d * x + self.e * y + self.f
        if nx.ndim == 0:
            return (float(nx), float(ny))
        return (nx, ny)

    def __call__(self, x, y):
        return self * (x, y)

    def __invert__(self):
        det = self.determinant
        if abs(det) < 1e-300:
            raise ValueError('transform is degenerate')
        ia = self.e / det
        ib = -self.b / det
        id_ = -self.d / det
        ie = self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    @property
    def determinant(self):
        return self.a * self.e - self.b * self.d

    def almost_equals(self, other, precision=None):
        if precision is None:           # precision=0 means exact
            precision = self.precision
        return all(abs(getattr(self, k) - getattr(other, k)) <= precision
                   for k in self.__slots__)

    def __eq__(self, other):
        if not isinstance(other, Affine):
            return NotImplemented
        return self.almost_equals(other)

    # tolerance-based __eq__ cannot satisfy the hash contract (equal
    # transforms could hash differently); hash tuple(transform) instead
    __hash__ = None

    def __iter__(self):
        return iter((self.a, self.b, self.c, self.d, self.e, self.f))

    def __getitem__(self, i):
        return (self.a, self.b, self.c, self.d, self.e, self.f,
                0.0, 0.0, 1.0)[i]

    @property
    def xoff(self):
        return self.c

    @property
    def yoff(self):
        return self.f

    def __repr__(self):
        return ('Affine(%.6g, %.6g, %.6g,\n       %.6g, %.6g, %.6g)'
                % (self.a, self.b, self.c, self.d, self.e, self.f))
