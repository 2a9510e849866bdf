"""From-scratch CRS / affine / projection library (no GDAL, no PROJ):
the port's own numpy copy of ``nd_tpu/crs``."""

from .affine import Affine
from .crs import CRS, transform_coords
from .geodesic import geodesic_direct, geodesic_inverse
from .proj import Ellipsoid, ELLIPSOIDS

__all__ = ['Affine', 'CRS', 'transform_coords', 'Ellipsoid',
           'ELLIPSOIDS', 'geodesic_inverse', 'geodesic_direct']
