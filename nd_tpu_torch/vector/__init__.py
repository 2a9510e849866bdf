"""Vector data: geometry types, file ingestion, rasterization.

Counterpart of ``nd_tpu/vector``. Only :func:`read_file`, :func:`to_file`
and :func:`rasterize` need pandas, and they import it themselves."""

from .geometry import (Point, LineString, Polygon, MultiPolygon, box,
                       shape, mapping, transform_geom)
from .shapefile import read_shapefile
from .vector import rasterize, read_file, to_file

__all__ = ['Point', 'LineString', 'Polygon', 'MultiPolygon', 'box',
           'shape', 'mapping', 'transform_geom', 'read_shapefile',
           'read_file', 'to_file', 'rasterize']
