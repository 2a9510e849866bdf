"""ESRI Shapefile (+dBASE) reader with struct and numpy only.

Counterpart of ``nd_tpu/vector/shapefile.py``: Point, PolyLine and
Polygon records (with their Z/M variants); attributes from the ``.dbf``
sidecar (unset dates read as ``None``), the CRS from ``.prj`` (WKT) when
present.
"""

from __future__ import annotations

import datetime
import os
import struct

import numpy as np

from .geometry import LineString, MultiPolygon, Point, Polygon

__all__ = ['read_shapefile']

_SHAPE_POINT = {1, 11, 21}
_SHAPE_POLYLINE = {3, 13, 23}
_SHAPE_POLYGON = {5, 15, 25}


def _ring_is_clockwise(coords):
    a = np.asarray(coords)
    x, y = a[:, 0], a[:, 1]
    return np.sum((x[1:] - x[:-1]) * (y[1:] + y[:-1])) > 0


def _read_shp(path):
    with open(path, 'rb') as fh:
        data = fh.read()
    file_len = struct.unpack('>i', data[24:28])[0] * 2
    geoms = []
    off = 100
    while off < file_len:
        _, content_len = struct.unpack('>ii', data[off:off + 8])
        rec = data[off + 8: off + 8 + content_len * 2]
        off += 8 + content_len * 2
        shape_type = struct.unpack('<i', rec[:4])[0]
        if shape_type == 0:
            geoms.append(None)
        elif shape_type in _SHAPE_POINT:
            x, y = struct.unpack('<2d', rec[4:20])
            geoms.append(Point(x, y))
        elif shape_type in (_SHAPE_POLYLINE | _SHAPE_POLYGON):
            num_parts, num_points = struct.unpack('<2i', rec[36:44])
            parts = struct.unpack('<%di' % num_parts,
                                  rec[44:44 + 4 * num_parts])
            pts_off = 44 + 4 * num_parts
            pts = np.frombuffer(rec, dtype='<f8',
                                count=num_points * 2,
                                offset=pts_off).reshape(-1, 2)
            rings = []
            for i, start in enumerate(parts):
                stop = parts[i + 1] if i + 1 < num_parts else num_points
                rings.append(pts[start:stop])
            if shape_type in _SHAPE_POLYLINE:
                geoms.append(LineString(rings[0]) if len(rings) == 1
                             else LineString(np.vstack(rings)))
            else:
                # outer rings are clockwise, holes counter-clockwise
                polys = []
                current = None
                for ring in rings:
                    if _ring_is_clockwise(ring) or current is None:
                        if current is not None:
                            polys.append(current)
                        current = [ring, []]
                    else:
                        current[1].append(ring)
                if current is not None:
                    polys.append(current)
                if len(polys) == 1:
                    geoms.append(Polygon(polys[0][0], polys[0][1]))
                else:
                    geoms.append(MultiPolygon(
                        [Polygon(p[0], p[1]) for p in polys]))
        else:
            raise IOError('unsupported shape type %d' % shape_type)
    return geoms


def _read_dbf(path):
    with open(path, 'rb') as fh:
        data = fh.read()
    n_records = struct.unpack('<i', data[4:8])[0]
    header_size, record_size = struct.unpack('<2h', data[8:12])
    fields = []
    off = 32
    while data[off] != 0x0D:
        name = data[off:off + 11].split(b'\0')[0].decode('ascii')
        ftype = chr(data[off + 11])
        length = data[off + 16]
        decimals = data[off + 17]
        fields.append((name, ftype, length, decimals))
        off += 32

    records = []
    off = header_size
    for _ in range(n_records):
        rec = data[off:off + record_size]
        off += record_size
        if rec[:1] == b'*':
            # soft-deleted: placeholder keeps alignment with the .shp
            # geometry list (skipping would misattribute every
            # subsequent feature)
            records.append(None)
            continue
        pos = 1
        row = {}
        for name, ftype, length, decimals in fields:
            raw = rec[pos:pos + length]
            pos += length
            text = raw.decode('latin-1').strip()
            if ftype in ('N', 'F'):
                if text == '':
                    row[name] = np.nan
                elif decimals or ('.' in text):
                    row[name] = float(text)
                else:
                    try:
                        row[name] = int(text)
                    except ValueError:
                        row[name] = np.nan
            elif ftype == 'D':
                # unset date fields (all spaces) -> None, like fiona
                try:
                    row[name] = datetime.date(int(text[:4]),
                                              int(text[4:6]),
                                              int(text[6:8])) \
                        if len(text) == 8 else None
                except ValueError:
                    row[name] = None
            elif ftype == 'L':
                # '?'/' ' means uninitialized in DBF; '' would otherwise
                # test True via substring containment
                row[name] = bool(text) and text[0] in 'YyTt'
            else:
                row[name] = text
        records.append(row)
    return records


def read_shapefile(path):
    """Read a shapefile into (geometries, records, crs_wkt)."""
    base = os.path.splitext(path)[0]
    geoms = _read_shp(base + '.shp')
    records = _read_dbf(base + '.dbf') if os.path.exists(base + '.dbf') \
        else [{} for _ in geoms]   # distinct dicts: no shared aliasing
    crs_wkt = None
    if os.path.exists(base + '.prj'):
        with open(base + '.prj') as fh:
            crs_wkt = fh.read().strip()
    return geoms, records, crs_wkt
