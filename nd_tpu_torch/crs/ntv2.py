"""NTv2 grid-shift datum transformations (``+nadgrids=file.gsb``).

The port's own copy of ``nd_tpu/crs/ntv2.py`` (numpy only). GDAL/PROJ
reach sub-metre datum accuracy for grids like OSGB36/NAD27 through
their NTv2 support (any PROJ string, including ``+nadgrids=``). This
module implements the NTv2 binary
format (the Canadian "National Transformation v2" layout used by
.gsb files worldwide) from the published record structure:

* an 11-record overview header (``NUM_OREC``/``NUM_SREC``/
  ``NUM_FILE``/``GS_TYPE``/...), 16 bytes per record — an 8-byte
  ASCII name plus an 8-byte value (int32+pad, double, or 8 chars);
* per subgrid an 11-record header (``SUB_NAME``/``PARENT``/
  ``S_LAT``/``N_LAT``/``E_LONG``/``W_LONG``/``LAT_INC``/
  ``LONG_INC``/``GS_COUNT``) with all angles in arc-seconds and
  longitudes POSITIVE WEST (the NTv2 convention);
* ``GS_COUNT`` nodes of four float32s (latitude shift, longitude
  shift — both arc-seconds, longitude positive west — and two
  accuracy fields), ordered south-to-north by row and east-to-west
  within a row.

Shifts are bilinearly interpolated; nested subgrids resolve to the
densest grid containing each point (child grids refine their
parent). The inverse direction iterates the forward shift to
convergence, like PROJ. Points outside every subgrid pass through
unshifted.

Endianness is detected from ``NUM_OREC`` (always 11).
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache

import numpy as np

__all__ = ['NTv2File', 'read_gsb', 'open_gsb']


def _records(buf, offset, count):
    """Yield ``count`` (name, raw8) record pairs from ``buf``."""
    for i in range(count):
        base = offset + 16 * i
        name = buf[base:base + 8].decode('ascii', 'replace').strip()
        yield name, buf[base + 8:base + 16]
    return


def _as_int(raw, bo):
    return struct.unpack(bo + 'i', raw[:4])[0]


def _as_double(raw, bo):
    return struct.unpack(bo + 'd', raw)[0]


class SubGrid:
    """One NTv2 subgrid: extent in positive-west arc-seconds plus the
    (nrows, ncols, 2) shift field [lat, lon] in arc-seconds."""

    def __init__(self, name, parent, s_lat, n_lat, e_lon, w_lon,
                 lat_inc, lon_inc, shifts):
        self.name = name
        self.parent = parent
        self.s_lat, self.n_lat = s_lat, n_lat
        self.e_lon, self.w_lon = e_lon, w_lon
        self.lat_inc, self.lon_inc = lat_inc, lon_inc
        self.shifts = shifts          # (nrows, ncols, 2) f64 arcsec

    def contains(self, lon_w_sec, lat_sec, xp=np):
        return ((lat_sec >= self.s_lat) & (lat_sec <= self.n_lat)
                & (lon_w_sec >= self.e_lon)
                & (lon_w_sec <= self.w_lon))

    def interpolate(self, lon_w_sec, lat_sec, xp=np):
        """Bilinear (dlat_sec, dlon_w_sec) at positive-west arc-second
        coordinates. Queries are clamped to the grid (callers mask
        with :meth:`contains`)."""
        nrows, ncols = self.shifts.shape[:2]
        col = (lon_w_sec - self.e_lon) / self.lon_inc
        row = (lat_sec - self.s_lat) / self.lat_inc
        col = xp.clip(col, 0.0, ncols - 1.0)
        row = xp.clip(row, 0.0, nrows - 1.0)
        c0 = xp.clip(xp.floor(col).astype(int), 0, ncols - 2) \
            if ncols > 1 else xp.zeros_like(col, dtype=int)
        r0 = xp.clip(xp.floor(row).astype(int), 0, nrows - 2) \
            if nrows > 1 else xp.zeros_like(row, dtype=int)
        fc = col - c0
        fr = row - r0
        g = xp.asarray(self.shifts)
        c1 = xp.minimum(c0 + 1, ncols - 1)
        r1 = xp.minimum(r0 + 1, nrows - 1)
        v00 = g[r0, c0]
        v01 = g[r0, c1]
        v10 = g[r1, c0]
        v11 = g[r1, c1]
        fr = fr[..., None]
        fc = fc[..., None]
        out = (v00 * (1 - fr) * (1 - fc) + v01 * (1 - fr) * fc
               + v10 * fr * (1 - fc) + v11 * fr * fc)
        return out[..., 0], out[..., 1]


class NTv2File:
    """A parsed .gsb file: subgrids + vectorized shift application."""

    def __init__(self, grids, meta):
        self.grids = grids
        self.meta = meta

    def shift(self, lon, lat, xp=np):
        """(dlon_deg, dlat_deg) at east-positive degrees — the
        source-datum -> target-datum correction, densest covering
        subgrid per point, zero outside coverage."""
        lon = xp.asarray(lon, dtype=xp.float64) \
            if xp is np else xp.asarray(lon)
        lat = xp.asarray(lat, dtype=xp.float64) \
            if xp is np else xp.asarray(lat)
        lon_w = -lon * 3600.0
        lat_s = lat * 3600.0
        dlat = xp.zeros_like(lat_s)
        dlon_w = xp.zeros_like(lon_w)
        chosen_inc = xp.full_like(lat_s, np.inf)
        for g in self.grids:
            inside = g.contains(lon_w, lat_s, xp=xp)
            denser = g.lat_inc * g.lon_inc < chosen_inc
            take = inside & denser
            glat, glon = g.interpolate(lon_w, lat_s, xp=xp)
            dlat = xp.where(take, glat, dlat)
            dlon_w = xp.where(take, glon, dlon_w)
            chosen_inc = xp.where(
                take, g.lat_inc * g.lon_inc, chosen_inc)
        # positive-west shift -> east-positive degrees
        return -dlon_w / 3600.0, dlat / 3600.0

    def forward(self, lon, lat, xp=np):
        """Source datum -> target datum (what the grid encodes)."""
        dlon, dlat = self.shift(lon, lat, xp=xp)
        return lon + dlon, lat + dlat

    def inverse(self, lon, lat, xp=np, iterations=4):
        """Target datum -> source datum: fixed-point iteration of the
        forward shift (PROJ's method; the field is smooth, so a few
        iterations reach ~1e-12 deg)."""
        src_lon = xp.asarray(lon) + 0.0
        src_lat = xp.asarray(lat) + 0.0
        for _ in range(iterations):
            dlon, dlat = self.shift(src_lon, src_lat, xp=xp)
            src_lon = lon - dlon
            src_lat = lat - dlat
        return src_lon, src_lat


def read_gsb(path_or_bytes):
    """Parse an NTv2 .gsb file (path or raw bytes) -> :class:`NTv2File`."""
    if isinstance(path_or_bytes, bytes):
        buf = path_or_bytes
    else:
        with open(path_or_bytes, 'rb') as f:
            buf = f.read()
    if len(buf) < 11 * 16:
        raise ValueError('not an NTv2 file: too short')
    name0 = buf[0:8].decode('ascii', 'replace').strip()
    if name0 != 'NUM_OREC':
        raise ValueError('not an NTv2 file: first record is %r, '
                         'expected NUM_OREC' % name0)
    # endianness: NUM_OREC is always 11
    bo = '<' if struct.unpack('<i', buf[8:12])[0] == 11 else '>'
    if struct.unpack(bo + 'i', buf[8:12])[0] != 11:
        raise ValueError('not an NTv2 file: NUM_OREC != 11 in either '
                         'byte order')
    meta = {}
    for name, raw in _records(buf, 0, 11):
        if name in ('NUM_OREC', 'NUM_SREC', 'NUM_FILE'):
            meta[name] = _as_int(raw, bo)
        elif name in ('MAJOR_F', 'MINOR_F', 'MAJOR_T', 'MINOR_T'):
            meta[name] = _as_double(raw, bo)
        else:
            meta[name] = raw.decode('ascii', 'replace').strip()
    if meta.get('GS_TYPE', 'SECONDS') != 'SECONDS':
        raise NotImplementedError(
            'NTv2 GS_TYPE %r unsupported (only SECONDS grids '
            'exist in practice)' % meta.get('GS_TYPE'))
    n_sub = meta.get('NUM_FILE', 1)
    offset = 11 * 16
    grids = []
    for _ in range(n_sub):
        hdr = {}
        for name, raw in _records(buf, offset, 11):
            if name == 'GS_COUNT':
                hdr[name] = _as_int(raw, bo)
            elif name in ('S_LAT', 'N_LAT', 'E_LONG', 'W_LONG',
                          'LAT_INC', 'LONG_INC'):
                hdr[name] = _as_double(raw, bo)
            else:
                hdr[name] = raw.decode('ascii', 'replace').strip()
        offset += 11 * 16
        count = hdr['GS_COUNT']
        ncols = int(round((hdr['W_LONG'] - hdr['E_LONG'])
                          / hdr['LONG_INC'])) + 1
        nrows = int(round((hdr['N_LAT'] - hdr['S_LAT'])
                          / hdr['LAT_INC'])) + 1
        if nrows * ncols != count:
            raise ValueError(
                'NTv2 subgrid %r: GS_COUNT %d does not match the '
                '%dx%d extent' % (hdr.get('SUB_NAME'), count, nrows,
                                  ncols))
        nodes = np.frombuffer(buf, dtype=bo + 'f4',
                              count=count * 4, offset=offset)
        offset += count * 16
        shifts = nodes.reshape(nrows, ncols, 4)[..., :2] \
            .astype(np.float64)
        # rows run south->north; columns run east->west in the file
        # (increasing positive-west longitude), which IS increasing
        # lon_w — no flip needed for (row, col) = (lat, lon_w) indexing
        grids.append(SubGrid(
            hdr.get('SUB_NAME', ''), hdr.get('PARENT', ''),
            hdr['S_LAT'], hdr['N_LAT'], hdr['E_LONG'], hdr['W_LONG'],
            hdr['LAT_INC'], hdr['LONG_INC'], shifts.copy()))
    return NTv2File(grids, meta)


@lru_cache(maxsize=16)
def _open_cached(path, mtime):
    return read_gsb(path)


def open_gsb(path):
    """Parse-once cached reader (keyed on path + mtime)."""
    return _open_cached(os.path.abspath(path),
                        os.path.getmtime(path))
