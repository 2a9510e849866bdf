"""ENVI raster reader (SNAP's BEAM-DIMAP band format), from scratch:
the port's own copy of ``nd_tpu/io/envi.py``.

The format is a plain binary cube with a text ``.hdr`` sidecar, so it is
parsed directly and the payload memory-mapped. :meth:`EnviRaster.read`
returns numpy in the file's byte order.
"""

from __future__ import annotations

import os
import re

import numpy as np

__all__ = ['read_envi_header', 'read_envi', 'EnviRaster']

_DTYPE = {
    1: np.uint8, 2: np.int16, 3: np.int32, 4: np.float32, 5: np.float64,
    6: np.complex64, 9: np.complex128, 12: np.uint16, 13: np.uint32,
    14: np.int64, 15: np.uint64,
}


def read_envi_header(path):
    """Parse an ENVI .hdr file into a dict."""
    with open(path, encoding='latin-1') as fh:
        text = fh.read()
    if not text.lstrip().upper().startswith('ENVI'):
        raise IOError('%s is not an ENVI header' % path)
    # join multi-line { ... } values
    entries = re.findall(
        r'([\w ]+?)\s*=\s*(\{[^}]*\}|[^\n]*)', text)
    hdr = {}
    for k, v in entries:
        k = k.strip().lower()
        v = v.strip()
        if v.startswith('{'):
            v = v[1:-1].strip()
        hdr[k] = v
    return hdr


class EnviRaster:
    """An opened ENVI raster with lazily mapped data."""

    def __init__(self, path):
        base, ext = os.path.splitext(path)
        if ext.lower() in ('.hdr',):
            hdr_path = path
            img_path = base + '.img'
        else:
            img_path = path
            hdr_path = base + '.hdr'
            if not os.path.exists(hdr_path):
                hdr_path = path + '.hdr'
        hdr = read_envi_header(hdr_path)
        self.header = hdr
        self.samples = int(hdr['samples'])
        self.lines = int(hdr['lines'])
        self.bands = int(hdr.get('bands', 1))
        self.interleave = hdr.get('interleave', 'bsq').lower()
        self.offset = int(hdr.get('header offset', 0))
        dtype = _DTYPE[int(hdr['data type'])]
        byte_order = int(hdr.get('byte order', 0))
        self.dtype = np.dtype(dtype).newbyteorder(
            '>' if byte_order == 1 else '<')
        self.band_names = [b.strip() for b in
                           hdr.get('band names', '').split(',') if b.strip()]
        self._img_path = img_path
        # geolocation from "map info"
        self.transform = None
        self.crs_wkt = hdr.get('coordinate system string')
        mi = hdr.get('map info')
        if mi:
            parts = [p.strip() for p in mi.split(',')]
            try:
                ref_x, ref_y = float(parts[1]), float(parts[2])
                east, north = float(parts[3]), float(parts[4])
                sx, sy = float(parts[5]), float(parts[6])
                from ..crs import Affine
                # map info references pixel (ref_x, ref_y) in 1-based
                # pixel coordinates at (east, north)
                c = east - (ref_x - 1) * sx
                f = north + (ref_y - 1) * sy
                self.transform = Affine(sx, 0, c, 0, -sy, f)
            except (ValueError, IndexError):
                pass

    def read(self, band=None):
        """Read one band (1-based) or all bands as (bands, y, x)."""
        count = self.samples * self.lines * self.bands
        mm = np.memmap(self._img_path, dtype=self.dtype, mode='r',
                       offset=self.offset, shape=(count,))
        il = self.interleave
        if il == 'bsq':
            cube = mm.reshape(self.bands, self.lines, self.samples)
        elif il == 'bil':
            cube = mm.reshape(self.lines, self.bands,
                              self.samples).transpose(1, 0, 2)
        elif il == 'bip':
            cube = mm.reshape(self.lines, self.samples,
                              self.bands).transpose(2, 0, 1)
        else:
            raise IOError('unknown interleave %r' % il)
        if band is not None:
            return np.ascontiguousarray(cube[band - 1])
        return np.ascontiguousarray(cube)


def read_envi(path, band=None):
    return EnviRaster(path).read(band)
