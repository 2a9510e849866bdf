"""GeoTIFF reader and writer, from scratch (no GDAL, no libtiff): the
port's own copy of ``nd_tpu/io/geotiff.py``, with its codecs (LZW,
PackBits, Deflate, the floating-point predictor) and overviews.

Covers the subset of TIFF 6.0 + GeoTIFF used by Earth-observation
rasters: both byte orders, strip and tile layouts, contiguous and planar
sample organization, uncompressed / Deflate / PackBits / LZW compression,
unsigned/signed/float/complex samples, GeoKey CRS resolution and
ModelPixelScale / ModelTiepoint / ModelTransformation georeferencing.

It works on numpy arrays on the host; :func:`nd_tpu_torch.io.open_rasterio`
puts the result on the device. ``zstandard`` (ZSTD) and ``cv2`` (JPEG)
are imported where they are used and are optional.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..crs import Affine, CRS

__all__ = ['TiffFile', 'read_geotiff']

_TAG_TYPES = {
    1: ('B', 1), 2: ('c', 1), 3: ('H', 2), 4: ('I', 4), 5: ('II', 8),
    6: ('b', 1), 7: ('B', 1), 8: ('h', 2), 9: ('i', 4), 10: ('ii', 8),
    11: ('f', 4), 12: ('d', 8), 16: ('Q', 8), 17: ('q', 8), 13: ('I', 4),
}


def _lzw_decode(data):
    """TIFF-variant LZW decoder (MSB-first, early change)."""
    result = bytearray()
    CLEAR, EOI = 256, 257
    dictionary = {}
    next_code = 258
    code_size = 9
    prev = None
    buf = 0
    nbits = 0
    pos = 0
    n = len(data)

    def reset():
        nonlocal dictionary, next_code, code_size, prev
        dictionary = {i: bytes([i]) for i in range(256)}
        next_code = 258
        code_size = 9
        prev = None

    reset()
    while pos < n or nbits >= code_size:
        while nbits < code_size and pos < n:
            buf = (buf << 8) | data[pos]
            pos += 1
            nbits += 8
        if nbits < code_size:
            break
        code = (buf >> (nbits - code_size)) & ((1 << code_size) - 1)
        nbits -= code_size
        if code == CLEAR:
            reset()
            continue
        if code == EOI:
            break
        if prev is None:
            entry = dictionary[code]
        elif code in dictionary:
            entry = dictionary[code]
            dictionary[next_code] = prev + entry[:1]
            next_code += 1
        else:
            entry = prev + prev[:1]
            dictionary[next_code] = entry
            next_code += 1
        result += entry
        prev = entry
        if next_code >= (1 << code_size) - 1 and code_size < 12:
            code_size += 1
    return bytes(result)


def _packbits_decode(data):
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _lzw_encode(data):
    """TIFF-variant LZW encoder (MSB-first, early code-width change).

    Inverse of :func:`_lzw_decode`; the width-change timing (grow when
    the writer's next free code reaches ``1 << code_size``, which is one
    entry ahead of the reader's table) is verified against Pillow's
    libtiff decoder in the test suite.
    """
    CLEAR, EOI = 256, 257
    out = bytearray()
    buf = 0
    nbits = 0

    def emit(code, size):
        nonlocal buf, nbits
        buf = (buf << size) | code
        nbits += size
        while nbits >= 8:
            out.append((buf >> (nbits - 8)) & 0xFF)
            nbits -= 8

    table = {bytes([i]): i for i in range(256)}
    next_code = 258
    code_size = 9
    emit(CLEAR, code_size)
    w = b''
    for byte in data:
        c = bytes([byte])
        wc = w + c
        if wc in table:
            w = wc
            continue
        emit(table[w], code_size)
        table[wc] = next_code
        next_code += 1
        if next_code >= (1 << code_size):
            if code_size < 12:
                code_size += 1
            elif next_code >= 4095:
                # table full: flush and restart the dictionary
                emit(CLEAR, code_size)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                code_size = 9
        w = c
    if w:
        emit(table[w], code_size)
    emit(EOI, code_size)
    if nbits:
        out.append((buf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _packbits_encode(data, row_bytes):
    """PackBits (RLE) encoder, packing each scanline separately as the
    TIFF spec requires (decoders that track row boundaries depend on
    it; ours and libtiff's both accept the stream)."""
    out = bytearray()
    for start in range(0, len(data), row_bytes):
        row = data[start:start + row_bytes]
        i = 0
        n = len(row)
        while i < n:
            run = 1
            while i + run < n and row[i + run] == row[i] and run < 128:
                run += 1
            if run >= 2:
                out.append(257 - run)
                out.append(row[i])
                i += run
                continue
            j = i + 1
            while j < n and j - i < 128:
                if j + 2 < n and row[j] == row[j + 1] == row[j + 2]:
                    break
                j += 1
            out.append(j - i - 1)
            out += row[i:j]
            i = j
    return bytes(out)


def _normalize_codec(compress):
    """Resolve a user ``compress=`` value to ``(tiff_tag_value, encoder)``.

    Accepts ``True`` (Deflate, the historical default), ``False``/``None``
    (uncompressed) or a codec name: ``'deflate'``/``'zlib'``, ``'lzw'``,
    ``'packbits'``, ``'zstd'``, ``'none'``. The encoder takes
    ``(raw_bytes, row_bytes)``.
    """
    if compress is True:
        name = 'deflate'
    elif compress is False or compress is None:
        name = 'none'
    else:
        name = str(compress).lower()
    if name in ('none', 'raw'):
        return 1, None
    if name in ('deflate', 'zlib', 'adobe_deflate'):
        return 8, lambda raw, rb: zlib.compress(raw, 6)
    if name == 'lzw':
        return 5, lambda raw, rb: _lzw_encode(raw)
    if name == 'packbits':
        return 32773, lambda raw, rb: _packbits_encode(raw, rb)
    if name == 'zstd':
        try:
            import zstandard
        except ImportError:
            raise IOError(
                'writing ZSTD-compressed TIFF needs the zstandard '
                'module (not installed); use compress="deflate"')
        comp = zstandard.ZstdCompressor(level=3)
        return 50000, lambda raw, rb: comp.compress(raw)
    raise ValueError(
        'unsupported TIFF compression %r (choose deflate/lzw/packbits/'
        'zstd/none)' % (compress,))


def _decompress(data, compression):
    if compression == 1:
        return data
    if compression in (8, 32946):
        return zlib.decompress(data)
    if compression == 5:
        return _lzw_decode(data)
    if compression == 32773:
        return _packbits_decode(data)
    if compression == 50000:                     # ZSTD (registered)
        try:
            import zstandard
        except ImportError:
            raise IOError(
                'ZSTD-compressed TIFF needs the zstandard module '
                '(not installed); re-export the raster with DEFLATE '
                'or install zstandard')
        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=1 << 31)
    raise IOError('unsupported TIFF compression %d' % compression)


def _jpeg_decode(data, tables):
    """Decode one JPEG-compressed strip/tile via OpenCV, splicing the
    shared JPEGTables stream (tag 347, new-style JPEG) in front."""
    try:
        import cv2
    except ImportError:
        raise IOError('JPEG-compressed TIFF needs OpenCV (cv2), '
                      'which is not installed')
    if tables:
        body = bytes(tables)
        if body[-2:] == b'\xff\xd9':            # strip the tables EOI
            body = body[:-2]
        if data[:2] == b'\xff\xd8':             # splice after the SOI
            data = body + bytes(data[2:])
    arr = cv2.imdecode(np.frombuffer(bytes(data), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    if arr is None:
        raise IOError('failed to decode JPEG strip/tile')
    if arr.ndim == 3:
        arr = arr[:, :, ::-1]                   # OpenCV is BGR
    return arr


def _fp_predictor_decode(raw, rows, n_values, itemsize, stride):
    """TIFF predictor 3 (floating-point byte shuffling+differencing):
    each row stores its values' bytes plane-major (all MSBs first,
    big-endian) with byte-wise horizontal differencing at the sample
    stride. Returns big-endian value bytes."""
    n_bytes = n_values * itemsize
    b = np.frombuffer(raw, np.uint8)[:rows * n_bytes] \
        .reshape(rows, n_bytes).copy()
    if stride == 1:
        np.cumsum(b, axis=1, dtype=np.uint8, out=b)
    else:
        g = b.reshape(rows, n_bytes // stride, stride)
        np.cumsum(g, axis=1, dtype=np.uint8, out=g)
    planes = b.reshape(rows, itemsize, n_values)
    return np.ascontiguousarray(
        np.transpose(planes, (0, 2, 1))).tobytes()


def _sample_dtype(fmt, bits, bo):
    if fmt == 5:
        # complex-integer (CInt16/CInt32 SLC products): decoding the
        # int pairs as one integer would be silent corruption
        raise IOError('complex-integer TIFF (SampleFormat 5) is not '
                      'supported')
    kind = {1: 'u', 2: 'i', 3: 'f', 4: 'V', 6: 'c'}.get(fmt, 'u')
    if kind == 'c':
        return np.dtype('%sc%d' % (bo, bits // 8))
    return np.dtype('%s%s%d' % (bo, kind, bits // 8))


class TiffFile:
    """A parsed single-IFD (optionally multi-band) GeoTIFF."""

    def __init__(self, path):
        import mmap
        self._fh = open(path, 'rb')
        try:
            # map instead of slurping: strip/tile slices page in on
            # demand, so peak memory is the decoded raster alone
            self._data = mmap.mmap(self._fh.fileno(), 0,
                                   access=mmap.ACCESS_READ)
        except (ValueError, OSError):   # empty file / mmap-less fs
            self._data = self._fh.read()
        d = self._data
        if d[:2] == b'MM':
            self.bo = '>'
        elif d[:2] == b'II':
            self.bo = '<'
        else:
            raise IOError('not a TIFF file')
        magic = struct.unpack(self.bo + 'H', d[2:4])[0]
        if magic == 42:                           # classic TIFF
            self.bigtiff = False
            off = struct.unpack(self.bo + 'I', d[4:8])[0]
        elif magic == 43:                         # BigTIFF
            self.bigtiff = True
            offsize, zero = struct.unpack(self.bo + 'HH', d[4:8])
            if offsize != 8 or zero != 0:
                raise IOError('malformed BigTIFF header')
            off = struct.unpack(self.bo + 'Q', d[8:16])[0]
        else:
            raise IOError('not a TIFF file (magic %d)' % magic)
        # follow the IFD chain: IFD0 is the full raster, subsequent
        # reduced-resolution IFDs (NewSubfileType bit 0) are overviews
        self.ifds = []
        seen = set()
        while off and off not in seen and len(self.ifds) < 64:
            seen.add(off)
            tags, off = self._read_ifd(off)
            self.ifds.append(tags)
        if not self.ifds:
            raise IOError('TIFF file contains no IFD')
        self.tags = self.ifds[0]

    def close(self):
        """Release the mmap and file handle (idempotent)."""
        data, self._data = getattr(self, '_data', None), None
        if data is not None and hasattr(data, 'close'):
            try:
                data.close()
            except (BufferError, ValueError):
                pass   # an exported ndarray view still pins the map
        fh, self._fh = getattr(self, '_fh', None), None
        if fh is not None:
            fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):   # best-effort: batch jobs must not leak fds
        try:
            self.close()
        except Exception:
            pass

    def _read_ifd(self, off):
        d = self._data
        bo = self.bo
        if self.bigtiff:
            # 8-byte entry count, 20-byte entries, 8-byte value field
            n = struct.unpack(bo + 'Q', d[off:off + 8])[0]
            base, esize, vsize, vfmt = off + 8, 20, 8, 'Q'
            cntfmt = 'HHQ'
        else:
            n = struct.unpack(bo + 'H', d[off:off + 2])[0]
            base, esize, vsize, vfmt = off + 2, 12, 4, 'I'
            cntfmt = 'HHI'
        tags = {}
        for i in range(n):
            e = d[base + esize * i: base + esize * (i + 1)]
            tag, typ, cnt = struct.unpack(bo + cntfmt,
                                          e[:esize - vsize])
            if typ not in _TAG_TYPES:
                continue
            fmt, sz = _TAG_TYPES[typ]
            total = sz * cnt
            raw = e[esize - vsize:esize - vsize + total] \
                if total <= vsize else None
            if raw is None:
                ptr = struct.unpack(bo + vfmt,
                                    e[esize - vsize:esize])[0]
                raw = d[ptr:ptr + total]
            if typ == 2:
                vals = raw.split(b'\0')[0].decode('latin-1')
            elif typ in (5, 10):
                nums = struct.unpack(bo + ('I' if typ == 5 else 'i') * 2
                                     * cnt, raw)
                vals = tuple(nums[2 * j] / (nums[2 * j + 1] or 1)
                             for j in range(cnt))
            else:
                vals = struct.unpack(bo + fmt * cnt, raw)
            tags[tag] = vals
        nxt_pos = base + esize * n
        nxt = struct.unpack(bo + vfmt,
                            d[nxt_pos:nxt_pos + vsize])[0] \
            if len(d) >= nxt_pos + vsize else 0
        return tags, nxt

    def _tag(self, tag, default=None, tags=None):
        v = (self.tags if tags is None else tags).get(tag, default)
        if isinstance(v, tuple) and len(v) == 1:
            return v[0]
        return v

    @property
    def overviews(self):
        """(width, height) of each reduced-resolution overview IFD."""
        out = []
        for tags in self.ifds[1:]:
            if int(self._tag(254, 0, tags)) & 1:
                out.append((int(self._tag(256, tags=tags)),
                            int(self._tag(257, tags=tags))))
        return out

    def read_overview(self, level):
        """Decode overview ``level`` (0 = first/largest) fully."""
        cands = [i for i, tags in enumerate(self.ifds[1:], 1)
                 if int(self._tag(254, 0, tags)) & 1]
        if not 0 <= level < len(cands):
            raise IndexError('overview %d of %d' % (level, len(cands)))
        ifd = cands[level]
        tags = self.ifds[ifd]
        w = int(self._tag(256, tags=tags))
        h = int(self._tag(257, tags=tags))
        return self.read_window(list(range(self.nbands)), 0, h, 0, w,
                                ifd=ifd)

    @property
    def width(self):
        return int(self._tag(256))

    @property
    def height(self):
        return int(self._tag(257))

    @property
    def nbands(self):
        return int(self._tag(277, 1))

    @property
    def nodata(self):
        v = self._tag(42113)
        if v is None:
            return None
        try:
            return float(str(v).strip())
        except ValueError:
            return None

    @property
    def band_dtype(self):
        """Decoded dtype of the raster (native byte order)."""
        bits = self.tags.get(258, (8,))
        fmts = self.tags.get(339, (1,) * self.nbands)
        if int(self._tag(259, 1)) in (6, 7):        # JPEG decodes u8
            return np.dtype(np.uint8)
        return _sample_dtype(fmts[0], bits[0], self.bo).newbyteorder('=')

    def read(self):
        """Decode the raster into a (bands, height, width) array."""
        return self.read_window(list(range(self.nbands)),
                                0, self.height, 0, self.width)

    def read_window(self, bands, y0, y1, x0, x1, ifd=0):
        """Decode only the strips/tiles intersecting a pixel window.

        Returns a ``(len(bands), y1-y0, x1-x0)`` array: reading one tile
        of a mosaic touches only that tile's compressed blocks. ``ifd``
        selects the IFD to read (overview IFDs > 0).
        """
        bo = self.bo
        ifd_tags = self.ifds[ifd]
        width = int(self._tag(256, tags=ifd_tags))
        height = int(self._tag(257, tags=ifd_tags))
        nbands = int(self._tag(277, 1, ifd_tags))
        y0 = max(0, min(int(y0), height))
        y1 = max(y0, min(int(y1), height))
        x0 = max(0, min(int(x0), width))
        x1 = max(x0, min(int(x1), width))
        bands = [int(b) for b in bands]
        for b in bands:
            if not 0 <= b < nbands:
                raise IndexError('band %d out of range (%d bands)'
                                 % (b, nbands))
        bits = ifd_tags.get(258, (8,))
        fmts = ifd_tags.get(339, (1,) * nbands)
        compression = int(self._tag(259, 1, ifd_tags))
        planar = int(self._tag(284, 1, ifd_tags))
        predictor = int(self._tag(317, 1, ifd_tags))
        dtype = _sample_dtype(fmts[0], bits[0], bo)

        tiled = 322 in ifd_tags
        if tiled:
            tw = int(self._tag(322, tags=ifd_tags))
            th = int(self._tag(323, tags=ifd_tags))
            offsets = ifd_tags[324]
            counts = ifd_tags[325]
        else:
            rps = int(self._tag(278, height, ifd_tags))
            offsets = ifd_tags[273]
            counts = ifd_tags[279]

        samples_per_px = 1 if planar == 2 else nbands
        out = np.empty((len(bands), y1 - y0, x1 - x0),
                       dtype=dtype.newbyteorder('='))

        if predictor not in (1, 2, 3):
            raise IOError('unsupported TIFF predictor %d' % predictor)
        jpeg = compression in (6, 7)
        if jpeg:
            if planar == 2:
                raise IOError('planar JPEG TIFF is not supported')
            out = out.astype(np.uint8) if out.dtype != np.uint8 \
                else out
            jpeg_tables = bytes(bytearray(
                v if isinstance(v, int) else ord(v)
                for v in ifd_tags.get(347, ())))
        if y1 == y0 or x1 == x0 or not bands:
            return out

        def _block(chunk, bh, bw):
            """Decode one strip/tile -> (bh, bw, samples) array."""
            if jpeg:
                arr = _jpeg_decode(chunk, jpeg_tables)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
                # pad/crop defensively to the declared block extent
                hh = min(arr.shape[0], bh)
                ww = min(arr.shape[1], bw)
                block = np.zeros((bh, bw, arr.shape[2]),
                                 dtype=arr.dtype)
                block[:hh, :ww] = arr[:hh, :ww]
                return block
            raw = _decompress(chunk, compression)
            if predictor == 3:
                raw = _fp_predictor_decode(
                    raw, bh, bw * samples_per_px, dtype.itemsize,
                    samples_per_px)
                arr = np.frombuffer(raw, dtype.newbyteorder('>'))
            else:
                arr = np.frombuffer(raw, dtype=dtype)
            arr = arr[:bh * bw * samples_per_px] \
                .reshape(bh, bw, samples_per_px).copy()
            if predictor == 2:
                # horizontal differences per sample along the row
                # (TIFF 6.0 §14)
                np.cumsum(arr, axis=1, dtype=arr.dtype, out=arr)
            return arr

        def _paste(arr, by0, bx0, bh_eff, bw_eff, planes):
            """Copy one decoded block's window overlap into ``out``.

            ``planes`` maps out-band index -> sample axis of ``arr``
            (None = planar block holding a single sample).
            """
            ys0, ys1 = max(by0, y0), min(by0 + bh_eff, y1)
            xs0, xs1 = max(bx0, x0), min(bx0 + bw_eff, x1)
            if ys0 >= ys1 or xs0 >= xs1:
                return
            src = arr[ys0 - by0:ys1 - by0, xs0 - bx0:xs1 - bx0]
            dst = (slice(ys0 - y0, ys1 - y0), slice(xs0 - x0, xs1 - x0))
            for ob, sb in planes:
                out[(ob,) + dst] = src[:, :, sb]

        if tiled:
            tiles_x = (width + tw - 1) // tw
            tiles_y = (height + th - 1) // th
            per_plane = tiles_x * tiles_y
            ty_range = range(y0 // th, (y1 + th - 1) // th)
            tx_range = range(x0 // tw, (x1 + tw - 1) // tw)
            for ty in ty_range:
                for tx in tx_range:
                    t = ty * tiles_x + tx
                    by0, bx0 = ty * th, tx * tw
                    bh_eff = min(th, height - by0)
                    bw_eff = min(tw, width - bx0)
                    if planar == 2:
                        for ob, b in enumerate(bands):
                            idx = b * per_plane + t
                            o, c = offsets[idx], counts[idx]
                            arr = _block(self._data[o:o + c], th, tw)
                            _paste(arr, by0, bx0, bh_eff, bw_eff,
                                   [(ob, 0)])
                    else:
                        o, c = offsets[t], counts[t]
                        arr = _block(self._data[o:o + c], th, tw)
                        _paste(arr, by0, bx0, bh_eff, bw_eff,
                               list(enumerate(bands)))
        else:
            strips_per_plane = (height + rps - 1) // rps
            for s in range(y0 // rps, (y1 + rps - 1) // rps):
                by0 = s * rps
                h = min(rps, height - by0)
                if planar == 2:
                    for ob, b in enumerate(bands):
                        idx = b * strips_per_plane + s
                        o, c = offsets[idx], counts[idx]
                        arr = _block(self._data[o:o + c], h, width)
                        _paste(arr, by0, 0, h, width, [(ob, 0)])
                else:
                    o, c = offsets[s], counts[s]
                    arr = _block(self._data[o:o + c], h, width)
                    _paste(arr, by0, 0, h, width,
                           list(enumerate(bands)))
        return out

    # -- georeferencing ------------------------------------------------------
    @property
    def transform(self):
        if 34264 in self.tags:  # ModelTransformation (4x4, row-major)
            m = self.tags[34264]
            return Affine(m[0], m[1], m[3], m[4], m[5], m[7])
        scale = self.tags.get(33550)
        tie = self.tags.get(33922)
        if scale and tie:
            sx, sy = scale[0], scale[1]
            i, j, _, x, y, _ = tie[:6]
            return Affine(sx, 0.0, x - i * sx, 0.0, -sy, y + j * sy)
        return None

    @property
    def crs(self):
        gkd = self.tags.get(34735)
        if not gkd:
            return None
        keys = {}
        n = gkd[3]
        for i in range(1, n + 1):
            kid, loc, cnt, val = gkd[4 * i:4 * i + 4]
            if loc == 0:
                keys[kid] = val
        # 3072: ProjectedCSTypeGeoKey; 2048: GeographicTypeGeoKey
        code = keys.get(3072) or keys.get(2048)
        if code and code != 32767:
            try:
                return CRS.from_epsg(int(code))
            except ValueError:
                return None
        # user-defined (32767): try the citation ascii (proj4 or WKT)
        citation = self.tags.get(34737)
        if citation:
            for part in str(citation).split('|'):
                part = part.strip()
                if not part:
                    continue
                try:
                    return CRS.from_string(part)
                except (ValueError, NotImplementedError):
                    continue            # not this part: try the next
        return None


def read_geotiff(path):
    """Read a GeoTIFF into (data, transform, crs, nodata)."""
    with TiffFile(path) as t:
        return t.read(), t.transform, t.crs, t.nodata


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_DTYPE_TO_SAMPLE = {
    'u': 1, 'i': 2, 'f': 3, 'c': 6,
}


def _decimate(data, f, nodata=None):
    """Reduce a (bands, h, w) array by factor ``f``: block-average for
    floats (GDAL's 'average' resampling, masking NaN and the declared
    ``nodata`` value like ``gdaladdo``), nearest for integer/bool
    rasters (no invented values in categorical data)."""
    nb, h, w = data.shape
    if data.dtype.kind == 'f':
        oh, ow = -(-h // f), -(-w // f)
        pad = np.full((nb, oh * f, ow * f), np.nan, np.float64)
        pad[:, :h, :w] = data
        blocks = pad.reshape(nb, oh, f, ow, f)
        valid = np.isfinite(blocks)
        if nodata is not None and np.isfinite(nodata):
            valid &= blocks != float(nodata)
        total = np.where(valid, blocks, 0.0).sum(axis=(2, 4))
        count = valid.sum(axis=(2, 4))
        out = total / np.maximum(count, 1)
        # an all-masked block stays nodata (the declared value when
        # one exists, NaN otherwise) — never an invented average
        fill = float(nodata) if nodata is not None \
            and np.isfinite(nodata) else np.nan
        out[count == 0] = fill
        return out.astype(data.dtype)
    return data[:, ::f, ::f]


class _IFDWriter:
    """One TIFF IFD (entry table + out-of-line values + pixel blocks)
    serialized at a known absolute file offset (classic TIFF)."""

    def __init__(self):
        self.entries = []     # (tag, typ, count, inline-bytes | ('x', off))
        self.extra = bytearray()
        self.blocks = []
        self._offsets_entry = None   # index of 273/324 to patch

    def add(self, tag, typ, values, fmt):
        if isinstance(values, (int, float)):
            values = [values]
        count = len(values)
        packed = struct.pack('<' + fmt * count, *values)
        if len(packed) <= 4:
            self.entries.append((tag, typ, count,
                                 packed + b'\0' * (4 - len(packed))))
        else:
            self.entries.append((tag, typ, count, ('x', len(self.extra))))
            self.extra.extend(packed)

    def add_ascii(self, tag, text):
        raw = text.encode('latin-1') + b'\0'
        if len(raw) <= 4:
            self.entries.append((tag, 2, len(raw),
                                 raw + b'\0' * (4 - len(raw))))
        else:
            self.entries.append((tag, 2, len(raw), ('x', len(self.extra))))
            self.extra.extend(raw)

    def set_blocks(self, blocks, offsets_tag, counts_tag):
        """Register pixel blocks; their offsets entry is patched at
        serialization time (reserved in ``extra`` when out-of-line)."""
        self.blocks = blocks
        n = len(blocks)
        self.add(counts_tag, 4, [len(b) for b in blocks], 'I')
        self._offsets_entry = len(self.entries)
        self.add(offsets_tag, 4, [0] * n, 'I')

    def serialize(self, base):
        """Serialize at absolute offset ``base``.

        Returns (blob, next_field_abs_offset): the 4-byte next-IFD
        pointer inside the blob is left 0; the caller patches it once
        the following IFD's offset is known.
        """
        offsets_marker = None
        if self._offsets_entry is not None:
            offsets_marker = self.entries[self._offsets_entry]
        self.entries.sort(key=lambda e: e[0])
        ifd_size = 2 + 12 * len(self.entries) + 4
        extra_base = base + ifd_size
        data_base = extra_base + len(self.extra)

        if offsets_marker is not None:
            n = len(self.blocks)
            offs = []
            pos = data_base
            for b in self.blocks:
                offs.append(pos)
                pos += len(b)
            packed = struct.pack('<' + 'I' * n, *offs)
            idx = self.entries.index(offsets_marker)
            tag, typ, count, val = self.entries[idx]
            if isinstance(val, tuple):      # out-of-line: patch extra
                self.extra[val[1]:val[1] + len(packed)] = packed
            else:
                self.entries[idx] = (tag, typ, count,
                                     packed + b'\0' * (4 - len(packed)))

        blob = bytearray()
        blob += struct.pack('<H', len(self.entries))
        for tag, typ, count, val in self.entries:
            blob += struct.pack('<HHI', tag, typ, count)
            if isinstance(val, tuple):
                blob += struct.pack('<I', extra_base + val[1])
            else:
                blob += val
        next_field_abs = base + len(blob)
        blob += struct.pack('<I', 0)        # next IFD (patched later)
        blob += bytes(self.extra)
        for b in self.blocks:
            blob += b
        return bytes(blob), next_field_abs


def _encode_blocks(data, codec, tiled, ts):
    """Planar band-sequential pixel blocks for one IFD level."""
    nbands, height, width = data.shape
    dt = data.dtype
    _, encode = codec
    blocks = []
    if tiled:
        tiles_x = (width + ts - 1) // ts
        tiles_y = (height + ts - 1) // ts
        row_bytes = ts * dt.itemsize
        for b in range(nbands):
            band = np.ascontiguousarray(data[b]).astype(
                dt.newbyteorder('<'))
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    block = np.zeros((ts, ts), band.dtype)
                    sub = band[ty * ts:(ty + 1) * ts,
                               tx * ts:(tx + 1) * ts]
                    block[:sub.shape[0], :sub.shape[1]] = sub
                    raw = block.tobytes()
                    blocks.append(encode(raw, row_bytes)
                                  if encode else raw)
    else:
        row_bytes = width * dt.itemsize
        for b in range(nbands):
            raw = np.ascontiguousarray(data[b]).astype(
                dt.newbyteorder('<')).tobytes()
            blocks.append(encode(raw, row_bytes) if encode else raw)
    return blocks


def _build_level_ifd(data, codec, tiled, ts, reduced=False):
    """Assemble the raster-structure tags + blocks of one IFD level."""
    nbands, height, width = data.shape
    dt = data.dtype
    sample_format = _DTYPE_TO_SAMPLE.get(dt.kind)
    if sample_format is None:
        raise TypeError('cannot write dtype %r' % dt)
    bits = dt.itemsize * 8

    w = _IFDWriter()
    if reduced:
        w.add(254, 4, 1, 'I')               # NewSubfileType: overview
    w.add(256, 4, width, 'I')
    w.add(257, 4, height, 'I')
    w.add(258, 3, [bits] * nbands, 'H')
    w.add(259, 3, codec[0], 'H')
    w.add(262, 3, 1, 'H')
    w.add(277, 3, nbands, 'H')
    w.add(284, 3, 2, 'H')                   # planar
    blocks = _encode_blocks(data, codec, tiled, ts)
    if tiled:
        w.add(322, 4, ts, 'I')
        w.add(323, 4, ts, 'I')
        w.set_blocks(blocks, 324, 325)
    else:
        w.add(278, 4, height, 'I')
        w.set_blocks(blocks, 273, 279)
    w.add(339, 3, [sample_format] * nbands, 'H')
    return w


def write_geotiff(path, data, transform=None, crs=None, nodata=None,
                  compress=True, tiled=False, tile_size=256,
                  overviews=None):
    """Write a (bands, height, width) or (height, width) array as a
    GeoTIFF (little-endian, band-sequential).

    ``compress`` selects the codec: ``True`` (Deflate, the default),
    ``False`` (uncompressed), or ``'deflate'``/``'lzw'``/``'packbits'``/
    ``'zstd'``/``'none'`` — all written in the standard TIFF encodings
    (LZW/PackBits verified against Pillow's libtiff decoder; ZSTD needs
    the ``zstandard`` module).

    ``tiled=True`` writes a tiled layout (``tile_size`` square tiles,
    the cloud-optimized access pattern) instead of one strip per band.
    ``overviews`` adds reduced-resolution IFDs: an iterable of integer
    decimation factors (e.g. ``[2, 4, 8]``) or ``True`` for powers of
    two down to ~256 px — block-averaged for float rasters, nearest
    for integer ones, the COG overview pyramid GDAL builds with
    ``gdaladdo``.
    """
    codec = _normalize_codec(compress)
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    nbands, height, width = data.shape
    if data.dtype == np.float16:
        data = data.astype(np.float32)
    if data.dtype == bool:
        data = data.astype(np.uint8)

    ts = max(16, int(tile_size) // 16 * 16) if tiled else None

    if overviews is True:
        overviews = []
        f = 2
        while max(height, width) // f >= 256:
            overviews.append(f)
            f *= 2
        if not overviews and max(height, width) >= 2:
            overviews = [2]
    factors = sorted(int(f) for f in overviews) if overviews else []
    if any(f < 2 for f in factors):
        raise ValueError('overview factors must be >= 2')

    main = _build_level_ifd(data, codec, tiled, ts)

    if transform is not None:
        t = transform if isinstance(transform, Affine) \
            else Affine(*tuple(transform)[:6])
        if t.b == 0 and t.d == 0:
            main.add(33550, 12, [abs(t.a), abs(t.e), 0.0], 'd')
            main.add(33922, 12, [0.0, 0.0, 0.0, t.c, t.f, 0.0], 'd')
        else:
            main.add(34264, 12, [t.a, t.b, 0.0, t.c,
                                 t.d, t.e, 0.0, t.f,
                                 0.0, 0.0, 0.0, 0.0,
                                 0.0, 0.0, 0.0, 1.0], 'd')

    if crs is not None:
        crs = CRS.from_user_input(crs)
        code = crs.to_epsg()
        keys = [(1024, 0, 1, 2 if crs.is_geographic else 1),
                (1025, 0, 1, 1)]
        ascii_params = None
        if code is not None:
            if crs.is_geographic:
                keys.append((2048, 0, 1, code))
            else:
                keys.append((3072, 0, 1, code))
        else:
            # no EPSG match: user-defined CRS — persist the full proj4
            # string in the citation so the round-trip keeps the CRS
            # instead of silently dropping it
            ascii_params = crs.to_proj4() + '|'
            ckey = 2049 if crs.is_geographic else 3073  # citation key
            keys.append((2048 if crs.is_geographic else 3072,
                         0, 1, 32767))
            keys.append((ckey, 34737, len(ascii_params), 0))
        gkd = [1, 1, 0, len(keys)]
        for k in keys:
            gkd.extend(k)
        main.add(34735, 3, gkd, 'H')
        if ascii_params is not None:
            main.add(34737, 2, list(ascii_params.encode('latin-1')),
                     'B')

    if nodata is not None:
        main.add_ascii(42113, repr(float(nodata)))

    writers = [main]
    for f in factors:
        ov = _decimate(data, f, nodata=nodata)
        # overviews of a strip raster stay stripped; tiled stays tiled
        writers.append(_build_level_ifd(ov, codec, tiled, ts,
                                        reduced=True))

    # serialize the chain: header, then each IFD block back-to-back
    blobs = []
    next_fields = []
    base = 8
    for w in writers:
        blob, nf = w.serialize(base)
        blobs.append(bytearray(blob))
        next_fields.append((nf, base))
        base += len(blob)

    # patch next-IFD pointers
    for i in range(len(blobs) - 1):
        nf, b0 = next_fields[i]
        nxt = next_fields[i + 1][1]
        struct.pack_into('<I', blobs[i], nf - b0, nxt)

    with open(path, 'wb') as fh:
        fh.write(b'II*\0' + struct.pack('<I', 8))
        for blob in blobs:
            fh.write(bytes(blob))
