"""Writes the synthetic Sentinel-2 L1C granule and parcel shapefile under
``tests/data/torch_s2/`` that the port's tests and ``chip_smoke.py``
read.

    python tests/torch_s2_fixture.py      # from the repository root

The JP2 bands are encoded by Pillow's OpenJPEG, which only the machine
that writes the fixture needs. The granule sits in UTM 33N (EPSG:32633)
at the north-west corner of tile T33UUP (300000 E, 5500020 N, the MGRS
square's corner as the tiling grid puts it) and covers a tenth of a
tile's extent: 10 m bands at 1098 x 1098, 20 m at 549 x 549, 60 m at
183 x 183. Four land-cover signatures (water, forest, crop, bare) on
smooth fields; a few hundred parcels whose ``class`` is the cover under
them, some with holes, some multipart.

The bands cover every synthesis and Tier-2 route of the decoder:

    B02  5/3, LRCP                   B08  9/7, 2 layers, RLCP, precincts
    B03  9/7, one rate-capped layer  B11  5/3, 3 layers
    B04  5/3, 4 tiles, RPCL          B12  9/7, 9 tiles
    B01  5/3, 5 resolutions

``MANIFEST.json`` holds, for each band and ``reduce`` 0, 1 and 2, the
decoded shape and dtype, the sha256 of ``nd_tpu``'s decode and, for the
reversible bands, of OpenJPEG's own decode (equal to it; null where
OpenJPEG refuses the reduced decode, see :func:`openjpeg`).
"""

import hashlib
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, 'data', 'torch_s2')
GRANULE = 'L1C_T33UUP_A000000_20240615T100559'
STEM = 'T33UUP_20240615T100559'
ULX, ULY = 300000.0, 5500020.0
N10 = 1098
SEED = 20240615
CLASSES = ('water', 'forest', 'crop', 'bare')
# top-of-atmosphere reflectance x 10000 of each cover, by band
SIGNATURES = {
    'B01': (1250, 1150, 1200, 1450), 'B02': (950, 650, 820, 1400),
    'B03': (780, 820, 1120, 1520), 'B04': (520, 480, 880, 1700),
    'B08': (310, 3150, 4150, 2450), 'B11': (160, 1480, 2150, 2800),
    'B12': (110, 690, 1180, 2300)}
# band -> (resolution, Pillow's save options)
BANDS = {
    'B02': (10, dict(irreversible=False)),
    'B03': (10, dict(irreversible=True, quality_mode='rates',
                     quality_layers=[24])),
    'B04': (10, dict(irreversible=False, tile_size=(549, 549),
                     progression='RPCL')),
    'B08': (10, dict(irreversible=True, quality_mode='rates',
                     quality_layers=[60, 16], progression='RLCP',
                     precinct_size=(128, 128))),
    'B11': (20, dict(irreversible=False, quality_mode='rates',
                     quality_layers=[40, 10, 0])),
    'B12': (20, dict(irreversible=True, quality_mode='rates',
                     quality_layers=[20], tile_size=(192, 192))),
    'B01': (60, dict(irreversible=False, num_resolutions=5)),
}
PRJ = ('PROJCS["WGS_1984_UTM_Zone_33N",GEOGCS["GCS_WGS_1984",'
       'DATUM["D_WGS_1984",SPHEROID["WGS_1984",6378137.0,298.257223563]],'
       'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
       'PROJECTION["Transverse_Mercator"],PARAMETER["False_Easting",'
       '500000.0],PARAMETER["False_Northing",0.0],PARAMETER['
       '"Central_Meridian",15.0],PARAMETER["Scale_Factor",0.9996],'
       'PARAMETER["Latitude_Of_Origin",0.0],UNIT["Meter",1.0]]')

MTD_TL = """<?xml version="1.0" encoding="UTF-8"?>
<n1:Level-1C_Tile_ID xmlns:n1="https://psd-14.sentinel2.eo.esa.int/\
PSD/S2_PDI_Level-1C_Tile_Metadata.xsd">
 <n1:General_Info>
  <TILE_ID metadataLevel="Brief">S2B_OPER_MSI_L1C_TL_2BPS_20240615T121143\
_A000000_T33UUP_N05.10</TILE_ID>
  <SENSING_TIME metadataLevel="Standard">2024-06-15T10:05:59.024Z\
</SENSING_TIME>
 </n1:General_Info>
 <n1:Geometric_Info>
  <Tile_Geocoding metadataLevel="Brief">
   <HORIZONTAL_CS_NAME>WGS84 / UTM zone 33N</HORIZONTAL_CS_NAME>
   <HORIZONTAL_CS_CODE>EPSG:32633</HORIZONTAL_CS_CODE>
{sizes}
{positions}
  </Tile_Geocoding>
 </n1:Geometric_Info>
</n1:Level-1C_Tile_ID>
"""


def grid(res, n=None):
    """(x, y) pixel-centre coordinates of the granule's grid at ``res``
    metres (``n`` pixels a side, default the fixture's)."""
    n = N10 * 10 // res if n is None else n
    x = ULX + (np.arange(n) + 0.5) * res
    y = ULY - (np.arange(n) + 0.5) * res
    return x, y


def _smooth(rng, n, cells):
    from scipy.ndimage import zoom
    return zoom(rng.normal(size=(cells, cells)), n / cells, order=3)[:n, :n]


def _ring(rng, cx, cy, radius, n):
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = radius * (1 + 0.5 * (rng.uniform(size=n) - 0.5))
    return np.stack([cx + radii * np.cos(angles),
                     cy + radii * np.sin(angles)], 1)


def parcels(rng, cover):
    """A few hundred parcels on a jittered 18 x 18 grid of the extent:
    every 7th with a hole, every 11th in two parts; each parcel's class
    is the cover at its first part's centre."""
    from nd_tpu_torch.vector.geometry import MultiPolygon, Polygon
    x10, y10 = grid(10)
    side = N10 * 10.0
    cells = 18
    cw = side / cells
    out = []
    for k, (i, j) in enumerate((i, j) for i in range(cells)
                               for j in range(cells)):
        if rng.uniform() < 0.08:
            continue                       # an unmapped field
        cx = ULX + (j + 0.5 + rng.uniform(-0.1, 0.1)) * cw
        cy = ULY - (i + 0.5 + rng.uniform(-0.1, 0.1)) * cw
        cls = int(cover[int(np.argmin(np.abs(y10 - cy))),
                        int(np.argmin(np.abs(x10 - cx)))]) + 1
        if k % 11 == 5:
            a = _ring(rng, cx - 0.2 * cw, cy, 0.17 * cw, 7)
            b = _ring(rng, cx + 0.2 * cw, cy, 0.17 * cw, 6)
            geom = MultiPolygon([Polygon(a), Polygon(b)])
        else:
            shell = _ring(rng, cx, cy, 0.36 * cw, int(rng.randint(6, 13)))
            holes = []
            if k % 7 == 3:
                holes = [_ring(rng, cx, cy, 0.1 * cw, 5)]
            geom = Polygon(shell, holes)
        out.append((geom, {'id': len(out) + 1, 'class': cls,
                           'name': CLASSES[cls - 1]}))
    return out


def scene(rng):
    """Cover map (0-3) at 10 m and the seven bands' values (uint16) at
    their resolutions, with the parcels burned into the cover."""
    from nd_tpu_torch.ops.rasterize import rasterize_values
    fields = np.stack([_smooth(rng, N10, 9) for _ in CLASSES])
    cover = np.argmax(fields, 0)
    plist = parcels(rng, cover)
    x10, y10 = grid(10)
    burned = rasterize_values([(g, r['class']) for g, r in plist], x10, y10,
                              fill=0, device='cpu').numpy()
    cover = np.where(burned > 0, burned - 1, cover)
    shade = _smooth(rng, N10, 24)
    bands = {}
    for b, (res, _) in BANDS.items():
        sig = np.asarray(SIGNATURES[b], np.float64)
        v = sig[cover] * (1 + 0.04 * shade) + rng.normal(0, 2.5, cover.shape)
        f = res // 10
        v = v.reshape(N10 // f, f, N10 // f, f).mean(axis=(1, 3))
        bands[b] = np.clip(np.rint(v), 1, 10000).astype(np.uint16)
    return cover, plist, bands


def _ring_records(geom):
    """The shapefile's parts: outer rings clockwise, holes counter-
    clockwise, each closed."""
    from nd_tpu_torch.vector.geometry import MultiPolygon
    polys = geom.geoms if isinstance(geom, MultiPolygon) else [geom]
    parts = []
    for p in polys:
        for k, ring in enumerate([p.exterior] + list(p.interiors)):
            a = ring.as_array()
            area2 = np.sum((a[1:, 0] - a[:-1, 0]) * (a[1:, 1] + a[:-1, 1]))
            clockwise = area2 > 0
            if clockwise != (k == 0):
                a = a[::-1]
            parts.append(a)
    return parts


def write_shapefile(base, geoms, records, prj=PRJ):
    """Polygon shapefile (``.shp``, ``.shx``, ``.dbf``, ``.prj``) with
    struct: numeric fields as 'N', strings as 'C', ``datetime.date`` as
    'D' (``None`` blank)."""
    import datetime
    recs, offsets = [], []
    pos = 50                                   # in 16-bit words
    allpts = []
    for n, geom in enumerate(geoms, 1):
        parts = _ring_records(geom)
        pts = np.concatenate(parts)
        allpts.append(pts)
        starts = np.cumsum([0] + [len(p) for p in parts[:-1]])
        body = struct.pack('<i4d2i', 5, pts[:, 0].min(), pts[:, 1].min(),
                           pts[:, 0].max(), pts[:, 1].max(), len(parts),
                           len(pts))
        body += struct.pack('<%di' % len(parts), *starts)
        body += pts.astype('<f8').tobytes()
        recs.append(struct.pack('>2i', n, len(body) // 2) + body)
        offsets.append((pos, len(body) // 2))
        pos += 4 + len(body) // 2
    allpts = np.concatenate(allpts)
    bbox = (allpts[:, 0].min(), allpts[:, 1].min(), allpts[:, 0].max(),
            allpts[:, 1].max())

    def header(words):
        return (struct.pack('>7i', 9994, 0, 0, 0, 0, 0, words)
                + struct.pack('<2i4d4d', 1000, 5, *bbox, 0, 0, 0, 0))
    with open(base + '.shp', 'wb') as fh:
        fh.write(header(pos))
        fh.write(b''.join(recs))
    with open(base + '.shx', 'wb') as fh:
        fh.write(header(50 + 4 * len(geoms)))
        fh.write(b''.join(struct.pack('>2i', o, n) for o, n in offsets))
    fields = []
    for name in records[0]:
        vals = [r[name] for r in records]
        if all(isinstance(v, (int, np.integer)) for v in vals):
            fields.append((name, 'N', 10, 0))
        elif all(isinstance(v, (float, np.floating)) for v in vals):
            fields.append((name, 'N', 18, 6))
        elif all(v is None or isinstance(v, datetime.date) for v in vals):
            fields.append((name, 'D', 8, 0))
        else:
            fields.append((name, 'C', max(len(str(v)) for v in vals), 0))
    rec_len = 1 + sum(f[2] for f in fields)
    hdr_len = 32 + 32 * len(fields) + 1
    out = [struct.pack('<BBBBIHH20x', 3, 124, 6, 15, len(records), hdr_len,
                       rec_len)]
    for name, ftype, length, dec in fields:
        out.append(name.encode('ascii').ljust(11, b'\0') + ftype.encode()
                   + b'\0' * 4 + bytes([length, dec]) + b'\0' * 14)
    out.append(b'\x0d')
    for r in records:
        row = b' '
        for name, ftype, length, dec in fields:
            v = r[name]
            if ftype == 'N':
                text = ('%d' % v) if dec == 0 else ('%.*f' % (dec, v))
                row += text.rjust(length).encode('ascii')
            elif ftype == 'D':
                text = '' if v is None else v.strftime('%Y%m%d')
                row += text.ljust(length).encode('ascii')
            else:
                row += str(v).ljust(length).encode('latin-1')
        out.append(row)
    out.append(b'\x1a')
    with open(base + '.dbf', 'wb') as fh:
        fh.write(b''.join(out))
    if prj is not None:
        with open(base + '.prj', 'w') as fh:
            fh.write(prj)


def sha256(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def write_granule(out=OUT, seed=SEED):
    """Writes the granule and the parcels under ``out``; returns the
    cover map and the parcel list."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    cover, plist, bands = scene(rng)
    gdir = os.path.join(out, GRANULE)
    os.makedirs(os.path.join(gdir, 'IMG_DATA'), exist_ok=True)
    sizes = '\n'.join(
        '   <Size resolution="%d"><NROWS>%d</NROWS><NCOLS>%d</NCOLS></Size>'
        % (r, N10 * 10 // r, N10 * 10 // r) for r in (10, 20, 60))
    positions = '\n'.join(
        '   <Geoposition resolution="%d"><ULX>%d</ULX><ULY>%d</ULY>'
        '<XDIM>%d</XDIM><YDIM>-%d</YDIM></Geoposition>'
        % (r, ULX, ULY, r, r) for r in (10, 20, 60))
    with open(os.path.join(gdir, 'MTD_TL.xml'), 'w') as fh:
        fh.write(MTD_TL.format(sizes=sizes, positions=positions))
    for b, (res, opts) in BANDS.items():
        Image.fromarray(bands[b]).save(band_path(b, out), **opts)
    write_shapefile(os.path.join(out, 'parcels'), [g for g, _ in plist],
                    [r for _, r in plist])
    return cover, plist


def band_path(band, out=OUT):
    return os.path.join(out, GRANULE, 'IMG_DATA', '%s_%s.jp2' % (STEM, band))


def openjpeg(path, reduce=0):
    """OpenJPEG's decode (through Pillow) at ``reduce``, or None where it
    refuses one: Pillow 12.1 reports a reduce-2 decode of a 549-wide
    image as a "broken data stream" (548 and 550 decode)."""
    from PIL import Image
    img = Image.open(path)
    img.reduce = reduce
    try:
        return np.asarray(img)
    except OSError:
        return None


def manifest(out=OUT):
    """``{band: {'reversible': bool, 'reduce': {r: {shape, dtype, sha256,
    openjpeg_sha256}}}}`` of the files under ``out``, decoded by
    ``nd_tpu`` (and OpenJPEG for the reversible bands)."""
    from nd_tpu.io.jp2 import decode_jp2
    doc = {}
    for b, (res, opts) in BANDS.items():
        path = band_path(b, out)
        entry = {'resolution': res, 'reversible': not opts['irreversible'],
                 'bytes': os.path.getsize(path), 'reduce': {}}
        for r in (0, 1, 2):
            arr = decode_jp2(path, reduce=r)
            row = {'shape': list(arr.shape), 'dtype': str(arr.dtype),
                   'sha256': sha256(arr)}
            if entry['reversible']:
                ref = openjpeg(path, r)
                if ref is not None and not np.array_equal(ref, arr):
                    raise AssertionError('nd_tpu and OpenJPEG disagree on '
                                         '%s at reduce %d' % (b, r))
                row['openjpeg_sha256'] = None if ref is None else sha256(ref)
            entry['reduce'][str(r)] = row
        doc[b] = entry
    return doc


def main():
    sys.path.insert(0, os.path.dirname(HERE))
    import jax
    jax.config.update('jax_platforms', 'cpu')
    write_granule()
    doc = {'granule': GRANULE, 'parcels': 'parcels.shp', 'seed': SEED,
           'bands': manifest()}
    with open(os.path.join(OUT, 'MANIFEST.json'), 'w') as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write('\n')
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(OUT) for f in fs)
    print('wrote %s: %d bytes' % (OUT, total))


if __name__ == '__main__':
    main()
