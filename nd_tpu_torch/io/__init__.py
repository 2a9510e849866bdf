"""I/O layer: netCDF, GeoTIFF, ENVI, zarr, BEAM-DIMAP and the complex
(dis)assembly of variables.

Counterpart of ``nd_tpu/io/__init__.py``. The readers and writers are
host-side numpy, as in the JAX package: a reader puts numeric data on
``device`` (``cuda`` unless the caller names another), a writer copies
each variable of a CUDA dataset to the host once. netCDF-4 needs
``h5py``; without it netCDF classic is read and written
(:mod:`.netcdf`). ``chunks=`` opens netCDF and GeoTIFF files lazily
(:mod:`.lazy`): nothing is read until it is used, and a slab read onto
the card or written to another file reads only itself. JPEG 2000
(:mod:`.jp2`, with GeoJP2 georeferencing) opens through
:func:`open_rasterio`, and a Sentinel-2 L1C granule (``MTD_TL.xml`` and
``IMG_DATA/*.jp2``) through :func:`open_sentinel2_granule`; the decoder
is host numpy with a native Tier-1 (:mod:`nd_tpu_torch.native`).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from .. import utils
from ..core import DataArray, Dataset
from ..core.variable import Variable
from .zarr import open_zarr, to_zarr

__all__ = ['open_dataset', 'open_netcdf', 'open_beam_dimap',
           'open_rasterio', 'open_sentinel2_granule', 'to_netcdf',
           'to_geotiff', 'to_zarr', 'open_zarr', 'assemble_complex',
           'disassemble_complex', 'add_time']


# --------------------
# CONVERSION FUNCTIONS
# --------------------

def disassemble_complex(ds, inplace=False):
    """Split complex variables into ``<name>__re`` / ``<name>__im``
    pairs (a DataArray becomes a one-variable Dataset first)."""
    if isinstance(ds, DataArray):
        ds = ds.to_dataset(name=ds.name or 'data')
    new_ds = ds if inplace else ds.copy(deep=False)
    for vn in list(new_ds._variables):
        var = new_ds._variables[vn]
        if not (isinstance(var.dtype, torch.dtype) and var.dtype.is_complex):
            continue
        if var.is_lazy:
            # split on the host: a lazy view written to a file is never
            # read onto the card
            vals = var.values
            parts = (np.ascontiguousarray(vals.real),
                     np.ascontiguousarray(vals.imag))
            device = 'cpu'
        else:
            parts = (var.data.real.contiguous(), var.data.imag.contiguous())
            device = None
        for suffix, part in zip(('__re', '__im'), parts):
            new_ds._variables[vn + suffix] = Variable(
                var.dims, part, dict(var.attrs), device)
        del new_ds._variables[vn]
    if not inplace:
        return new_ds


def assemble_complex(ds, inplace=False):
    """Reassemble ``*_real``/``__re`` + ``*_imag``/``__im`` variable pairs
    into complex variables (the inverse of :func:`disassemble_complex`)."""
    new_ds = ds if inplace else ds.copy(deep=False)
    endings = {'re': ['_real', '__re'], 'im': ['_imag', '__im']}
    matches = {}
    for part, end in endings.items():
        rex = re.compile('(?P<stem>.*)(?:{})$'.format('|'.join(end)))
        matches[part] = [m for m in map(rex.match, new_ds._variables)
                         if m is not None]
    stems = set(m.group('stem') for m in matches['re'] + matches['im'])
    for vn in sorted(stems):
        m_re = next((m for m in matches['re'] if m.group('stem') == vn),
                    None)
        m_im = next((m for m in matches['im'] if m.group('stem') == vn),
                    None)
        if m_re is None or m_im is None:
            continue
        re_var = new_ds._variables[m_re.group(0)]
        im_var = new_ds._variables[m_im.group(0)]
        if im_var.dims != re_var.dims:
            im_var = im_var.transpose(*re_var.dims)
        dtype = torch.promote_types(re_var.data.dtype, im_var.data.dtype)
        if not dtype.is_floating_point:
            dtype = torch.float64       # integer parts: complex128
        elif dtype not in (torch.float32, torch.float64):
            dtype = torch.float32       # half parts: complex64
        new_ds._variables[vn] = Variable(
            re_var.dims, torch.complex(re_var.data.to(dtype),
                                       im_var.data.to(dtype)),
            dict(re_var.attrs))
        del new_ds._variables[m_re.group(0)]
        del new_ds._variables[m_im.group(0)]
    if not inplace:
        return new_ds


def add_time(ds, inplace=False):
    """Ensure the dataset has a ``time`` coordinate (from
    ``attrs['start_date']`` if missing)."""
    result = ds if inplace else ds.copy(deep=False)
    if 'time' not in result._coords:
        times = np.asarray(
            [np.datetime64(utils.str2date(ds.attrs['start_date']), 'ns')])
        result._coords['time'] = Variable(('time',), times)
    if not inplace:
        return result


# -------------
# OPEN DATASETS
# -------------

def open_dataset(path, *args, **kwargs):
    """Open a datacube, dispatching on the file extension.

    ``.nc`` -> :func:`open_netcdf`, ``.dim`` -> :func:`open_beam_dimap`,
    anything else -> :func:`open_rasterio`. Pass ``device=`` for another
    device than ``cuda``.
    """
    _, ext = os.path.splitext(str(path))
    if ext == '.nc':
        return open_netcdf(path, *args, **kwargs)
    if ext == '.dim':
        return open_beam_dimap(path, *args, **kwargs)
    try:
        return open_rasterio(path, *args, **kwargs)
    except Exception as e:
        raise IOError('Could not read the file: %s' % e) from e


# --------------
# FORMAT: NETCDF
# --------------

def to_netcdf(ds, path, *args, **kwargs):
    """Write a Dataset to netCDF, always disassembling complex variables
    (reassembled on read via ``open_netcdf(as_complex=True)``).
    ``complevel=0`` writes contiguous, uncompressed variables. Where
    ``h5py`` does not import, the file is netCDF classic, uncompressed
    (``netcdf.writer()`` says which)."""
    from .netcdf import write_netcdf_file
    if isinstance(ds, DataArray):
        ds = ds.to_dataset(name=ds.name or 'data')
    write = disassemble_complex(ds)
    complevel = kwargs.get('complevel', 5)
    compress = kwargs.get('compress', True) and complevel > 0
    write_netcdf_file(write, path, compress=compress,
                      complevel=complevel,
                      encoding=kwargs.get('encoding'))
    return path


def open_netcdf(path, as_complex=False, rename_latlon=True, *args,
                **kwargs):
    """Read a netCDF file into a Dataset, numeric data on ``device=``
    (default ``cuda``).

    lat/lon dimensions are renamed to y/x (keeping lat/lon coords); pass
    ``rename_latlon=False`` for a verbatim read, ``decode_cf=False`` to
    keep the stored values.

    Pass ``chunks`` (any value, e.g. ``{}``) for a lazy open: data
    variables are read per ``isel`` slab on first use (onto ``device``
    for a computation, into host memory for ``.values`` or a write), so
    a file larger than memory streams through ``tiling.tile`` and
    ``map_over_tiles`` without ever being read whole.
    """
    from .netcdf import open_netcdf_file
    ds = open_netcdf_file(path, decode_cf=kwargs.get('decode_cf', True),
                          device=kwargs.get('device'),
                          chunks=kwargs.get('chunks'))
    if as_complex:
        ds = assemble_complex(ds)
    if rename_latlon and 'lon' in ds.sizes and 'lat' in ds.sizes:
        lat = ds._coords.get('lat')
        lon = ds._coords.get('lon')
        ds = ds.rename({'lat': 'y', 'lon': 'x'})
        if lat is not None:
            ds._coords['lat'] = Variable(('y',), lat.data, lat.attrs)
        if lon is not None:
            ds._coords['lon'] = Variable(('x',), lon.data, lon.attrs)
    return ds


# ---------------------
# FORMAT: RASTER (TIFF)
# ---------------------

def _read_world_file(path):
    """ESRI world-file georeferencing for plain image rasters.

    GDAL's sidecar rule: ``<first><last>w`` of the image extension
    (``.pgw``/``.jgw``/``.bpw``/``.tfw``) or the generic ``.wld``. The
    six lines anchor at the CENTER of the upper-left pixel; returns a
    corner-anchored Affine matching the GeoTIFF reader's convention.
    """
    from ..crs import Affine
    base, ext = os.path.splitext(str(path))
    ext = ext.lstrip('.')
    candidates = ['%s.%s' % (base, (ext[0] + ext[-1] + 'w').lower()),
                  base + '.wld'] if len(ext) >= 2 else [base + '.wld']
    for cand in candidates:
        if not os.path.exists(cand):
            continue
        with open(cand) as fh:
            vals = [float(line.strip()) for line in fh
                    if line.strip()][:6]
        if len(vals) != 6:
            raise IOError('world file %s must have 6 numeric lines'
                          % cand)
        A, D, B, E, C, F = vals
        return Affine(A, B, C - (A + B) / 2.0,
                      D, E, F - (D + E) / 2.0)
    return None


def _read_prj_file(path):
    from ..crs import CRS
    base, _ = os.path.splitext(str(path))
    prj = base + '.prj'
    if os.path.exists(prj):
        with open(prj) as fh:
            return CRS.from_wkt(fh.read())
    return None


_PLAIN_IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.bmp')
_JP2_EXTS = ('.jp2', '.j2k', '.jpc', '.jpx')


def _open_plain_image(path, overview_level=None, device=None):
    """Plain image rasters (PNG/JPEG/BMP via OpenCV) with ESRI world-file
    and ``.prj`` sidecar georeferencing. Always eager; ``overview_level``
    is rejected (no pyramid)."""
    try:
        import cv2
    except ImportError:
        raise IOError('reading %s needs OpenCV (cv2), which is not '
                      'installed' % os.path.splitext(str(path))[1])
    if overview_level is not None:
        raise ValueError('plain image rasters carry no overview '
                         'pyramid; open the full resolution')
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError('OpenCV could not decode %s' % path)
    if img.ndim == 2:
        data = img[None]
    else:
        # BGR(A) -> RGB(A) band order, then (band, y, x)
        if img.shape[2] == 3:
            img = img[:, :, ::-1]
        elif img.shape[2] == 4:
            img = np.concatenate([img[:, :, 2::-1], img[:, :, 3:]],
                                 axis=2)
        data = np.moveaxis(img, 2, 0)
    return _raster_dataarray(data, _read_world_file(path),
                             _read_prj_file(path), nodata=None, is_tiled=0,
                             device=device)


def _raster_dataarray(data, transform, crs, nodata, is_tiled, device=None):
    """Assemble the (band, y, x) DataArray open_rasterio returns."""
    nbands, height, width = data.shape[0], data.shape[1], data.shape[2]
    attrs = {}
    coords = {'band': np.arange(1, nbands + 1)}
    if transform is not None:
        cols = np.arange(width) + 0.5
        rows = np.arange(height) + 0.5
        if transform.b or transform.d:
            C, R = np.meshgrid(cols, rows)
            coords['xc'] = (('y', 'x'),
                            transform.a * C + transform.b * R
                            + transform.c)
            coords['yc'] = (('y', 'x'),
                            transform.d * C + transform.e * R
                            + transform.f)
        else:
            coords['x'] = transform.a * cols + transform.c
            coords['y'] = transform.e * rows + transform.f
        attrs['transform'] = tuple(transform)[:6]
        attrs['res'] = (abs(transform.a), abs(transform.e))
    if crs is not None:
        attrs['crs'] = crs.to_proj4()
    if nodata is not None:
        attrs['nodatavals'] = (nodata,) * nbands
    attrs['is_tiled'] = int(is_tiled)
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data)
    return DataArray(data, dims=('band', 'y', 'x'), coords=coords,
                     attrs=attrs, device=device)


# GeoJP2: a uuid box whose payload is a degenerate GeoTIFF carrying the
# affine transform and the CRS (the convention GDAL writes and every
# Sentinel-2 granule uses)
_GEOJP2_UUID = bytes([0xb1, 0x4b, 0xf8, 0xbd, 0x08, 0x3d, 0x4b, 0x43,
                      0xa5, 0xae, 0x8c, 0xd7, 0xd5, 0xa6, 0xce, 0x03])


def _jp2_geo_box(path):
    """(transform, crs) from a JP2's GeoJP2 uuid box, or (None, None)
    where it has none or its GeoTIFF does not parse (the caller then
    reads the world file and ``.prj``, as ``nd_tpu`` does)."""
    import struct
    import tempfile
    from .geotiff import TiffFile
    with open(path, 'rb') as fh:
        buf = fh.read()
    if buf[4:8] != b'jP  ':
        return None, None
    pos = 0
    payload = None
    while pos + 8 <= len(buf):
        (lbox,) = struct.unpack('>I', buf[pos:pos + 4])
        tbox = buf[pos + 4:pos + 8]
        hdr = 8
        if lbox == 1:
            (lbox,) = struct.unpack('>Q', buf[pos + 8:pos + 16])
            hdr = 16
        elif lbox == 0:
            lbox = len(buf) - pos
        if tbox == b'uuid' \
                and buf[pos + hdr:pos + hdr + 16] == _GEOJP2_UUID:
            payload = buf[pos + hdr + 16:pos + lbox]
            break
        pos += lbox
    if payload is None:
        return None, None
    with tempfile.TemporaryDirectory() as tmp:
        carrier = os.path.join(tmp, 'geojp2.tif')
        with open(carrier, 'wb') as fh:
            fh.write(payload)
        try:
            with TiffFile(carrier) as t:
                return t.transform, t.crs
        except (OSError, ValueError, struct.error):
            return None, None


def _open_jp2(path, overview_level=None, device=None):
    """JPEG 2000 rasters through the built-in decoder (5/3 lossless and
    9/7 lossy, :mod:`.jp2`), with GeoJP2 / world-file / .prj
    georeferencing. ``overview_level`` k decodes the k-th dyadic
    overview (half resolution at 0, the GeoTIFF reader's first-overview
    convention): the DWT pyramid is the overview chain, so the decoder
    stops the synthesis and skips Tier-1 for the dropped resolutions."""
    from ..crs import Affine
    from .jp2 import decode_jp2
    reduce = 0 if overview_level is None else int(overview_level) + 1
    arr = decode_jp2(str(path), reduce=reduce)
    data = arr[None] if arr.ndim == 2 else np.moveaxis(arr, 2, 0)
    transform, crs = _jp2_geo_box(path)
    if transform is None:
        transform = _read_world_file(path)
    if crs is None:
        crs = _read_prj_file(path)
    if reduce and transform is not None:
        s = float(1 << reduce)
        t = transform
        transform = Affine(t.a * s, t.b * s, t.c, t.d * s, t.e * s, t.f)
    return _raster_dataarray(np.ascontiguousarray(data), transform, crs,
                             nodata=None, is_tiled=0, device=device)


def open_sentinel2_granule(path, resolution=None, bands=None,
                           overview_level=None, device=None):
    """Open a Sentinel-2 SAFE granule (the directory holding
    ``MTD_TL.xml`` + ``IMG_DATA/``) as a Dataset on ``device`` (default
    ``cuda``).

    The granule XML supplies the geolocation (``Tile_Geocoding``: EPSG
    code, per-resolution ULX/ULY/XDIM/YDIM and NROWS/NCOLS; parsed with
    ElementTree) and the band JP2s decode through the built-in JPEG 2000
    reader. A band's id is the last ``_`` field of its file stem.

    Parameters
    ----------
    path : str
        Granule directory, or the ``MTD_TL.xml`` path itself.
    resolution : int, optional
        Grid to load (10/20/60 m). Default: the finest present.
    bands : list of str, optional
        Band ids (e.g. ``['B02', 'B03']``). Default: every JP2 whose
        shape matches the chosen grid; a named band of another shape
        raises.
    overview_level : int, optional
        Dyadic overview to decode (0 = half resolution): the band JP2s'
        DWT pyramids stop early and the grid scales to match.
    """
    import glob
    import xml.etree.ElementTree as ET
    from ..crs import CRS
    from .jp2 import decode_jp2

    path = str(path)
    if os.path.isdir(path):
        cands = sorted(glob.glob(os.path.join(path, 'MTD_TL.xml'))) \
            or sorted(glob.glob(os.path.join(path, '*.xml')))
        if not cands:
            raise IOError('no granule XML found in %s' % path)
        xml_path = cands[0]
        gdir = path
    else:
        xml_path = path
        gdir = os.path.dirname(path)

    root = ET.parse(xml_path).getroot()

    def _findall(tag):
        return [e for e in root.iter() if e.tag.split('}')[-1] == tag]

    epsg = None
    for e in _findall('HORIZONTAL_CS_CODE'):
        epsg = e.text.strip()
        break
    geo = {}
    for e in _findall('Geoposition'):
        geo[int(e.get('resolution'))] = {
            c.tag.split('}')[-1]: float(c.text) for c in e}
    sizes = {}
    for e in _findall('Size'):
        sizes[int(e.get('resolution'))] = {
            c.tag.split('}')[-1]: int(c.text) for c in e}
    if not geo:
        raise IOError('granule XML carries no Geoposition')
    if resolution is None:
        resolution = min(geo)
    if resolution not in geo:
        raise ValueError('resolution %r not in granule (has %s)'
                         % (resolution, sorted(geo)))
    g = geo[resolution]
    ulx, uly = g['ULX'], g['ULY']
    xdim, ydim = g['XDIM'], g['YDIM']
    reduce = 0 if overview_level is None else int(overview_level) + 1
    if reduce:
        xdim *= float(1 << reduce)
        ydim *= float(1 << reduce)

    jp2s = sorted(glob.glob(os.path.join(gdir, 'IMG_DATA', '*.jp2'))
                  + glob.glob(os.path.join(gdir, 'IMG_DATA', '*', '*.jp2')))
    if not jp2s:
        raise IOError('no IMG_DATA JP2 bands under %s' % gdir)
    exp = sizes.get(resolution)
    if exp:
        rd = 1 << reduce
        exp = (-(-exp['NROWS'] // rd), -(-exp['NCOLS'] // rd))
    data_vars = {}
    ny = nx = None
    want = set(bands) if bands is not None else None
    for f in jp2s:
        band_id = os.path.splitext(os.path.basename(f))[0].split('_')[-1]
        if want is not None and band_id not in want:
            continue
        arr = decode_jp2(f, reduce=reduce)
        if arr.ndim != 2:
            continue
        if exp and arr.shape != exp:
            if want is not None:
                raise ValueError('band %s is %r, not the %d m grid %r'
                                 % (band_id, arr.shape, resolution, exp))
            continue
        data_vars[band_id] = (('y', 'x'), arr)
        ny, nx = arr.shape
    if not data_vars:
        raise IOError('no bands matched the %d m grid' % resolution)

    x = ulx + (np.arange(nx) + 0.5) * xdim
    y = uly + (np.arange(ny) + 0.5) * ydim
    attrs = {'transform': (xdim, 0.0, ulx, 0.0, ydim, uly),
             'res': (abs(xdim), abs(ydim))}
    if epsg:
        attrs['crs'] = CRS.from_user_input(epsg).to_proj4()
    return Dataset(data_vars, coords={'y': y, 'x': x}, attrs=attrs,
                   device=device)


def open_rasterio(path, chunks=None, overview_level=None, device=None,
                  *args, **kwargs):
    """Read a raster (GeoTIFF, or PNG/JPEG/BMP with world-file sidecars)
    into a (band, y, x) DataArray on ``device`` (default ``cuda``).

    Coordinates are pixel-center positions from the affine transform;
    attrs carry transform/crs/res/nodatavals. ``overview_level`` selects
    a reduced-resolution overview IFD (0 = first/largest): the raster
    decodes at that decimation and the transform/coords scale to match.

    With ``chunks`` not None (e.g. ``chunks={}``) the payload is a lazy
    windowed view (:class:`~nd_tpu_torch.io.lazy.LazyGeoTIFFArray`):
    nothing is decoded at open time, and a slice decodes only the strips
    or tiles its window touches. Plain images decode eagerly (they have
    no windowed layout). JPEG 2000 (``.jp2``, ``.j2k``, ``.jpc``,
    ``.jpx``) decodes eagerly too and ignores ``chunks``; its
    ``overview_level`` is a dyadic level of the wavelet pyramid.
    """
    from .geotiff import TiffFile
    ext = os.path.splitext(str(path))[1].lower()
    if ext in _PLAIN_IMAGE_EXTS:
        return _open_plain_image(path, overview_level=overview_level,
                                 device=device)
    if ext in _JP2_EXTS:
        return _open_jp2(path, overview_level=overview_level, device=device)
    if chunks is not None and overview_level is not None:
        raise ValueError(
            'pass either chunks= (lazy full-resolution view) or '
            'overview_level= (eager decimated read), not both')
    with TiffFile(str(path)) as t:
        width, height = t.width, t.height
        if overview_level is not None:
            data = t.read_overview(int(overview_level))
        elif chunks is not None:
            from .lazy import LazyGeoTIFFArray
            data = LazyGeoTIFFArray.from_file(
                str(path), (t.nbands, height, width), t.band_dtype)
        else:
            data = t.read()
        transform = t.transform
        if overview_level is not None and transform is not None:
            # decimated pixels cover width/ov_w source pixels each
            from ..crs import Affine
            transform = transform * Affine.scale(width / data.shape[2],
                                                 height / data.shape[1])
        crs = t.crs
        nodata = t.nodata
        is_tiled = int(322 in t.tags)
    return _raster_dataarray(data, transform, crs, nodata, is_tiled,
                             device=device)


def to_geotiff(ds, path, nodata=None, compress=True, tiled=False,
               tile_size=256, overviews=None):
    """Write a Dataset/DataArray to a GeoTIFF.

    A Dataset writes one band per (y, x) variable; a DataArray writes
    its (possibly banded) raster directly. Geo-metadata is taken from
    the object (``warp.get_transform`` / ``get_crs``). ``tiled=True`` +
    ``overviews=True`` (or a list of decimation factors) writes the
    cloud-optimized layout: square internal tiles plus a
    reduced-resolution overview pyramid.
    """
    from ..crs import Affine
    from ..warp import get_crs, get_transform
    from .geotiff import write_geotiff

    transform = get_transform(ds)
    if transform is not None:
        # the framework's transform maps pixel index -> coordinate
        # (corner-grid convention); GeoTIFF anchors the transform at
        # the outer corner of pixel (0, 0) with centers at +0.5
        transform = transform * Affine.translation(-0.5, -0.5)
    crs = get_crs(ds)
    if isinstance(ds, Dataset):
        bands = []
        for v in utils.get_vars_for_dims(ds, ('y', 'x')):
            da = ds[v].transpose('y', 'x', *[
                d for d in ds[v].dims if d not in ('y', 'x')])
            vals = np.asarray(da.values)
            vals = vals.reshape(vals.shape[0], vals.shape[1], -1)
            for b in range(vals.shape[2]):
                bands.append(vals[:, :, b])
        data = np.stack(bands, axis=0)
    else:
        da = ds
        order = [d for d in ('band',) if d in da.dims] + ['y', 'x']
        extra = [d for d in da.dims if d not in order]
        da = da.transpose(*(extra + order))
        data = np.asarray(da.values)
        data = data.reshape((-1,) + data.shape[-2:])
    write_geotiff(path, data, transform=transform, crs=crs,
                  nodata=nodata, compress=compress, tiled=tiled,
                  tile_size=tile_size, overviews=overviews)
    return path


from .beam_dimap import open_beam_dimap  # noqa: E402
