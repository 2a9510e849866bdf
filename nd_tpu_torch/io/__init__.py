"""I/O layer: netCDF, GeoTIFF, ENVI, zarr, BEAM-DIMAP and the complex
(dis)assembly of variables.

Counterpart of ``nd_tpu/io/__init__.py``. The readers and writers are
host-side numpy, as in the JAX package: a reader puts numeric data on
``device`` (``cuda`` unless the caller names another), a writer copies
each variable of a CUDA dataset to the host once. netCDF-4 needs
``h5py``; without it netCDF classic is read and written
(:mod:`.netcdf`). ``chunks=`` opens netCDF and GeoTIFF files lazily
(:mod:`.lazy`): nothing is read until it is used, and a slab read onto
the card or written to another file reads only itself. Not ported yet:
JPEG 2000 with the Sentinel-2 granule reader (ROADMAP item 18).
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
           'open_rasterio', 'to_netcdf', 'to_geotiff', 'to_zarr',
           'open_zarr', 'assemble_complex', 'disassemble_complex',
           'add_time']


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
    no windowed layout). JPEG 2000 raises until ROADMAP item 18.
    """
    from .geotiff import TiffFile
    ext = os.path.splitext(str(path))[1].lower()
    if ext in _PLAIN_IMAGE_EXTS:
        return _open_plain_image(path, overview_level=overview_level,
                                 device=device)
    if ext in _JP2_EXTS:
        raise NotImplementedError(
            'JPEG 2000 (%s) is not ported yet: the decoder comes with the '
            'Sentinel-2 granule reader (ROADMAP item 18)' % ext)
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
