"""BEAM-DIMAP (.dim) product reader, SNAP's native format: the port's
own copy of ``nd_tpu/io/beam_dimap.py``, parsing the XML with the
standard library's ``xml.etree.ElementTree`` (every path it reads is in
ElementTree's XPath subset) and the bands with :mod:`.envi`.

A product is a ``*.dim`` XML file plus a ``*.data`` directory of ENVI
rasters; geolocation comes either from an affine image-to-model
transform or from tie-point grids interpolated to the full raster on the
host (``scipy.ndimage.map_coordinates``). Dates in SNAP's
``03-Jan-2023 10:00:00.000000`` form go through ``utils.str2date``.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .. import utils
from ..core import Dataset
from ..core.variable import Variable
from ..crs import Affine
from .envi import EnviRaster

__all__ = ['open_beam_dimap']


def open_beam_dimap(path, read_data=True, as_complex=True, device=None):
    """Read a BEAM-DIMAP product into a Dataset.

    Parameters
    ----------
    path : str
        Path to the ``*.dim`` XML file.
    read_data : bool, optional
        If True (default) read all bands, otherwise metadata only.
    as_complex : bool, optional
        Reassemble ``*_real``/``*_imag`` band pairs into complex
        variables (default: True).
    device : torch.device or str, optional
        Where the bands and numeric coordinates land (default ``cuda``).
    """
    import xml.etree.ElementTree as ET
    from . import assemble_complex

    basepath = os.path.split(path)[0]
    meta = {}
    tree = ET.parse(path)
    root = tree.getroot()

    data_files = [os.path.join(basepath, _.attrib['href']) for _ in
                  root.findall('.//Data_File/DATA_FILE_PATH')]
    tie_point_grid_files = [
        os.path.join(basepath, _.attrib['href']) for _ in
        root.findall('.//Tie_Point_Grid_File/TIE_POINT_GRID_FILE_PATH')]

    def _mdattr(name, cast=str):
        el = root.find('.//Dataset_Sources//MDATTR[@name="%s"]' % name)
        return cast(el.text) if el is not None else None

    meta['ncols'] = int(root.find('.//Raster_Dimensions/NCOLS').text)
    meta['nrows'] = int(root.find('.//Raster_Dimensions/NROWS').text)
    meta['nbands'] = int(root.find('.//Raster_Dimensions/NBANDS').text)
    for key, mdname, cast in [
            ('time_start', 'first_line_time', str),
            ('orbit_direction', 'PASS', str),
            ('mode', 'ACQUISITION_MODE', str),
            ('rel_orbit', 'REL_ORBIT', int),
            ('abs_orbit', 'ABS_ORBIT', int),
            ('orbit_cycle', 'orbit_cycle', int)]:
        val = _mdattr(mdname, cast)
        if val is not None:
            meta[key] = val
    lats = [_mdattr(n, float) for n in
            ('first_near_lat', 'first_far_lat', 'last_near_lat',
             'last_far_lat')]
    lons = [_mdattr(n, float) for n in
            ('first_near_long', 'first_far_long', 'last_near_long',
             'last_far_long')]
    if all(v is not None for v in lons):
        meta['lon_range'] = (min(lons), max(lons))
    if all(v is not None for v in lats):
        meta['lat_range'] = (min(lats), max(lats))

    # ----------------------------------------------------------------
    # Geolocation: affine transform (option A) or tie-point grids (B)
    # ----------------------------------------------------------------
    crs_info = root.find('./Coordinate_Reference_System/WKT')
    transf_info = root.find('./Geoposition/IMAGE_TO_MODEL_TRANSFORM')

    tp_grids = {}
    for tf in tie_point_grid_files:
        p = os.path.splitext(tf)[0] + '.img'
        name = os.path.split(os.path.splitext(tf)[0])[1]
        tp_grids[name] = EnviRaster(p).read(1)

    coords = {}
    if crs_info is not None and transf_info is not None:
        transf = np.array([float(_) for _ in transf_info.text.split(',')])
        # SNAP serializes column-major (a, d, b, e, c, f); to GDAL order:
        transf_gdal = transf[::-1].reshape((3, 2)).T.flatten()
        aff = Affine.from_gdal(*transf_gdal)
        meta['GeoTransform'] = tuple(transf_gdal)
        meta['coordinate_system_string'] = crs_info.text.strip() \
            if crs_info.text else None
        if meta['coordinate_system_string'] is None:
            del meta['coordinate_system_string']

        if aff.b == 0 and aff.d == 0:
            # north-up image: 1-d lat/lon coordinate arrays
            meta['pixel_height'] = abs(aff.a)
            meta['pixel_width'] = abs(aff.e)
            rows = np.arange(meta['nrows'])
            cols = np.arange(meta['ncols'])
            # In SNAP's reordered-GDAL frame (a, c) are the LATITUDE scale/offset applied to row
            # indices and (e, f) the LONGITUDE ones applied to columns:
            # lat = (aff * (rows, 0))[0], lon = (aff * (0, cols))[1].
            lat = aff.a * rows + aff.c
            lon = aff.e * cols + aff.f
            coords = {'lat': ('lat', lat), 'lon': ('lon', lon)}
        # else: leave pixel coordinates (y, x)

    elif 'latitude' in tp_grids and 'longitude' in tp_grids:
        from scipy.ndimage import map_coordinates
        shp = tp_grids['latitude'].shape
        xstep = (meta['ncols'] - 1) / (shp[1] - 1)
        ystep = (meta['nrows'] - 1) / (shp[0] - 1)
        xs = np.linspace(0, meta['ncols'] - 1, shp[1])
        ys = np.linspace(0, meta['nrows'] - 1, shp[0])
        xi, yi = xs.astype(int), ys.astype(int)
        xg, yg = np.meshgrid(xi, yi, copy=False)
        map_xy = np.stack((yg.astype(float) / ystep,
                           xg.astype(float) / xstep), axis=0)
        tp_sparse = {}
        # only the geolocation grids become coords — interpolating the
        # other tie-point grids (incidence angle, slant range, ...)
        # would cost a full-raster f64 allocation + cubic pass EACH,
        # all discarded
        for name in ('latitude', 'longitude'):
            tpg = tp_grids[name]
            interp = map_coordinates(tpg, map_xy, output=tpg.dtype,
                                     order=3, cval=np.nan)
            sparse = np.full((meta['nrows'], meta['ncols']), np.nan)
            sparse[yi[:, np.newaxis], xi] = interp
            tp_sparse[name] = sparse
        coords = {'lat': (('y', 'x'), tp_sparse['latitude']),
                  'lon': (('y', 'x'), tp_sparse['longitude'])}

    if 'time_start' in meta:
        coords['time'] = np.asarray(
            [np.datetime64(utils.str2date(meta['time_start']), 'ns')])

    ds = Dataset(coords=coords, attrs=meta, device=device)

    if read_data:
        band_attr_sets = {}
        dims2d = ('lat', 'lon') if 'lat' in coords and \
            ds._coords.get('lat') is not None and \
            ds._coords['lat'].dims == ('lat',) else ('y', 'x')
        for rpath in data_files:
            im_path = os.path.splitext(rpath)[0] + '.img'
            name = os.path.splitext(os.path.split(im_path)[1])[0]
            raster = EnviRaster(im_path)
            attrs = {}
            desc = raster.header.get('description', '')
            # SNAP embeds the unit as '... - Unit: X' free text; only
            # the parsed unit belongs in a 'units' attr (the raw
            # description is NOT a unit and would mislead CF readers)
            m = re.search(r'Unit:\s*([^}\s][^}]*)', str(desc))
            if desc:
                attrs['description'] = str(desc)
            if m:
                attrs['units'] = m.group(1).strip()
            if raster.crs_wkt:
                attrs['coordinate_system_string'] = raster.crs_wkt
            if raster.transform is not None:
                attrs['transform'] = tuple(raster.transform)[:6]
            if raster.bands > 1:
                # keep every band as a (band, y, x) array
                arr = raster.read()
                ds._variables[name] = Variable(('band',) + dims2d,
                                               arr, attrs, device=device)
                if 'band' not in ds._coords:
                    ds._coords['band'] = Variable(
                        ('band',), np.arange(1, raster.bands + 1),
                        device=device)
            else:
                arr = raster.read(1)
                ds._variables[name] = Variable(dims2d, arr, attrs,
                                               device=device)
            band_attr_sets[name] = attrs
        # Lift attributes shared by every band onto the dataset.
        if band_attr_sets:
            names = list(band_attr_sets)
            common = dict(band_attr_sets[names[0]])
            for n in names[1:]:
                for k in list(common):
                    if band_attr_sets[n].get(k) != common[k]:
                        del common[k]
            for k, v in common.items():
                ds.attrs[k] = v
                for n in names:
                    ds._variables[n].attrs.pop(k, None)

    if as_complex:
        ds = assemble_complex(ds)
    return ds
