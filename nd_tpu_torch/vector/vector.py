"""Vector data ingestion and rasterization onto a reference grid.

Counterpart of ``nd_tpu/vector/vector.py``: vector tables are pandas
DataFrames carrying a ``geometry`` column of
:mod:`nd_tpu_torch.vector.geometry` objects and a ``.attrs['crs']``
entry. pandas is imported by the functions that build or read a table,
so the module itself (and :func:`~.shapefile.read_shapefile`) imports
where pandas is missing. Rasterization burns polygons on the reference
grid's device (:mod:`nd_tpu_torch.ops.rasterize`).
"""

from __future__ import annotations

import datetime
import json
import os

import numpy as np
import torch

from .. import warp
from ..core import Dataset
from ..core import variable
from ..core.variable import Variable, torch_dtype
from ..crs import transform_coords
from .geometry import mapping
from .geometry import shape as geom_shape
from .geometry import transform_geom
from .shapefile import read_shapefile

__all__ = ['read_file', 'to_file', 'rasterize']


def _set_crs(df, crs):
    df.attrs['crs'] = crs
    return df


def get_crs_of(df):
    return df.attrs.get('crs')


def read_file(path, clip=None):
    """Read a geospatial vector file (Shapefile or GeoJSON).

    Parameters
    ----------
    path : str
        The file to read.
    clip : geometry, optional
        Only keep features intersecting this geometry.

    Returns
    -------
    pandas.DataFrame
        A table with a ``geometry`` column; CRS in ``df.attrs['crs']``.
    """
    import pandas as pd
    ext = os.path.splitext(path)[1].lower()
    if ext in ('.shp', '.dbf', '.shx'):
        geoms, records, crs_wkt = read_shapefile(path)
    elif ext in ('.geojson', '.json'):
        with open(path) as fh:
            gj = json.load(fh)
        geoms = []
        records = []
        for feat in gj.get('features', []):
            if feat.get('geometry') is None:
                continue
            geoms.append(geom_shape(feat['geometry']))
            records.append(feat.get('properties', {}))
        crs_wkt = None
    else:
        raise IOError('unsupported vector format %r' % ext)

    rows = []
    kept_geoms = []
    for geom, rec in zip(geoms, records):
        if geom is None or rec is None:   # rec None = deleted DBF row
            continue
        if clip is not None and not geom.intersects(clip):
            continue
        rows.append(rec)
        kept_geoms.append(geom)

    df = pd.DataFrame(rows if rows else None)
    df['geometry'] = kept_geoms
    crs = None
    if crs_wkt:
        try:
            crs = warp._parse_crs(crs_wkt)
        except warp.CRSError:
            crs = None                 # a .prj the parser does not know
    return _set_crs(df, crs)


def _to_crs(df, dst_crs):
    src_crs = get_crs_of(df)
    if src_crs is None or src_crs == dst_crs:
        return df

    def project(xs, ys):
        return transform_coords(src_crs, dst_crs, np.asarray(xs),
                                np.asarray(ys), xp=np)

    out = df.copy()
    out['geometry'] = [transform_geom(project, g)
                       for g in df['geometry']]
    return _set_crs(out, dst_crs)


def rasterize(shp, ds, columns=None, encode_labels=True, crs=None,
              date_field=None, date_fmt=None, device=None):
    """Rasterize vector features onto the grid of a reference dataset.

    Parameters
    ----------
    shp : str or DataFrame
        A vector file path or a table with a ``geometry`` column.
    ds : Dataset
        The reference raster whose grid to match.
    columns : list of str, optional
        Attribute columns to rasterize (default: all).
    encode_labels : bool, optional
        Factorize categorical columns to integers, storing the lookup in
        the ``legend`` attribute (default: True).
    crs : CRS-like, optional
        CRS of the vector data (overrides the file CRS).
    date_field : str, optional
        Column holding per-feature timestamps; becomes the time axis.
    date_fmt : str, optional
        Format string for parsing ``date_field``.
    device : torch.device or str, optional
        Where the numeric layers land: by default the device of ``ds``'s
        tensors, else ``cuda``.

    Returns
    -------
    Dataset
        One (y, x, time) variable per attribute column.
    """
    import pandas as pd

    from ..ops.rasterize import polygon_mask, rasterize_values

    geom = warp.get_geometry(ds, crs=warp.get_crs(ds))
    transf = warp.get_transform(ds)
    if device is None:
        device = warp._device_of(ds) or variable.DEFAULT_DEVICE
    device = torch.device(device)

    if isinstance(shp, str):
        shp = read_file(shp, clip=geom)
    else:
        shp = shp.copy()
        shp.attrs = dict(getattr(shp, 'attrs', {}))

    if crs is not None:
        _set_crs(shp, warp._parse_crs(crs))
    if get_crs_of(shp) is not None:
        shp = _to_crs(shp, warp.get_crs(ds))

    ys = np.asarray(ds.coords['y'].values)
    xs = np.asarray(ds.coords['x'].values)
    layer = Dataset(coords={'y': ys, 'x': xs},
                    attrs={'transform': tuple(transf)[:6],
                           'crs': warp.get_crs(ds).to_proj4()},
                    device=device)

    exclude_columns = ['geometry', date_field]

    if date_field is None:
        shp['__date__'] = pd.to_datetime(datetime.date.today())
        date_field = '__date__'
        exclude_columns.append('__date__')
    else:
        if date_field not in shp:
            raise ValueError('Field {} does not exist.'
                             .format(date_field))
        shp[date_field] = pd.to_datetime(shp[date_field],
                                         format=date_fmt)

    if columns is not None:
        keep = list(set(columns + ['geometry', date_field]))
        shp = shp[[c for c in keep if c in shp.columns]]

    dates = np.asarray(shp[date_field].values, dtype='datetime64[ns]')
    times = np.unique(dates)
    layer._coords['time'] = Variable(('time',), times)
    shape = (len(ys), len(xs), len(times))

    for c in shp.columns:
        if c in exclude_columns:
            continue
        data = shp[c]
        meta = {}

        categorical = not np.issubdtype(
            np.asarray(data.values).dtype if data.dtype != object
            else np.dtype(object), np.number)
        if data.dtype == object or categorical:
            if encode_labels:
                codes, legend = pd.factorize(data)
                data = pd.Series(codes + 1, index=shp.index)
                meta['legend'] = list(enumerate([None] + list(legend)))
                categorical = False
            else:
                categorical = True

        if categorical:
            out = np.empty(shape, dtype=object)
        else:
            dtype = np.asarray(data.values).dtype
            out = torch.zeros(shape, dtype=torch_dtype(dtype),
                              device=device)

        for ti, t in enumerate(times):
            mask_t = dates == t
            geom_t = list(shp['geometry'][mask_t])
            data_t = np.asarray(data[mask_t])
            if len(geom_t) == 0:
                continue
            if not categorical:
                out[:, :, ti] = rasterize_values(
                    zip(geom_t, data_t), xs, ys, fill=0, dtype=dtype,
                    device=device)
            else:
                frame = out[:, :, ti]
                for value in np.unique(data_t[data_t.astype(bool)]):
                    for g, v in zip(geom_t, data_t):
                        if v != value:
                            continue
                        m = polygon_mask(g, xs, ys, device=device)
                        frame[m.cpu().numpy()] = value

        layer[c] = (('y', 'x', 'time'), out)
        layer._variables[c].attrs.update(meta)

    return layer


def to_file(df, path, crs=None):
    """Write a geometry table to GeoJSON (RFC 7946).

    The inverse of :func:`read_file` for the GeoJSON flavor.
    Geometries are emitted as GeoJSON mappings; every other column
    becomes a feature property (numpy scalars converted, datetimes as
    ISO strings). RFC 7946 expects WGS84 coordinates: a table carrying
    a different CRS is reprojected to EPSG:4326 first (pass ``crs`` to
    declare the table's CRS when ``df.attrs`` lacks one).

    Parameters
    ----------
    df : pandas.DataFrame
        Table with a ``geometry`` column (as from :func:`read_file`).
    path : str
        Output ``.geojson`` path.
    crs : CRS-like, optional
        CRS of the table's coordinates if not recorded in
        ``df.attrs['crs']``.
    """
    import pandas as pd
    src_crs = get_crs_of(df)
    if src_crs is None and crs is not None:
        df = _set_crs(df.copy(), warp._parse_crs(crs))
        src_crs = get_crs_of(df)
    if src_crs is not None:
        df = _to_crs(df, warp._parse_crs('epsg:4326'))

    def _prop(v):
        if v is None:
            return None
        if isinstance(v, (np.floating, np.integer, np.bool_)):
            v = v.item()
        if isinstance(v, float) and np.isnan(v):
            return None
        if isinstance(v, np.datetime64):
            if np.isnat(v):
                return None            # NaT is a missing value, not
            return np.datetime_as_string(v, unit='s')
        if v is pd.NaT or (hasattr(v, 'isoformat')
                           and str(v) == 'NaT'):
            return None                # the string 'NaT'
        if hasattr(v, 'isoformat'):
            return v.isoformat()
        if isinstance(v, (int, float, bool, str)):
            return v
        return str(v)

    features = []
    prop_cols = [c for c in df.columns if c != 'geometry']
    for _, row in df.iterrows():
        geom = row['geometry']
        features.append({
            'type': 'Feature',
            'geometry': None if geom is None else mapping(geom),
            'properties': {c: _prop(row[c]) for c in prop_cols},
        })
    doc = {'type': 'FeatureCollection', 'features': features}
    tmp = str(path) + '.part'
    with open(tmp, 'w') as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return path
