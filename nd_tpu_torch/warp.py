"""Projection and warping: reprojection between CRS, resampling,
time-series coregistration, and geospatial metadata.

Counterpart of ``nd_tpu/warp.py``. The coordinate transform of a warp
runs once per geometry on the host in float64 numpy (``crs``), and the
sampling runs on the data's device (``ops.interp``): dense matmuls for
separable warps in float32, gathers otherwise, footprint statistics for
downsampling. Coregistration is phase correlation on ``torch.fft`` and a
Catmull-Rom translation (``ops.fft``). The grid convention: the
coordinate of pixel (row, col) is ``transform * (col, row)``.

``Alignment`` reprojects products onto one shared grid and writes each
to netCDF (``io.to_netcdf``). ``get_geometry`` gives the grid's
bounding box as a polygon of :mod:`nd_tpu_torch.vector`.
"""

from __future__ import annotations

import functools
import glob
import os
import warnings
from collections import namedtuple

import numpy as np
import torch

from .algorithm import Algorithm, parallelize, wrap_algorithm
from .core import DataArray, Dataset
from .core.variable import Variable, to_numpy
from .crs import CRS, Affine, transform_coords
from .io import disassemble_complex, open_dataset, to_netcdf
from .ops.fft import phase_cross_correlation_batch, translate_batch
from .ops.interp import (FOOTPRINT_SPAN_CAP, FOOTPRINT_STATS, axis_weights,
                         footprint_axis, footprint_resample,
                         grid_from_transforms, map_coordinates,
                         matmul_resample, separable_coords)
from .utils import get_dims, get_vars_for_dims

__all__ = ['Reprojection', 'reproject', 'Resample', 'resample',
           'Alignment', 'align', 'Coregistration', 'coregister',
           'get_crs', 'get_transform', 'get_resolution', 'get_bounds',
           'get_extent', 'get_geometry', 'get_common_bounds',
           'get_common_extent', 'get_common_resolution', 'nrows',
           'ncols', 'get_dim_sizes', 'calculate_default_transform',
           'transform_bounds']

BoundingBox = namedtuple('BoundingBox', ['left', 'bottom', 'right', 'top'])


class CRSError(ValueError):
    pass


def _get_projection_dim_order(ds):
    """Dimension order for projection ops: x and y last."""
    dims = get_dims(ds)
    extra = tuple(d for d in dims if d not in ('y', 'x'))
    return extra + ('y', 'x')


def _parse_crs(crs):
    """Parse a CRS from proj-string, dict, WKT, EPSG int or CRS."""
    try:
        return CRS.from_user_input(crs)
    except (ValueError, NotImplementedError) as e:
        raise CRSError('Could not parse CRS: {} ({})'.format(crs, e))


def _device_of(ds):
    """The device of a Dataset's or DataArray's tensors (the first data
    variable's), where the warp puts its coordinates and results."""
    datas = [ds.data] if isinstance(ds, DataArray) \
        else [v.data for v in ds._variables.values()]
    for d in datas:
        if isinstance(d, torch.Tensor):
            return d.device
    return None


def get_crs(ds, format='crs'):
    """Extract the CRS from a dataset.

    Resolution order: ``attrs['crs']`` -> ``attrs['coordinate_system_
    string']`` -> attributes of a SNAP-style ``crs`` data variable.

    Parameters
    ----------
    ds : Dataset or DataArray
    format : str {'crs', 'proj', 'dict', 'wkt'}
    """
    crs = None
    if 'crs' in ds.attrs:
        crs = _parse_crs(ds.attrs['crs'])
    elif 'coordinate_system_string' in ds.attrs:
        crs = _parse_crs(ds.attrs['coordinate_system_string'])
    elif isinstance(ds, Dataset) and 'crs' in ds.data_vars:
        for attr_val in ds['crs'].attrs.values():
            for candidate in (attr_val,
                              attr_val[0] if isinstance(
                                  attr_val, (list, tuple, np.ndarray))
                              and len(attr_val) else None):
                if candidate is None:
                    continue
                try:
                    crs = _parse_crs(candidate)
                    break
                except CRSError:
                    continue
            if crs is not None:
                break

    if crs is None:
        return None
    if format == 'crs':
        return crs
    if format == 'proj':
        return crs.to_proj4()
    if format == 'dict':
        return crs.to_dict()
    if format == 'wkt':
        return crs.wkt
    raise ValueError('unknown format %r' % format)


# ------------------------------------------
# Geospatial parameters from coordinates
# ------------------------------------------

def get_transform(ds):
    """The affine transform mapping (col, row) to (x, y)."""
    if 'x' in ds.coords and 'y' in ds.coords:
        x = np.asarray(ds.coords['x'].values, dtype=np.float64)
        y = np.asarray(ds.coords['y'].values, dtype=np.float64)
        resx = (x[-1] - x[0]) / (len(x) - 1)
        resy = (y[-1] - y[0]) / (len(y) - 1)
        return Affine(resx, 0, x[0], 0, resy, y[0])
    return _get_transform_from_metadata(ds)


def get_resolution(ds):
    """The raster resolution as (x, y)."""
    if 'x' in ds.coords and 'y' in ds.coords:
        x = np.asarray(ds.coords['x'].values, dtype=np.float64)
        y = np.asarray(ds.coords['y'].values, dtype=np.float64)
        resx = abs(x[-1] - x[0]) / (len(x) - 1)
        resy = abs(y[-1] - y[0]) / (len(y) - 1)
        return (resx, resy)
    return _get_resolution_from_metadata(ds)


def get_bounds(ds):
    """Bounding box (left, bottom, right, top) in projection coords."""
    if 'x' in ds.coords and 'y' in ds.coords:
        return BoundingBox(
            left=float(np.min(ds.coords['x'].values)),
            bottom=float(np.min(ds.coords['y'].values)),
            right=float(np.max(ds.coords['x'].values)),
            top=float(np.max(ds.coords['y'].values)))
    return _get_bounds_from_metadata(ds)


def transform_bounds(src_crs, dst_crs, left, bottom, right, top,
                     densify_pts=21):
    """Transform a bounding box between CRS (densified edges)."""
    src_crs = _parse_crs(src_crs)
    dst_crs = _parse_crs(dst_crs)
    if src_crs == dst_crs:
        return BoundingBox(left, bottom, right, top)
    n = densify_pts
    xs = np.linspace(left, right, n)
    ys = np.linspace(bottom, top, n)
    edge_x = np.concatenate([xs, xs, np.full(n, left),
                             np.full(n, right)])
    edge_y = np.concatenate([np.full(n, bottom), np.full(n, top),
                             ys, ys])
    tx, ty = transform_coords(src_crs, dst_crs, edge_x, edge_y, xp=np)
    ok = np.isfinite(tx) & np.isfinite(ty)
    return BoundingBox(float(np.min(tx[ok])), float(np.min(ty[ok])),
                       float(np.max(tx[ok])), float(np.max(ty[ok])))


def get_extent(ds):
    """Extent (left, bottom, right, top) in lat/lon (EPSG:4326)."""
    if 'lon' in ds.coords and 'lat' in ds.coords:
        lon = np.asarray(ds.coords['lon'].values)
        lat = np.asarray(ds.coords['lat'].values)
        return BoundingBox(
            left=float(np.nanmin(lon)), bottom=float(np.nanmin(lat)),
            right=float(np.nanmax(lon)), top=float(np.nanmax(lat)))
    src_crs = get_crs(ds)
    if src_crs is None:
        raise CRSError('Could not determine the CRS.')
    return transform_bounds(src_crs, CRS.from_epsg(4326),
                            *get_bounds(ds))


def get_geometry(ds, crs={'init': 'epsg:4326'}):
    """Bounding-box polygon of the dataset in the given CRS."""
    from .vector.geometry import box, transform_geom
    src_geometry = box(*get_bounds(ds))
    src_crs = get_crs(ds)
    dst_crs = _parse_crs(crs)

    def project(xs, ys):
        return transform_coords(src_crs, dst_crs, np.asarray(xs),
                                np.asarray(ys), xp=np)

    return transform_geom(project, src_geometry)


# ---------------------------------------
# Geospatial parameters from metadata
# ---------------------------------------

def _snap_i2m_values(ds):
    """Six floats of a SNAP image-to-model transform, or None.

    SNAP stores the affine on the ``crs`` data variable as a
    comma-separated ``i2m`` attribute in java.awt.geom order
    (m00, m10, m01, m11, m02, m12).
    """
    if not isinstance(ds, Dataset) or 'crs' not in ds.data_vars:
        return None
    raw = ds['crs'].attrs.get('i2m')
    if raw is None:
        return None
    if isinstance(raw, np.ndarray):
        raw = raw.item() if raw.size == 1 else raw.tolist()
    return [float(tok) for tok in str(raw).split(',')]


def _get_transform_from_metadata(ds):
    stored = ds.attrs.get('transform')
    if stored is not None:
        if isinstance(stored, Affine):
            return stored
        return Affine(*np.ravel(np.asarray(stored))[:6])
    i2m = _snap_i2m_values(ds)
    if i2m is not None:
        m00, m10, m01, m11, m02, m12 = i2m
        # java.awt column-vector order -> Affine's row-major (a b c d e f)
        return Affine(m00, m01, m02, m10, m11, m12)
    return None


def _get_bounds_from_metadata(ds):
    transform = _get_transform_from_metadata(ds)
    if transform is None:
        stored = ds.attrs.get('bounds')
        return None if stored is None else BoundingBox(*stored)
    # envelope of the four pixel-grid corners (handles rotated grids)
    last_col, last_row = ds.sizes['x'] - 1, ds.sizes['y'] - 1
    pts = [transform * (c, r)
           for c in (0, last_col) for r in (0, last_row)]
    xs, ys = zip(*pts)
    return BoundingBox(left=min(xs), bottom=min(ys),
                       right=max(xs), top=max(ys))


def _get_resolution_from_metadata(ds):
    transform = _get_transform_from_metadata(ds)
    if transform is None:
        stored = ds.attrs.get('res')
        return None if stored is None else tuple(stored)
    return (abs(transform.a), abs(transform.e))


def get_common_bounds(datasets):
    """Common bounding box of the datasets (in the first one's CRS)."""
    bounds = []
    common_crs = get_crs(datasets[0])
    for ds in datasets:
        ds_bounds = get_bounds(ds)
        crs = get_crs(ds)
        proj_bounds = transform_bounds(crs, common_crs, *ds_bounds)
        bounds.append(proj_bounds)
    bounds = np.array(bounds)
    common = np.concatenate((bounds[:, :2].min(axis=0),
                             bounds[:, 2:].max(axis=0)))
    return BoundingBox(*common)


def get_common_extent(datasets):
    """Smallest lat/lon extent containing all input datasets."""
    common_bounds = get_common_bounds(datasets)
    common_crs = get_crs(datasets[0])
    return transform_bounds(common_crs, CRS.from_epsg(4326),
                            *common_bounds)


def get_common_resolution(datasets, mode='min'):
    """Common resolution of the datasets ('min', 'max' or 'mean')."""
    if mode not in ['min', 'max', 'mean']:
        raise ValueError("Unsupported mode: '{}'".format(mode))
    crs = [get_crs(ds) for ds in datasets]
    if not all(c == crs[0] for c in crs):
        raise ValueError('All datasets must have the same projection.')
    resolutions = np.array([get_resolution(ds) for ds in datasets])
    if mode == 'min':
        return tuple(resolutions.min(axis=0))
    if mode == 'max':
        return tuple(resolutions.max(axis=0))
    return tuple(resolutions.mean(axis=0))


def get_dim_sizes(ds):
    """Mapping dim -> size for a Dataset or DataArray."""
    return dict(ds.sizes)


def nrows(ds):
    return ds.sizes['y']


def ncols(ds):
    return ds.sizes['x']


def _add_latlon(ds, device, n=50):
    """Attach sparse (y, x) lat/lon tie-point coordinates on
    ``device``."""
    nx = ncols(ds)
    ny = nrows(ds)
    src_crs = get_crs(ds)
    dst_crs = CRS.from_epsg(4326)
    n = min(n, nx, ny)
    idx_x = np.linspace(0, nx - 1, n, dtype=int)
    idx_y = np.linspace(0, ny - 1, n, dtype=int)
    xs = np.asarray(ds.coords['x'].values)[idx_x]
    ys = np.asarray(ds.coords['y'].values)[idx_y]
    xgrid, ygrid = np.meshgrid(xs, ys)
    lon, lat = transform_coords(src_crs, dst_crs, xgrid.ravel(),
                                ygrid.ravel(), xp=np)
    lon_sparse = np.full((ny, nx), np.nan)
    lat_sparse = np.full((ny, nx), np.nan)
    lon_sparse[idx_y[:, None], idx_x] = np.asarray(lon).reshape((n, n))
    lat_sparse[idx_y[:, None], idx_x] = np.asarray(lat).reshape((n, n))
    ds._coords['lat'] = Variable(('y', 'x'), lat_sparse, device=device)
    ds._coords['lon'] = Variable(('y', 'x'), lon_sparse, device=device)


def _expand_var_to_xy(da, coords, device):
    """Broadcast a 1-d x or y variable onto the full (y, x) grid."""
    if 'x' in da.dims and 'y' in da.dims:
        return da
    if 'x' in da.dims:
        new_dim = 'y'
    elif 'y' in da.dims:
        new_dim = 'x'
    else:
        raise ValueError('Cannot expand the DataArray to x, y')
    n = len(np.asarray(coords[new_dim].values))
    data = da.data.unsqueeze(0).expand((n,) + da.shape)
    out = DataArray(data, dims=(new_dim,) + da.dims, name=da.name)
    out._coords = dict(da._coords)
    out._coords[new_dim] = Variable(
        (new_dim,), np.asarray(coords[new_dim].values), device=device)
    return out


def _collapse_coords(dims, vals):
    """Drop the dimensions along which a coordinate array (numpy) is
    constant; returns the remaining (dims, values)."""
    tol = 1e-8
    numeric = np.issubdtype(vals.dtype, np.number)
    for d in tuple(dims):
        axis = dims.index(d)
        v0 = np.take(vals, 0, axis=axis)
        v0e = np.expand_dims(v0, axis)
        if numeric:
            same = np.all(np.abs(np.where(np.isnan(v0e) & np.isnan(vals),
                                          0, v0e - vals)) < tol)
        else:
            same = np.all(v0e == vals)
        if same:
            dims = dims[:axis] + dims[axis + 1:]
            vals = v0
    return dims, vals


def calculate_default_transform(src_crs, dst_crs, width, height,
                                left, bottom, right, top,
                                resolution=None, dst_width=None,
                                dst_height=None):
    """Default output grid for a reprojection.

    Maps the densified source boundary into the target CRS, then picks a
    resolution that preserves the source pixel count per axis (unless an
    explicit resolution or output size is given), in place of
    rasterio.warp.calculate_default_transform.
    """
    dst_bounds = transform_bounds(src_crs, dst_crs, left, bottom, right,
                                  top)
    l, b, r, t = dst_bounds
    if resolution is not None:
        if np.isscalar(resolution):
            resolution = (resolution, resolution)
        resx, resy = resolution
        w = int(abs((r - l) / resx)) + 1
        h = int(abs((t - b) / resy)) + 1
    elif dst_width is not None and dst_height is not None:
        w, h = int(dst_width), int(dst_height)
        resx = (r - l) / (w - 1)
        resy = (t - b) / (h - 1)
    else:
        w, h = int(width), int(height)
        resx = (r - l) / (w - 1)
        resy = (t - b) / (h - 1)
    transform = Affine(abs(resx), 0, l, 0, -abs(resy), t)
    return transform, w, h


# ------------------------------------------
# The reprojection engine and its plan caches
# ------------------------------------------
#
# Every cache is keyed by the full warp geometry (destination transform
# and shape, source transform, both CRS as proj strings); the ones that
# hold tensors also by the device, so that a CPU call never receives a
# CUDA tensor, or the reverse.

@functools.lru_cache(maxsize=8)
def _cached_host_grid(dst_transform6, dst_shape, src_transform6,
                      src_proj4, dst_proj4):
    """Host float64 source-pixel coordinate grid for the warp geometry,
    shared by the gather grid and the separable plans so that the CRS
    transform runs once."""
    return grid_from_transforms(
        Affine(*dst_transform6), dst_shape, Affine(*src_transform6),
        src_crs=CRS.from_proj4(src_proj4),
        dst_crs=CRS.from_proj4(dst_proj4))


@functools.lru_cache(maxsize=8)
def _cached_grid(dst_transform6, dst_shape, src_transform6, src_proj4,
                 dst_proj4, dtype_str, device):
    """The gather's (rows, cols) grid on ``device``, cast to the values'
    coordinate dtype on the host before the upload."""
    rows, cols = _cached_host_grid(dst_transform6, dst_shape,
                                   src_transform6, src_proj4, dst_proj4)
    dtype = np.dtype(dtype_str)
    return (torch.from_numpy(np.asarray(rows, dtype)).to(device),
            torch.from_numpy(np.asarray(cols, dtype)).to(device))


# weight matrices above this many entries would not pay for themselves
# (32 MB float32 each); the O(N) gather wins asymptotically anyway. The
# cap times the cache width also bounds the device memory the plan
# cache can pin (4 plans x 4 matrices x 32 MB = 512 MB worst case).
_MATMUL_PLAN_CAP = 1 << 23


@functools.lru_cache(maxsize=4)
def _cached_plan(dst_transform6, dst_shape, src_transform6, src_proj4,
                 dst_proj4, src_shape, method, coord_dtype_str, device):
    """Separable-resample plan (weight matrices on ``device``) or None.

    Axis-aligned affine warps and per-axis-factoring CRS pairs (e.g.
    geographic <-> Mercator) resolve to two 1-d interpolation operators,
    and sampling runs as dense matmuls (``ops.interp.matmul_resample``).
    """
    if method not in ('bilinear', 'nearest', 'cubic', 'cubic_spline',
                      'lanczos', 'average'):
        return None
    height, width = dst_shape
    H, W = src_shape
    # 'average' has no gather fallback (the footprint decomposition IS
    # the method), so it gets a larger cap
    cap = _MATMUL_PLAN_CAP * 8 if method == 'average' \
        else _MATMUL_PLAN_CAP
    if height * H > cap or width * W > cap:
        return None
    rows, cols = _cached_host_grid(dst_transform6, dst_shape,
                                   src_transform6, src_proj4, dst_proj4)
    rc = separable_coords(rows, cols)
    if rc is None:
        return None
    # round through the gather's coordinate precision so both routes
    # touch IDENTICAL source pixels (else NaN footprints and edge
    # validity can differ by one pixel where a coordinate lands exactly
    # on a pixel center)
    cdt = np.dtype(coord_dtype_str)
    r1 = rc[0].astype(cdt).astype(np.float64)
    c1 = rc[1].astype(cdt).astype(np.float64)
    wy, wym, vy = axis_weights(r1, H, method)
    wx, wxm, vx = axis_weights(c1, W, method)
    expected = {'bilinear': 4.0, 'cubic': 16.0, 'cubic_spline': 16.0,
                'lanczos': 36.0}.get(method, 1.0)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (wy, wym, wx, wxm, vy, vx)) \
        + (expected, method == 'average')


@functools.lru_cache(maxsize=4)
def _cached_footprint_plan(dst_transform6, dst_shape, src_transform6,
                           src_proj4, dst_proj4, src_shape, device):
    """Per-axis contributor plan for the footprint statistics
    (mode/min/max/med/q1/q3/sum/rms) on ``device``, or None for
    curvilinear warps."""
    rows, cols = _cached_host_grid(dst_transform6, dst_shape,
                                   src_transform6, src_proj4, dst_proj4)
    rc = separable_coords(rows, cols)
    if rc is None:
        return None
    # degenerate single-pixel axes fall back to the affine scale ratio
    # for the cell width
    fb_y = abs(dst_transform6[4] / src_transform6[4]) \
        if src_transform6[4] else 1.0
    fb_x = abs(dst_transform6[0] / src_transform6[0]) \
        if src_transform6[0] else 1.0
    idx_y, in_y, valid_y = footprint_axis(rc[0], src_shape[0], fb_y)
    idx_x, in_x, valid_x = footprint_axis(rc[1], src_shape[1], fb_x)
    span = idx_y.shape[1] * idx_x.shape[1]
    if span > FOOTPRINT_SPAN_CAP:
        raise NotImplementedError(
            'footprint resampling window of %dx%d contributors per '
            'destination pixel exceeds the span cap (%d); coarsen '
            'first for downsample factors this large'
            % (idx_y.shape[1], idx_x.shape[1], FOOTPRINT_SPAN_CAP))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (idx_y, in_y, valid_y, idx_x, in_x, valid_x))


def _is_integer(dtype):
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def _method_for_dtype(dtype, resampling):
    """Resampling method and nodata by dtype: nearest/0 for integers,
    bilinear/NaN for floats. An explicit ``resampling=`` takes
    nearest, bilinear, cubic (Catmull-Rom), cubic_spline (B-spline),
    lanczos (normalized Lanczos-3), average (NaN-skipping footprint
    mean) and the footprint statistics mode/min/max/med/q1/q3/sum/rms,
    which need a separable warp and are meant for downsampling."""
    if _is_integer(dtype):
        method, nodata = 'nearest', 0
    else:
        method, nodata = 'bilinear', np.nan
    if resampling is not None:
        choices = ('nearest', 'bilinear', 'cubic', 'cubic_spline',
                   'lanczos', 'average') + FOOTPRINT_STATS
        if resampling not in choices:
            raise ValueError(
                'unsupported resampling %r (choose one of %s)'
                % (resampling, ', '.join(choices)))
        method = resampling
    if method in FOOTPRINT_STATS:
        # the aggregates are computed in float (NaN = nodata) even for
        # integer rasters; ints restore exactly through rint
        nodata = np.nan
    return method, nodata


def _promote(values):
    """The sampling dtype: float16 to float32, integers to float64."""
    if values.dtype == torch.float16:
        return values.to(torch.float32)
    if _is_integer(values.dtype):
        return values.to(torch.float64)
    return values


def _restore_dtype(out, out_dtype):
    """Undo the sampling promotion: float16 back to float16, integers
    back to integers (0 is the integer nodata; NaN from an all-nodata
    footprint becomes 0 before the rint)."""
    if out_dtype == torch.float16:
        return out.to(torch.float16)
    if _is_integer(out_dtype):
        return torch.round(out.masked_fill(out.isnan(), 0)).to(out_dtype)
    return out


def _reproject(ds, src_crs=None, dst_crs=None, dst_transform=None,
               width=None, height=None, res=None, extent=None, **kwargs):
    """Reproject a Dataset or DataArray onto a new grid / CRS.

    Accepted parameterizations: (transform + width/height), (transform +
    extent), (extent + res), (extent + width/height), or nothing
    (default transform inferred). The resampling method is chosen by
    dtype: bilinear for floats, nearest for integers (0 nodata),
    overridable with ``resampling=``. The result lies on the input's
    device.
    """
    if src_crs is None:
        src_crs = get_crs(ds)
    if src_crs is None:
        raise CRSError('Could not infer projection from input data. '
                       'Please provide the parameter `src_crs`.')
    src_bounds = get_bounds(ds)
    if extent is not None:
        extent = BoundingBox(*extent)

    if dst_crs is None:
        dst_crs = src_crs
        if width is None and height is not None:
            width = int(ncols(ds) * height / nrows(ds))
        elif height is None and width is not None:
            height = int(nrows(ds) * width / ncols(ds))

    if dst_transform is not None:
        if width is not None and height is not None:
            pass
        elif extent is not None:
            width = int(abs(
                (extent.right - extent.left) / dst_transform.a)) + 1
            height = int(abs(
                (extent.top - extent.bottom) / dst_transform.e)) + 1
        else:
            raise ValueError('Not enough information provided.')
    elif extent is not None:
        if res is not None:
            if np.isscalar(res):
                res = (res, res)
            width = int(abs((extent.right - extent.left) / res[0])) + 1
            height = int(abs((extent.top - extent.bottom) / res[1])) + 1
        resx = (extent.right - extent.left) / (width - 1)
        resy = (extent.top - extent.bottom) / (height - 1)
        dst_transform = Affine(resx, 0, extent.left, 0, -resy,
                               extent.top)
    else:
        dst_transform, width, height = calculate_default_transform(
            src_crs, dst_crs, ncols(ds), nrows(ds), *src_bounds,
            resolution=res, dst_width=width, dst_height=height)

    src_transform = get_transform(ds)
    src_dims = get_dims(ds)
    dst_crs = _parse_crs(dst_crs)
    device = _device_of(ds)
    dkey = str(device)

    # destination coordinate arrays (corner-grid convention)
    dst_x, _ = dst_transform * (np.arange(width),
                                np.zeros(width, dtype=int))
    _, dst_y = dst_transform * (np.zeros(height, dtype=int),
                                np.arange(height))
    dst_coords = {'x': dst_x, 'y': dst_y}
    extra_dims = set(src_dims) - {'y', 'x'}
    for c in extra_dims:
        if c in ds.coords:
            dst_coords[c] = ds.coords[c]

    # The pixel-coordinate grid is computed once on the host in float64
    # and cast to the gather's coordinate precision: float32 fractional
    # pixel coordinates are exact to ~2^-10 px under 16k pixels a side.
    coord_dtype = np.float32 if max(height, width) < 16384 \
        and max(ds.sizes.get('y', 1), ds.sizes.get('x', 1)) < 16384 \
        else np.float64
    resampling = kwargs.get('resampling')

    grid_key = (tuple(dst_transform)[:6], (height, width),
                tuple(src_transform)[:6], src_crs.to_proj4(),
                dst_crs.to_proj4())

    def _sample(values, method, nodata):
        """Resample ``values`` (..., y, x): separable warps in float32
        (and 'average' in any float) run as matmuls with the gather's
        NaN and validity semantics; everything else — float64 paths,
        curvilinear warps, big rasters — gathers (the coordinate grid
        is built and uploaded only when this route fires)."""
        src_shape = tuple(values.shape[-2:])
        if method in FOOTPRINT_STATS:
            plan = _cached_footprint_plan(*grid_key, src_shape, dkey)
            if plan is None:
                raise NotImplementedError(
                    'footprint resampling (%r) requires a separable '
                    'warp (axis-aligned affine grids or '
                    'per-axis-factoring CRS pairs); use nearest or '
                    'bilinear for this geometry' % (method,))
            return footprint_resample(values, *plan, stat=method,
                                      cval=float(nodata))
        if values.dtype == torch.float32 or method == 'average':
            plan = _cached_plan(*grid_key, src_shape, method,
                                np.dtype(coord_dtype).str, dkey)
            if plan is not None:
                return matmul_resample(values, *plan[:6], float(nodata),
                                       expected=plan[6], skipna=plan[7])
        if method == 'average':
            # tell the two plan-refusal causes apart
            rows, cols = _cached_host_grid(*grid_key)
            if separable_coords(rows, cols) is not None:
                raise NotImplementedError(
                    "resampling='average' weight matrices for this "
                    'grid (%dx%d -> %dx%d) exceed the plan size cap; '
                    'resample in tiles, or coarsen after a bilinear '
                    'warp' % (values.shape[-2], values.shape[-1],
                              rows.shape[0], cols.shape[1]))
            raise NotImplementedError(
                "resampling='average' requires a separable warp "
                '(axis-aligned affine grids or per-axis-factoring '
                "CRS pairs); use 'bilinear' or 'cubic' for this "
                'geometry')
        rows, cols = _cached_grid(*grid_key, np.dtype(coord_dtype).str,
                                  dkey)
        return map_coordinates(values, rows, cols, method, nodata)

    def _reproject_da(da):
        coord_dims = tuple(c for c in ('y', 'x') if c in da.dims)
        ordered_extra = tuple(d for d in get_dims(da)
                              if d not in coord_dims)
        method, nodata = _method_for_dtype(da.dtype, resampling)
        values = da.transpose(*(ordered_extra + coord_dims)).data
        work = _promote(values)
        if work.is_complex():           # by parts, NaN nodata
            out = torch.complex(_sample(work.real, method, np.nan),
                                _sample(work.imag, method, np.nan))
        else:
            out = _sample(work, method, nodata)
        return _restore_dtype(out, values.dtype)

    if isinstance(ds, Dataset):
        result = Dataset(coords=dst_coords, device=device)

        for v in list(ds.coords):
            cvar = ds.coords[v]
            if dst_crs == src_crs and v not in ds.sizes:
                if len(cvar.dims) == 0:
                    result._coords[v] = Variable((), cvar.data)
                elif cvar.dims in (('x',), ('y',)):
                    expanded = _expand_var_to_xy(cvar, ds.coords, device)
                    dims, vals = _collapse_coords(
                        ('y', 'x'), to_numpy(_reproject_da(expanded)))
                    result._coords[v] = Variable(dims, vals, device=device)
            if not set(cvar.dims).issuperset({'x', 'y'}):
                continue
            result._coords[v] = Variable(('y', 'x'), _reproject_da(cvar))

        # Batch all data variables with identical layout/dtype/method
        # into ONE stacked sampling call: one gather or matmul pair per
        # group instead of one per variable.
        groups = {}          # key -> list of entries
        for v in ds.data_vars:
            da = ds[v]
            vdims = _get_projection_dim_order(da)
            common = set(vdims).intersection(da.dims)
            if set(da.dims) == set(vdims) or set(da.dims) == {'y', 'x'}:
                coord_dims = tuple(c for c in ('y', 'x') if c in da.dims)
                orig_order = get_dims(da)
                ordered_extra = tuple(d for d in orig_order
                                      if d not in coord_dims)
                dim_order = ordered_extra + coord_dims
                method, nodata = _method_for_dtype(da.dtype, resampling)
                values = da.transpose(*dim_order).data
                out_dtype = values.dtype
                values = _promote(values)
                proj_dims = tuple(d for d in vdims if d in da.dims)
                if values.is_complex():
                    key = (dim_order, values.real.dtype, method, 'nan',
                           tuple(values.shape))
                    parts = (values.real, values.imag)
                else:
                    key = (dim_order, values.dtype, method, repr(nodata),
                           tuple(values.shape))
                    parts = (values,)
                groups.setdefault(key, []).append(
                    (v, parts, proj_dims, orig_order, out_dtype))
            elif common == {'x'} or common == {'y'}:
                result[v] = (vdims, _reproject_da(
                    _expand_var_to_xy(da, ds.coords, device)))
            else:
                result[v] = (da.dims, da.data)

        for key, entries in groups.items():
            method = key[2]
            nodata = np.nan if key[3] in ('nan', repr(np.nan)) else 0
            stacked = torch.stack([p for e in entries for p in e[1]])
            sampled = _sample(stacked, method, nodata)
            i = 0
            for (v, parts, proj_dims, orig_order, out_dtype) in entries:
                if len(parts) == 2:
                    out = torch.complex(sampled[i], sampled[i + 1])
                else:
                    out = sampled[i]
                i += len(parts)
                result[v] = (proj_dims, _restore_dtype(out, out_dtype))
                result._variables[v] = \
                    result._variables[v].transpose(*orig_order)
    else:
        dst_dims = _get_projection_dim_order(ds)
        proj_dims = tuple(d for d in dst_dims if d in ds.dims or
                          d in ('y', 'x'))
        result = DataArray(_reproject_da(ds), dims=proj_dims,
                           coords=dst_coords, name=ds.name, device=device)
        result = result.transpose(*get_dims(ds))

    result.attrs.update(ds.attrs)
    result.attrs['transform'] = tuple(dst_transform)[:6]
    result.attrs['crs'] = dst_crs.to_proj4()
    result.attrs['coordinate_system_string'] = dst_crs.wkt
    result.attrs['lines'] = nrows(result)
    result.attrs['samples'] = ncols(result)
    result.attrs['res'] = (abs(dst_transform.a), abs(dst_transform.e))
    result.attrs['bounds'] = tuple(get_bounds(result))

    _add_latlon(result, device)
    return result


# ------------------------------------------
# Algorithms
# ------------------------------------------

class Reprojection(Algorithm):
    """Reprojection of a dataset to the given CRS and extent.

    Parameters
    ----------
    target : Dataset or DataArray, optional
        A reference dataset to whose grid the input will be aligned.
    src_crs : CRS-like, optional
        CRS of the input data (default: infer).
    dst_crs : CRS-like, optional
        The output CRS (``crs`` is an accepted alias).
    crs : CRS-like, optional
        Alias for dst_crs.
    extent : tuple, optional
        Output extent (left, bottom, right, top).
    res : tuple, optional
        Output resolution.
    width, height : int, optional
        Output raster size.
    transform : Affine, optional
        Output transform (requires width and height or extent).
    **kwargs : dict, optional
        Extra arguments (e.g. ``resampling='nearest'``).
    """

    def __init__(self, target=None, src_crs=None, dst_crs=None, crs=None,
                 extent=None, res=None, width=None, height=None,
                 transform=None, **kwargs):
        if target is not None:
            for param, value in [('dst_crs', dst_crs),
                                 ('transform', transform),
                                 ('width', width), ('height', height),
                                 ('extent', extent), ('res', res)]:
                if value is not None:
                    warnings.warn('`{}` is ignored if `target` is '
                                  'specified.'.format(param))
            dst_crs = get_crs(target)
            transform = get_transform(target)
            width = ncols(target)
            height = nrows(target)
            res = extent = None
        elif transform is not None and (width is None or height is None):
            raise ValueError('If `transform` is given, you must also '
                             'specify the `width` and `height` '
                             'arguments.')
        elif extent is not None and res is None and \
                (width is None or height is None):
            raise ValueError('Need to provide either `width` and '
                             '`height` or resolution when specifying '
                             'the extent.')

        self.src_crs = None if src_crs is None else _parse_crs(src_crs)
        if crs is not None and dst_crs is not None:
            warnings.warn('`crs` is ignored if `dst_crs` is specified.')
        self.dst_crs = _parse_crs(dst_crs if dst_crs is not None else crs)
        self.extent = extent
        self.res = res
        self.width = width
        self.height = height
        if transform is not None and not isinstance(transform, Affine):
            transform = Affine(*tuple(transform)[:6])
        self.transform = transform
        self.kwargs = kwargs

    def _parallel_dimension(self, ds):
        return 'time'

    @parallelize
    def apply(self, ds):
        """Warp ``ds`` onto the configured output grid.

        Parameters
        ----------
        ds : Dataset
            Datacube to reproject.

        Returns
        -------
        Dataset
            Same variables on the target CRS/transform/shape.
        """
        return _reproject(ds, src_crs=self.src_crs, dst_crs=self.dst_crs,
                          dst_transform=self.transform, width=self.width,
                          height=self.height, res=self.res,
                          extent=self.extent, **self.kwargs)


reproject = wrap_algorithm(Reprojection, 'reproject')


class Resample(Algorithm):
    """Resample a dataset to the given resolution or size.

    Parameters
    ----------
    res : float or tuple, optional
        The desired resolution in dataset coordinates.
    width : int, optional
        Output width (ignored if res given; height inferred if absent).
    height : int, optional
        Output height (ignored if res given; width inferred if absent).
    **kwargs : dict, optional
        Extra arguments (e.g. ``resampling=``).
    """

    def __init__(self, res=None, width=None, height=None, **kwargs):
        self.res = res
        self.width = width
        self.height = height
        self.kwargs = kwargs

    @parallelize
    def apply(self, ds):
        """Run the resampling.

        Parameters
        ----------
        ds : Dataset or DataArray
            Datacube to regrid.

        Returns
        -------
        Dataset or DataArray
            Copy of ``ds`` on the requested grid (same CRS).
        """
        return _reproject(ds, width=self.width, height=self.height,
                          res=self.res, **self.kwargs)


resample = wrap_algorithm(Resample, 'resample')


class Alignment(Algorithm):
    """Align a list of datasets onto one common coordinate grid.

    Parameters
    ----------
    target : Dataset, optional
        Align with respect to this dataset's grid.
    crs : CRS-like, optional
        Output CRS (default: CRS of the first dataset).
    extent : tuple, optional
        Output bounds (default: the common bounds of all datasets).
    device : torch.device or str, optional
        Where products given as files are opened (default ``cuda``);
        products given as datasets stay on their device.
    """

    def __init__(self, target=None, crs=None, extent=None, device=None):
        self.target = target
        self.crs = crs
        self.extent = extent
        self.device = device

    def _sources(self, datasets):
        """Normalize the input into (name, loader) pairs. The loader
        re-opens file-backed products on demand, so the write loop
        keeps at most one full dataset alive at a time."""
        if isinstance(datasets, str):
            datasets = glob.glob(datasets)
        if not datasets:
            raise ValueError(
                'Alignment: nothing to align (empty list or glob '
                'with no matches)')
        pairs = []
        for i, item in enumerate(datasets):
            if isinstance(item, str):
                stem = os.path.basename(item)
                dot = stem.rfind('.')
                name = stem[:dot] if dot > 0 else stem
                pairs.append((name, functools.partial(
                    open_dataset, item, as_complex=False,
                    device=self.device)))
            else:
                pairs.append(('data%d' % i, (lambda d=item: d)))
        return pairs

    def apply(self, datasets, path):
        """Reproject every product onto one shared grid and write each
        to ``<path>/<name>_aligned.nc``.

        Parameters
        ----------
        datasets : str, list of str, or list of Dataset
            A glob expression, file list, or opened datasets.
        path : str
            Output directory.
        """
        pairs = self._sources(datasets)

        # the shared grid needs every product's metadata up front
        opened = [load() for _, load in pairs]
        grid = {
            'extent': (get_common_bounds(opened)
                       if self.extent is None else self.extent),
            'res': get_common_resolution(opened),
            'dst_crs': (get_crs(opened[0])
                        if self.crs is None else self.crs),
        }
        del opened
        proj = Reprojection(**grid)

        os.makedirs(path, exist_ok=True)
        for name, load in pairs:
            to_netcdf(proj.apply(load()),
                      os.path.join(path, name + '_aligned.nc'))


align = wrap_algorithm(Alignment, 'align')


# --------------
# COREGISTRATION
# --------------

class Coregistration(Algorithm):
    """Coregister a time series of images to a master image.

    Translation-only registration: per time step, the shift against the
    reference slice is estimated by FFT phase correlation and corrected
    by Catmull-Rom resampling, on the data's device.

    Parameters
    ----------
    reference : int, optional
        Time index of the master image (default: 0).
    upsampling : int, optional
        Subpixel upsampling factor for shift estimation (default: 10).
    """

    def __init__(self, reference=0, upsampling=10):
        self.reference = reference
        self.upsampling = upsampling

    def apply(self, ds):
        """Estimate and undo per-time-step shifts.

        Parameters
        ----------
        ds : Dataset
            Time series to register.

        Returns
        -------
        Dataset
            Series with every slice translated onto the master image.
        """
        return _coregister(ds, reference=self.reference,
                           upsampling=self.upsampling)


def _coregister(ds, reference, upsampling):
    """Batched translation-only coregistration: one phase correlation
    over the ``C11`` series (all k time steps), then one
    ``translate_batch`` over every variable's stacked (V*k, y, x) cube,
    with no copy to the host. Integer variables are resampled in
    float32 and cast back (truncating)."""
    ds_new = disassemble_complex(ds)
    datavars = get_vars_for_dims(ds_new, ['time', 'x', 'y'])
    k = ds_new.sizes['time']

    # (k, y, x) master series -> (k, 2) row/col shifts in one pass
    master = ds_new['C11'].transpose('time', 'y', 'x').data
    shifts = phase_cross_correlation_batch(
        master, master[reference], upsample_factor=upsampling)
    shifts[reference] = 0.0              # exact identity at the master

    arrs = [ds_new[v].transpose('time', 'y', 'x').data for v in datavars]
    dtypes = [a.dtype for a in arrs]
    arrs = [a if a.is_floating_point() else a.to(torch.float32)
            for a in arrs]
    work = functools.reduce(torch.promote_types, [a.dtype for a in arrs])
    stack = torch.stack([a.to(work) for a in arrs])          # (V, k, y, x)
    nv, _, ny, nx = stack.shape
    translations = shifts.flip(1).repeat(nv, 1)              # (V*k, [dx, dy])
    shifted = translate_batch(stack.reshape(nv * k, ny, nx),
                              translations).reshape(nv, k, ny, nx)

    for i, v in enumerate(datavars):
        dims = ds_new[v].dims
        out = shifted[i]
        if out.dtype != dtypes[i]:
            out = out.to(dtypes[i])   # truncating for integer variables
        ds_new._variables[v] = Variable(
            ('time', 'y', 'x'), out).transpose(*dims)
    return ds_new


coregister = wrap_algorithm(Coregistration, 'coregister')
