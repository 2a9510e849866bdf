"""Continental equal-area mosaic: reproject heterogeneous scenes onto
one production grid (ETRS89-LAEA Europe, EPSG:3035) and mosaic them.

The port of ``examples/continental_mosaic.py`` to ``nd_tpu_torch``: the
same steps, names and printed lines, with the scenes' data on
``device`` (``cuda`` by default, ``'cpu'`` on a machine without a card).
Scenes arrive in different CRS (a UTM zone, geographic, Web Mercator),
are reprojected on the device onto the common Lambert-azimuthal-equal-
area grid — the standard European reporting grid — and merged. Equal-
area grids make pixel counts area-proportional, which is what
continental statistics (deforestation, burnt area, crop extent) need.

Run: python examples_torch/continental_mosaic.py
"""

import os
import sys

import numpy as np

if __name__ == '__main__':     # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import nd_tpu_torch  # noqa: F401
from nd_tpu_torch.crs import CRS, transform_coords
from nd_tpu_torch.testing import generate_test_dataset
from nd_tpu_torch.warp import Reprojection, get_crs


def make_scenes(ny=60, nx=80, k=2, device=None):
    """Three overlapping scenes over central Europe, each in its own
    CRS (as downloaded products would be)."""
    dims = {'y': int(ny), 'x': int(nx), 'time': int(k)}
    scenes = []
    # geographic scene (as Sentinel-3 style products ship)
    scenes.append(generate_test_dataset(
        dims=dims, extent=(6.0, 46.0, 14.0, 52.0), device=device))
    # the same region's neighbours, reprojected into UTM 32N and
    # Web Mercator to emulate multi-source inputs
    utm = generate_test_dataset(dims=dims, extent=(10.0, 46.0, 18.0, 52.0),
                                device=device)
    scenes.append(Reprojection(crs='epsg:32632').apply(utm))
    web = generate_test_dataset(dims=dims, extent=(2.0, 44.0, 10.0, 50.0),
                                device=device)
    scenes.append(Reprojection(crs='epsg:3857').apply(web))
    return scenes


def mosaic(scenes, res=20000.0):
    """Reproject every scene onto EPSG:3035 at ``res`` metres and
    average the overlaps."""
    # one common grid covering every scene
    corners = []
    for s in scenes:
        src = get_crs(s)
        xs = np.asarray(s.coords['x'].values)
        ys = np.asarray(s.coords['y'].values)
        bx = np.array([xs.min(), xs.max(), xs.min(), xs.max()])
        by = np.array([ys.min(), ys.min(), ys.max(), ys.max()])
        ex, ey = transform_coords(src, 'epsg:3035', bx, by)
        corners.append((np.min(ex), np.min(ey), np.max(ex),
                        np.max(ey)))
    left = min(c[0] for c in corners)
    bottom = min(c[1] for c in corners)
    right = max(c[2] for c in corners)
    top = max(c[3] for c in corners)

    proj = Reprojection(crs='epsg:3035',
                        extent=(left, bottom, right, top), res=res)
    acc = None
    cnt = None
    for s in scenes:
        warped = proj.apply(s)
        vals = np.asarray(warped['C11'].transpose(
            'y', 'x', 'time').values, np.float64)
        good = np.isfinite(vals)
        if acc is None:
            acc = np.where(good, vals, 0.0)
            cnt = good.astype(np.int32)
        else:
            acc += np.where(good, vals, 0.0)
            cnt += good
        out_grid = warped
    with np.errstate(invalid='ignore'):
        mean = np.where(cnt > 0, acc / np.maximum(cnt, 1), np.nan)
    out = out_grid.copy()
    out['C11'] = (('y', 'x', 'time'), mean)      # onto the grid's device
    return out, cnt


def main(device=None, ny=60, nx=80, k=2, res=20000.0):
    scenes = make_scenes(ny, nx, k, device=device)
    out, cnt = mosaic(scenes, res=res)
    assert get_crs(out) == CRS.from_epsg(3035)
    covered = float((cnt.max(axis=-1) if cnt.ndim == 3
                     else cnt).astype(bool).mean())
    print('mosaic grid: %s px on EPSG:3035, %.0f%% covered, '
          'overlap depth up to %d scenes'
          % (dict(out.sizes), covered * 100, int(cnt.max())))
    return out


if __name__ == '__main__':
    main()
