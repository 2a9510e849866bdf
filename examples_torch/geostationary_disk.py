"""Geostationary full-disk ingestion: from a satellite's native
scanning-angle grid to a map projection and back.

The port of ``examples/geostationary_disk.py`` to ``nd_tpu_torch``: the
same steps, names and printed lines, with the scene on ``device``
(``cuda`` by default, ``'cpu'`` on a machine without a card).
Geostationary L1 products (GOES-R ABI, MSG SEVIRI, Himawari AHI) ship
on the `geos` projection — the imager's scanning angles scaled by the
satellite height — NOT on a lat/lon grid. This example builds a
synthetic SEVIRI-style full-disk scene on its native grid, extracts a
regional lat/lon cut-out, and pushes a European sector onto the
EPSG:3035 equal-area reporting grid, exercising the geostationary
forward/inverse math end to end (off-disk pixels stay NaN throughout).
The projection math runs on the host in float64 numpy; the resampling
on the device.

Run: python examples_torch/geostationary_disk.py
"""

import os
import sys

import numpy as np

if __name__ == '__main__':     # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import nd_tpu_torch  # noqa: F401
from nd_tpu_torch.core.dataarray import Dataset
from nd_tpu_torch.crs import CRS
from nd_tpu_torch.crs.proj import project_inverse
from nd_tpu_torch.warp import Reprojection

# MSG SEVIRI: sub-satellite 0 deg E, 35785831 m above the ellipsoid,
# sweep axis 'y' (GOES would use sweep='x')
SEVIRI = ('+proj=geos +h=35785831 +lon_0=0 +sweep=y +ellps=WGS84 '
          '+units=m +no_defs')
H = 35785831.0
# the full disk spans about +-8.8 deg of scan angle ~ +-5.5e6 m
HALF_EXTENT = 5.45e6


def make_full_disk(n=240, device=None):
    """A synthetic full-disk brightness-temperature field on the
    native geos grid: warm at the equator, cold poleward, NaN off the
    Earth's limb (exactly as decoded L1 rasters look)."""
    crs = CRS.from_string(SEVIRI)
    step = 2 * HALF_EXTENT / n
    x = -HALF_EXTENT + step * (np.arange(n) + 0.5)
    y = HALF_EXTENT - step * (np.arange(n) + 0.5)
    X, Y = np.meshgrid(x, y)
    lon, lat = project_inverse('geos', X, Y, crs.ellipsoid,
                               crs.params)
    # off-disk view angles have no Earth intersection -> NaN
    bt = 300.0 - 70.0 * np.sin(np.deg2rad(np.abs(lat))) ** 2 \
        - 5.0 * np.cos(np.deg2rad(lon) * 3)
    ds = Dataset(
        {'BT': (('y', 'x'), bt.astype(np.float32))},
        coords={'y': y, 'x': x},
        attrs={'crs': SEVIRI,
               'transform': (step, 0.0, -HALF_EXTENT,
                             0.0, -step, HALF_EXTENT)},
        device=device)
    return ds


def main(device=None, n=240):
    disk = make_full_disk(n, device=device)
    bt = np.asarray(disk['BT'].values)
    on_disk = np.isfinite(bt).mean()
    print('full disk: %dx%d, %.0f%% of pixels on the Earth disk'
          % (bt.shape[0], bt.shape[1], 100 * on_disk))

    # regional lat/lon cut-out (the classic "geo to latlon" step)
    europe = Reprojection(crs='epsg:4326',
                          extent=(-12.0, 35.0, 30.0, 62.0),
                          width=160, height=120).apply(disk)
    e = np.asarray(europe['BT'].values)
    print('Europe cut-out: %.0f%% finite, mean BT %.1f K'
          % (100 * np.isfinite(e).mean(), np.nanmean(e)))

    # and onto the equal-area reporting grid
    laea = Reprojection(crs='epsg:3035', res=40000.0).apply(europe)
    la = np.asarray(laea['BT'].values)
    print('EPSG:3035 grid: %s, %.0f%% finite'
          % (dict(laea.sizes), 100 * np.isfinite(la).mean()))
    return disk, europe, laea


if __name__ == '__main__':
    main()
