"""Cloud-gap filling and areal statistics on an optical time series.

The port of ``examples/timeseries_gapfill.py`` to ``nd_tpu_torch``: the
same steps, names and printed lines, with the cubes on ``device``
(``cuda`` by default, ``'cpu'`` on a machine without a card):

    two swaths with cloud-masked gaps
      -> combine_first        (union-grid mosaicking of the swaths)
      -> interpolate_na       (linear time interpolation per pixel)
      -> ffill/bfill          (edge gaps the interpolation leaves)
      -> coarsen              (block-average onto a reporting grid)
      -> weighted             (cos(latitude) area-true global mean)

Run: python examples_torch/timeseries_gapfill.py
"""

import os
import sys

import numpy as np

if __name__ == '__main__':     # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import nd_tpu_torch  # noqa: F401  (registers accessors)
from nd_tpu_torch.core import DataArray


def build_swath(x_start, seed, ny=48, nx=40, k=8, device=None):
    """A seasonal NDVI-like cube with random cloud gaps."""
    rng = np.random.RandomState(seed)
    t = np.arange(k, dtype=np.float64)
    season = 0.45 + 0.25 * np.sin(2 * np.pi * (t / k))
    lat = np.linspace(60.0, 40.0, ny)
    lon = x_start + np.arange(nx) * 0.5
    base = season[None, None, :] \
        + 0.1 * rng.rand(ny, nx, 1) \
        + 0.05 * np.cos(np.radians(lat))[:, None, None]
    clouds = rng.rand(ny, nx, k) < 0.3
    data = np.where(clouds, np.nan, base).astype(np.float32)
    return DataArray(
        data, dims=('y', 'x', 'time'),
        coords={'y': lat, 'x': lon,
                'time': np.datetime64('2024-01-01', 'ns')
                + (t * 10).astype('timedelta64[D]').astype(
                    'timedelta64[ns]')},
        name='ndvi', device=device)


def main(device=None, ny=48, nx=40, k=8):
    # two overlapping swaths: the east swath covers x >= 10
    west = build_swath(0.0, seed=1, ny=ny, nx=nx, k=k, device=device)
    east = build_swath(10.0, seed=2, ny=ny, nx=nx, k=k, device=device)

    # 1. union-grid mosaic: west wins where it has data, east fills
    mosaic = west.combine_first(east)
    assert mosaic.sizes['x'] > west.sizes['x']

    # 2. per-pixel gap filling along time (linear in the time
    #    coordinate), then edge fill for leading/trailing gaps
    filled = mosaic.interpolate_na(
        'time', max_gap=np.timedelta64(40, 'D'))
    filled = filled.ffill('time').bfill('time')

    # 3. reporting grid: 4x4 block means (NaN-aware)
    grid = filled.coarsen(y=4, x=4, boundary='trim').mean()

    # 4. area-true mean: weight by cos(latitude)
    w = DataArray(np.cos(np.radians(grid['y'].values)), dims=('y',),
                  device=device)
    series = grid.weighted(w).mean(('y', 'x'))

    gap_frac_before = float(np.isnan(mosaic.values).mean())
    gap_frac_after = float(np.isnan(filled.values).mean())
    print('gap fraction: %.2f -> %.3f' % (gap_frac_before,
                                          gap_frac_after))
    print('weighted NDVI series:',
          np.round(np.asarray(series.values), 3))
    return mosaic, filled, series


if __name__ == '__main__':
    main()
