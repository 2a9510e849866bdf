"""Out-of-core mosaic: tile -> per-tile processing -> auto-merge.

The port of ``examples/out_of_core_mosaic.py`` to ``nd_tpu_torch``:
the same steps, names and printed lines, with every tile's data on
``device`` (``cuda`` by default, ``'cpu'`` on a machine without a
card). A cube is processed in buffered tiles and reassembled exactly:

    synthesize a cube -> write overlapping NetCDF tiles ->
    map a speckle filter over the tiles (the boxcar is the sepconv
    kernel on the card; tiles are read ahead and written behind by a
    thread pool) -> auto_merge with de-buffering -> reproject the
    mosaic (separable warps run as two matmuls).

The merged result is bit-equal to filtering the whole cube at once —
the halo buffer carries exactly the filter's support.

Run: python examples_torch/out_of_core_mosaic.py [output_dir]
"""

import glob
import os
import sys
import tempfile

import numpy as np

if __name__ == '__main__':     # run as a script from a checkout
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import nd_tpu_torch  # noqa: F401  (registers accessors)
from nd_tpu_torch.filters import BoxcarFilter
from nd_tpu_torch.testing import generate_test_dataset
from nd_tpu_torch.tiling import map_over_tiles, tile
from nd_tpu_torch.warp import Reprojection


def main(outdir=None, ny=240, nx=300, k=4, device=None):
    outdir = outdir or tempfile.mkdtemp(prefix='nd_tpu_mosaic_')
    os.makedirs(outdir, exist_ok=True)
    tiledir = os.path.join(outdir, 'tiles')

    ds = generate_test_dataset(dims={'y': int(ny), 'x': int(nx),
                                     'time': int(k)}, device=device)
    for v in list(ds.data_vars):
        ds[v] = (ds[v].dims, ds[v].values.astype(np.float32))

    flt = BoxcarFilter(w=3)

    # 1. buffered tiles on disk (buffer = the filter's halo, so the
    #    merged result is identical to the unsplit run)
    tile(ds, tiledir, chunks={'y': int(ny) // 2, 'x': int(nx) // 2},
         buffer=flt._buffer('y'), complevel=1)
    n_tiles = len(glob.glob(os.path.join(tiledir, '*.nc')))
    print('wrote %d buffered tiles' % n_tiles)

    # 2. stream the filter over the tiles and merge
    merged = map_over_tiles(os.path.join(tiledir, '*.nc'), flt.apply,
                            merge=True, compute=True, complevel=1,
                            device=device)

    # 3. the mosaic equals the whole-image filter
    whole = flt.apply(ds)
    for v in ds.data_vars:
        np.testing.assert_allclose(np.asarray(merged[v].values),
                                   np.asarray(whole[v].values),
                                   rtol=0, atol=1e-6)
    print('mosaic == whole-image filter')

    # 4. reproject the mosaic (separable 4326 -> World Mercator:
    #    runs as two matmuls)
    warped = Reprojection(crs='epsg:3395').apply(merged)
    out_nc = os.path.join(outdir, 'mosaic_3395.nc')
    from nd_tpu_torch import to_netcdf
    to_netcdf(warped, out_nc)
    print('wrote', out_nc, 'shape',
          {d: warped.sizes[d] for d in warped.sizes})
    return outdir


if __name__ == '__main__':
    main(*(sys.argv[1:2] or [None]))
