"""Lazy opens of nd_tpu_torch.io (``chunks=``) against nd_tpu's on the
same files, exactly: netCDF-4 through h5py in both packages, netCDF
classic through the port's own reader (a header parser and positional
reads, checked against scipy's on files scipy writes, records included)
against nd_tpu's eager classic read, and GeoTIFF windows.
A read counter shows that an open reads no data variable and that an
``isel`` reads only its slab. The out-of-core test streams a 768 MB
classic file through ``tile`` and ``map_over_tiles`` in a process with
h5py blocked and holds its peak RSS growth, sampled from outside, under
half of the file."""

import json
import os
import shutil
import sys
import textwrap

import h5py
import numpy as np
import pytest
import torch

from nd_tpu import io as jio
from nd_tpu.core import Dataset as JDataset
from nd_tpu.io import lazy as jlazy
from nd_tpu_torch import io as tio
from nd_tpu_torch.core import Dataset
from nd_tpu_torch.io import geotiff as tgt
from nd_tpu_torch.io import lazy as tlazy
from nd_tpu_torch.io import netcdf as tnc
from nd_tpu_torch.testing import run_sampling_rss
from torch_io_helpers import same_array, same_dataset

ROUTES = ['netcdf4', 'classic']


def _spec(with_strings):
    rng = np.random.RandomState(0)
    data_vars = {'a': (('y', 'x', 'time'),
                       rng.rand(40, 50, 6).astype(np.float32)),
                 'b': (('y', 'x'), (rng.rand(40, 50) * 100).astype(np.int32))}
    if with_strings:
        data_vars['label'] = (('y',), np.array(['r%d' % i for i in range(40)]))
    coords = {'y': np.arange(40.0), 'x': np.arange(50.0),
              'time': np.array(['2020-01-%02d' % (d + 1) for d in range(6)],
                               dtype='datetime64[ns]')}
    return data_vars, coords


@pytest.fixture(params=ROUTES)
def ncfile(request, tmp_path):
    """(route, path, port Dataset on the CPU) of one cube; netCDF-4 as
    nd_tpu writes it, classic as the port writes it without h5py."""
    classic = request.param == 'classic'
    data_vars, coords = _spec(with_strings=not classic)
    path = str(tmp_path / 'cube.nc')
    if classic:
        ds = Dataset(data_vars, coords=coords, device='cpu')
        tnc._write_netcdf_classic(ds, path)
    else:
        jio.to_netcdf(JDataset(data_vars, coords=coords), path)
        ds = Dataset(data_vars, coords=coords, device='cpu')
    return request.param, path, ds


@pytest.fixture
def reads(monkeypatch):
    """The bytes of every slab a lazy netCDF view reads."""
    seen = []
    orig = tlazy.LazyNetCDFArray._materialize

    def counting(self, key):
        out = orig(self, key)
        seen.append(np.asarray(out).nbytes)
        return out
    monkeypatch.setattr(tlazy.LazyNetCDFArray, '_materialize', counting)
    return seen


def test_lazy_open_reads_nothing_until_used(ncfile, reads):
    route, path, ds = ncfile
    lazy = tio.open_netcdf(path, chunks={}, device='cpu')
    for v in ('a', 'b'):
        assert lazy._variables[v].is_lazy
        assert isinstance(lazy._variables[v]._data, tlazy.LazyNetCDFArray)
    if route == 'netcdf4':
        # strings and coordinates stay eager
        assert isinstance(lazy._variables['label'].data, np.ndarray)
    assert not any(c.is_lazy for c in lazy._coords.values())
    assert lazy['a'].dtype == torch.float32
    assert lazy['b'].dtype == torch.int32
    assert lazy['a'].shape == (40, 50, 6)
    assert lazy.nbytes == ds.nbytes
    assert lazy.sizes == ds.sizes and lazy.chunks == {}
    assert lazy['a'].variable.device == torch.device('cpu')
    assert reads == []

    sub = lazy.isel(y=slice(10, 20), x=slice(0, 25))
    assert reads == [] and sub._variables['a'].is_lazy
    same_array(sub['a'].values, ds['a'].values[10:20, :25])
    assert reads == [10 * 25 * 6 * 4]
    got = sub['a'].data                  # a computation reads it again
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    assert reads == [10 * 25 * 6 * 4] * 2
    assert not sub._variables['a'].is_lazy
    sub['a'].data
    assert len(reads) == 2               # read once, then kept


@pytest.mark.parametrize('route', ROUTES)
def test_lazy_equals_eager_and_nd_tpu(tmp_path, route):
    data_vars, coords = _spec(with_strings=route == 'netcdf4')
    path = str(tmp_path / 'cube.nc')
    j = JDataset(data_vars, coords=coords)
    if route == 'classic':
        tnc._write_netcdf_classic(Dataset(data_vars, coords=coords,
                                          device='cpu'), path)
        # nd_tpu reads classic files eagerly (chunks= is ignored there)
        want = jio.open_netcdf(path)
    else:
        jio.to_netcdf(j, path)
        want = jio.open_netcdf(path, chunks={})
        assert isinstance(want['a'].variable.data, jlazy.LazyNetCDFArray)
    lazy = tio.open_netcdf(path, chunks={}, device='cpu')
    for v in ('a', 'b'):
        assert np.dtype(str(lazy[v].dtype).split('.')[-1]) == \
            np.asarray(want[v].values).dtype.newbyteorder('=')
    same_dataset(lazy, want)
    same_dataset(tio.open_netcdf(path, chunks={}, device='cpu'),
                 tio.open_netcdf(path, device='cpu'))


def test_isel_views_compose(ncfile, reads):
    route, path, ds = ncfile
    lazy = tio.open_netcdf(path, chunks={}, device='cpu')
    ref = ds['a'].values
    view = lazy.isel(y=slice(5, 30)).isel(y=slice(2, 10, 2), x=3) \
        .isel(time=slice(1, None, 2))
    assert view._variables['a'].is_lazy and reads == []
    assert view['a'].dims == ('y', 'time')
    same_array(view['a'].data, ref[5:30][2:10:2, 3][:, 1::2])
    assert reads == [4 * 3 * 4]
    # a reversed slice and an array indexer read, then gather
    same_array(lazy.isel(x=slice(None, None, -3))['a'].data,
               ref[:, ::-3])
    same_array(lazy.isel(time=[4, 0, 2])['a'].data, ref[:, :, [4, 0, 2]])
    same_array(lazy.isel(y=-1, x=-2)['a'].data, ref[-1, -2])


@pytest.mark.parametrize('route', ROUTES)
def test_lazy_array_indexing_equals_nd_tpu(tmp_path, route):
    data_vars, coords = _spec(with_strings=False)
    path = str(tmp_path / 'cube.nc')
    if route == 'classic':
        tnc._write_netcdf_classic(Dataset(data_vars, coords=coords,
                                          device='cpu'), path)
        jarr = jlazy.LazyNetCDFArray  # nd_tpu has no classic lazy route
        arr = tio.open_netcdf(path, chunks={}, device='cpu')._variables['a']._data
    else:
        jio.to_netcdf(JDataset(data_vars, coords=coords), path)
        jarr = jio.open_netcdf(path, chunks={})['a'].variable.data
        arr = tio.open_netcdf(path, chunks={}, device='cpu')._variables['a']._data
    ref = data_vars['a'][1]
    for key in [(slice(5, 30),), (7,), (slice(2, 10, 2), 3), (-1, -2, -3),
                (slice(None), slice(None, None, 7), 1), ([1, 3],),
                (slice(None), slice(None, None, -1)), (None, 3), (Ellipsis, 2),
                (np.int64(4), np.int32(1))]:
        got = arr[key]
        want = ref[key]
        if isinstance(got, tlazy.LazyArray):
            assert got.shape == want.shape and got.dtype == want.dtype
            got = np.asarray(got)
        same_array(got, want, key)
        if route == 'netcdf4':
            same_array(got, np.asarray(jarr[key]), key)
    same_array(np.asarray(arr[5:30][2:10:2, 3]), ref[5:30][2:10:2, 3])
    same_array(np.asarray(arr[7][::-2]), ref[7][::-2])


@pytest.mark.parametrize('route', ROUTES)
def test_lazy_indexing_numpy_errors_equal_nd_tpu(tmp_path, route):
    a = np.arange(12.0).reshape(3, 4)
    p = str(tmp_path / 'l.nc')
    coords = {'y': np.arange(3.0), 'x': np.arange(4.0)}
    if route == 'classic':
        tnc._write_netcdf_classic(Dataset({'a': (('y', 'x'), a)},
                                          coords=coords, device='cpu'), p)
    else:
        jio.to_netcdf(JDataset({'a': (('y', 'x'), a)}, coords=coords), p)
    lazy = tio.open_netcdf(p, chunks={}, device='cpu')._variables['a']._data
    twin = jlazy.LazyNetCDFArray(p, 'a', (3, 4), np.float64) \
        if route == 'netcdf4' else a
    for key in [(0, 0, 0), 1.5, np.float32(2.0), (5,), (0, -5)]:
        with pytest.raises(IndexError) as got:
            lazy[key]
        with pytest.raises(IndexError) as want:
            twin[key]
        if route == 'netcdf4':
            assert str(got.value) == str(want.value), key
    # a bool scalar is numpy's mask, adding an axis
    same_array(np.asarray(lazy[True]), a[True])
    same_array(np.asarray(lazy[False]), a[False])
    with pytest.raises(TypeError):
        len(lazy[0, 0])


def _packed_h5(path, raw, **attrs):
    with h5py.File(path, 'w') as f:
        d = f.create_dataset('v', data=raw)
        for k, v in attrs.items():
            d.attrs[k] = v


def _packed_classic(path, raw, **attrs):
    from scipy.io import netcdf_file
    f = netcdf_file(path, 'w', version=2)
    for i, n in enumerate(raw.shape):
        f.createDimension('d%d' % i, n)
    v = f.createVariable('v', raw.dtype, tuple('d%d' % i
                                               for i in range(raw.ndim)))
    v[...] = raw
    for k, val in attrs.items():
        setattr(v, k, val)
    f.close()


@pytest.mark.parametrize('route', ROUTES)
def test_cf_decode_per_slab(tmp_path, route):
    path = str(tmp_path / 'packed.nc')
    raw = np.arange(24, dtype=np.int16).reshape(4, 6)
    raw[1, 2] = -99
    write = _packed_h5 if route == 'netcdf4' else _packed_classic
    write(path, raw, _FillValue=np.int16(-99), scale_factor=0.5,
          add_offset=10.0)
    lazy = tio.open_netcdf(path, rename_latlon=False, chunks={},
                           device='cpu')
    assert lazy._variables['v'].is_lazy
    assert lazy['v'].dtype == torch.float64       # decoded dtype, no read
    eager = jio.open_netcdf(path, rename_latlon=False)
    same_dataset(lazy, eager)
    lazy = tio.open_netcdf(path, rename_latlon=False, chunks={},
                           device='cpu')
    slab = lazy['v'].isel({lazy['v'].dims[0]: slice(1, 2)}).values
    expect = raw[1].astype(np.float64) * 0.5 + 10.0
    expect[2] = np.nan
    same_array(slab[0], expect)
    if route == 'netcdf4':
        same_dataset(tio.open_netcdf(path, rename_latlon=False, chunks={},
                                     device='cpu'),
                     jio.open_netcdf(path, rename_latlon=False, chunks={}))


@pytest.mark.parametrize('route', ROUTES)
def test_lazy_datetime_decode(tmp_path, route):
    path = str(tmp_path / 'times.nc')
    days = np.arange(10, dtype=np.int32).reshape(2, 5)
    write = _packed_h5 if route == 'netcdf4' else _packed_classic
    write(path, days, units=b'days since 2021-06-01')
    lazy = tio.open_netcdf(path, rename_latlon=False, chunks={},
                           device='cpu')
    assert lazy._variables['v'].is_lazy
    assert lazy['v'].dtype == np.dtype('datetime64[ns]')
    assert lazy['v'].variable.device is None      # stays on the host
    vals = lazy['v'].values
    assert vals[0, 0] == np.datetime64('2021-06-01')
    assert vals[1, 4] == np.datetime64('2021-06-10')
    same_dataset(lazy, jio.open_netcdf(path, rename_latlon=False))
    lazy = tio.open_netcdf(path, rename_latlon=False, chunks={},
                           device='cpu')
    assert isinstance(lazy['v'].data, np.ndarray)


@pytest.mark.parametrize('route', ROUTES)
@pytest.mark.parametrize('fill_row', [3, None])
def test_declared_fill_fixes_the_dtype_lazy_and_eager(tmp_path, route,
                                                      fill_row):
    """A declared fill makes every slab float64, whether or not it holds
    a fill, as nd_tpu's lazy and eager reads do."""
    path = str(tmp_path / 'f.nc')
    raw = np.arange(24, dtype=np.int16).reshape(4, 6)
    if fill_row is not None:
        raw[fill_row, 2] = -99
    write = _packed_h5 if route == 'netcdf4' else _packed_classic
    write(path, raw, _FillValue=np.int16(-99))
    lazy = tio.open_netcdf(path, rename_latlon=False, chunks={},
                           device='cpu')
    eager = tio.open_netcdf(path, rename_latlon=False, device='cpu')
    arr = lazy._variables['v']._data
    assert arr.dtype == np.float64 and eager['v'].dtype == torch.float64
    head = np.asarray(arr[0:2])
    assert head.dtype == np.float64
    same_array(head, raw[0:2].astype(np.float64))
    tail = np.asarray(arr[3:4])
    assert tail.dtype == np.float64
    assert np.isnan(tail[0, 2]) == (fill_row == 3)
    same_dataset(lazy, jio.open_netcdf(path, rename_latlon=False))
    if route == 'netcdf4':
        jarr = jio.open_netcdf(path, rename_latlon=False,
                               chunks={})['v'].variable.data
        assert jarr.dtype == arr.dtype
        same_array(np.asarray(arr[3:4]), np.asarray(jarr[3:4]))


@pytest.mark.parametrize('route', ROUTES)
def test_aux_coords_stay_eager_under_chunks(tmp_path, route):
    lat = np.linspace(40, 41, 12).reshape(3, 4)
    lon = np.linspace(5, 6, 12).reshape(3, 4)
    spec = dict(data_vars={'v': (('y', 'x'), np.ones((3, 4), np.float32))},
                coords={'y': np.arange(3.0), 'x': np.arange(4.0),
                        'lat': (('y', 'x'), lat), 'lon': (('y', 'x'), lon)})
    p = str(tmp_path / 'aux.nc')
    if route == 'classic':
        tnc._write_netcdf_classic(Dataset(device='cpu', **spec), p)
    else:
        jio.to_netcdf(JDataset(**spec), p)
    lazy = tio.open_netcdf(p, chunks={}, device='cpu')
    assert lazy._variables['v'].is_lazy
    assert not lazy._coords['lat'].is_lazy
    assert not lazy._coords['lon'].is_lazy
    same_dataset(lazy, jio.open_netcdf(p))


def test_chunks_is_accepted_by_every_opener(tmp_path):
    data_vars, coords = _spec(with_strings=False)
    p = str(tmp_path / 'n.nc')
    jio.to_netcdf(JDataset(data_vars, coords=coords), p)
    for ds in (tio.open_netcdf(p, chunks={}, device='cpu'),
               tio.open_dataset(p, chunks={}, device='cpu')):
        assert ds._variables['a'].is_lazy
    tif = str(tmp_path / 'r.tif')
    tgt.write_geotiff(tif, data_vars['a'][1][..., 0][None])
    for da in (tio.open_rasterio(tif, chunks={}, device='cpu'),
               tio.open_dataset(tif, chunks={}, device='cpu')):
        assert da.variable.is_lazy
        same_array(da.data, data_vars['a'][1][..., 0][None])


def test_chunks_with_overview_level_raises(tmp_path):
    path = str(tmp_path / 'r.tif')
    tgt.write_geotiff(path, np.zeros((1, 32, 32), np.float32),
                      overviews=[2])
    with pytest.raises(ValueError, match='not both'):
        tio.open_rasterio(path, chunks={}, overview_level=0)
    with pytest.raises(ValueError):
        jio.open_rasterio(path, chunks={}, overview_level=0)


# ---------------------------------------------------------------------------
# lazy GeoTIFF (windowed strip/tile decode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('tiled', [False, True])
@pytest.mark.parametrize('compress', [False, True])
def test_lazy_rasterio_equals_eager_and_nd_tpu(tmp_path, tiled, compress):
    rng = np.random.RandomState(0)
    data = (rng.rand(3, 70, 53) * 100).astype(np.float32)
    p = str(tmp_path / 'r.tif')
    tgt.write_geotiff(p, data, tiled=tiled, tile_size=32, compress=compress)
    lazy = tio.open_rasterio(p, chunks={}, device='cpu')
    assert isinstance(lazy.variable._data, tlazy.LazyGeoTIFFArray)
    same_dataset(lazy, jio.open_rasterio(p, chunks={}))
    lazy = tio.open_rasterio(p, chunks={}, device='cpu')
    win = lazy.isel(y=slice(5, 41), x=slice(17, 50), band=slice(1, 3))
    assert win.variable.is_lazy
    same_array(win.values, data[1:3, 5:41, 17:50])
    same_dataset(win, jio.open_rasterio(p, chunks={}).isel(
        y=slice(5, 41), x=slice(17, 50), band=slice(1, 3)))


def test_lazy_rasterio_decodes_only_the_blocks_it_needs(tmp_path,
                                                        monkeypatch):
    rng = np.random.RandomState(1)
    data = (rng.rand(1, 128, 128) * 100).astype(np.float32)
    p = str(tmp_path / 'r.tif')
    tgt.write_geotiff(p, data, tiled=True, tile_size=32)
    calls = []
    orig = tgt._decompress

    def counting(b, c):
        calls.append(len(b))
        return orig(b, c)
    monkeypatch.setattr(tgt, '_decompress', counting)
    lazy = tio.open_rasterio(p, chunks={}, device='cpu')
    assert calls == []
    sub = lazy.isel(y=slice(0, 32), x=slice(0, 32)).values
    same_array(sub[0], data[0, :32, :32])
    assert len(calls) == 1          # 1 of 16 tiles decoded


def test_lazy_rasterio_steps_and_int_axes(tmp_path):
    rng = np.random.RandomState(2)
    data = (rng.rand(2, 40, 40) * 10).astype(np.float32)
    p = str(tmp_path / 's.tif')
    tgt.write_geotiff(p, data, tiled=True, tile_size=16)
    la = tlazy.LazyGeoTIFFArray.from_file(p, data.shape, np.float32)
    ja = jlazy.LazyGeoTIFFArray.from_file(p, data.shape, np.float32)
    for key in [(1, slice(None, None, 3), slice(5, 30, 2)),
                (slice(None), 10, slice(None)), (slice(None), slice(None,
                                                                  None, -1))]:
        same_array(np.asarray(la[key]), data[key], key)
        same_array(np.asarray(la[key]), np.asarray(ja[key]), key)
    same_array(np.asarray(la[0][2:30][::2]), data[0][2:30][::2])


def test_lazy_rasterio_planar_and_predictor(tmp_path):
    rng = np.random.RandomState(3)
    data = (rng.rand(2, 37, 29) * 1000).astype(np.int16)
    p = str(tmp_path / 'p.tif')
    tgt.write_geotiff(p, data, compress=True)
    lazy = tio.open_rasterio(p, chunks={}, device='cpu')
    got = lazy.isel(band=1, y=slice(30, 37))
    assert got.dtype == torch.int16
    same_array(got.data, data[1, 30:37])
    same_dataset(got, jio.open_rasterio(p, chunks={}).isel(
        band=1, y=slice(30, 37)))


@pytest.mark.parametrize('name', ['predictor3', 'big_endian', 'bigtiff'])
def test_lazy_rasterio_reads_foreign_layouts(tmp_path, name):
    """Windows of files our writer does not write (the floating-point
    predictor, a big-endian file with the horizontal predictor, BigTIFF)
    equal the eager read and nd_tpu's lazy window."""
    from test_torch_geotiff import FOREIGN
    p = FOREIGN[name](str(tmp_path / (name + '.tif')))
    eager = tio.open_rasterio(p, device='cpu').values
    lazy = tio.open_rasterio(p, chunks={}, device='cpu')
    assert lazy.variable.is_lazy
    win = dict(band=0, y=slice(1, None, 2), x=slice(2, 7))
    got = lazy.isel(win)
    assert got.variable.is_lazy
    same_array(got.values, eager[0, 1::2, 2:7])
    same_dataset(got, jio.open_rasterio(p, chunks={}).isel(win))


# ---------------------------------------------------------------------------
# out of core: a 768 MB classic file through tile -> map -> tiles, h5py
# blocked, peak RSS held
# ---------------------------------------------------------------------------

OUT_OF_CORE = textwrap.dedent('''
    import sys
    for name in ('h5py', 'pandas'):
        sys.modules[name] = None          # the card's machine has neither
    import glob, json, os
    import numpy as np
    import nd_tpu_torch  # noqa: F401
    from nd_tpu_torch.io import open_netcdf
    from nd_tpu_torch.io.lazy import LazyNetCDFArray
    from nd_tpu_torch.tiling import map_over_tiles, tile

    src, root = sys.argv[1], sys.argv[2]
    reads = []
    orig = LazyNetCDFArray._materialize

    def counting(self, key):
        out = orig(self, key)
        reads.append(out.nbytes)
        return out
    LazyNetCDFArray._materialize = counting
    lazy = open_netcdf(src, rename_latlon=False, chunks={}, device='cpu')
    assert lazy._variables['sar'].is_lazy and not reads
    warm = lazy.isel(y=slice(0, 257))
    first = (warm['sar'] * 2.0).values[:256]         # the warm tile
    del lazy, warm
    print('warm', flush=True)
    sys.stdin.readline()                  # the parent takes the baseline
    tiles = os.path.join(root, 'tiles')
    tile(src, tiles, chunks={'y': 256}, buffer=1, max_workers=2)
    # one worker: on the CPU the prefetched tiles and the results the
    # writers hold are host memory themselves (on the card they are not)
    outs = map_over_tiles(os.path.join(tiles, '*.nc'), lambda d: d * 2.0,
                          path=os.path.join(root, 'out'), merge=False,
                          max_workers=1, device='cpu')
    got = open_netcdf(os.path.join(root, 'out', 'part.y_0_257.nc'),
                      rename_latlon=False, device='cpu')['sar'].values
    print(json.dumps({'outs': len(outs),
                      'tiles': len(glob.glob(os.path.join(tiles, '*.nc'))),
                      'max_read': max(reads),
                      'first': bool(np.array_equal(got[:256], first))}))
''')


def _write_classic_header(fh, ny, nx, k):
    """A CDF-2 header for float32 'sar' (y, x, k) and float64 coordinate
    variables y, x, k; returns where each variable's data begins (the
    classic writer holds a variable whole, so the test streams the data
    itself)."""
    import struct

    def name(s):
        b = s.encode()
        return struct.pack('>I', len(b)) + b + b'\0' * (-len(b) % 4)
    dims = [('y', ny), ('x', nx), ('k', k)]
    variables = [('y', [0], 6, ny * 8), ('x', [1], 6, nx * 8),
                 ('k', [2], 6, k * 8), ('sar', [0, 1, 2], 5, ny * nx * k * 4)]
    head = b'CDF\x02' + struct.pack('>I', 0)
    head += struct.pack('>II', 0x0A, len(dims))
    for n, s in dims:
        head += name(n) + struct.pack('>I', s)
    head += struct.pack('>II', 0, 0)                     # no attributes
    head += struct.pack('>II', 0x0B, len(variables))
    size = len(head) + sum(len(name(n)) + 4 + 4 * len(d) + 8 + 4 + 4 + 8
                           for n, d, _, _ in variables)
    begins = {}
    offset = size
    for n, d, t, nbytes in variables:
        head += name(n) + struct.pack('>I', len(d))
        head += b''.join(struct.pack('>I', i) for i in d)
        head += struct.pack('>II', 0, 0)
        head += struct.pack('>IIQ', t, min(nbytes, 2 ** 32 - 1), offset)
        begins[n] = offset
        offset += nbytes
    assert len(head) == size
    fh.write(head)
    return begins


def test_out_of_core_pipeline_holds_peak_rss_under_half_the_cube(tmp_path):
    """A 768 MB cube streams through tile -> map_over_tiles in a process
    whose peak RSS rises by less than half the cube over its baseline
    after the imports and one warm tile, on the classic route (h5py
    blocked, as on the card's machine)."""
    ny, nx, k = 4000, 4000, 12
    src = str(tmp_path / 'big.nc')
    rng = np.random.RandomState(0)
    with open(src, 'wb') as fh:
        _write_classic_header(fh, ny, nx, k)
        for n in (ny, nx, k):
            fh.write(np.arange(float(n)).astype('>f8').tobytes())
        for y0 in range(0, ny, 500):
            fh.write(rng.rand(500, nx, k).astype('>f4').tobytes())
    cube_bytes = ny * nx * k * 4
    assert os.path.getsize(src) > cube_bytes
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get('PYTHONPATH', '').split(os.pathsep)))
    try:
        rc, out, err, base, peak = run_sampling_rss(
            [sys.executable, '-c', OUT_OF_CORE, src, str(tmp_path)],
            env=env, timeout=600)
    finally:
        for name in ('big.nc', 'tiles', 'out'):       # 2.3 GB on disk
            target = tmp_path / name
            if target.is_dir():
                shutil.rmtree(target)
            elif target.exists():
                target.unlink()
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res['tiles'] == res['outs'] == (ny + 255) // 256
    assert res['first']
    assert res['max_read'] == 258 * nx * k * 4       # one buffered tile
    assert base > 0 and peak - base < cube_bytes / 2, (base, peak)


def test_a_lazy_complex_variable_is_written_without_being_read_onto_a_device(
        tmp_path):
    """to_netcdf splits a lazy complex variable on the host: the view
    stays a view, and the file holds its real and imaginary parts."""
    z = (np.arange(12.0) + 1j * np.arange(12.0)[::-1]).astype(np.complex64)
    p = str(tmp_path / 'z.nc')
    with h5py.File(p, 'w') as f:
        f.create_dataset('z', data=z.reshape(3, 4))
    lazy = tio.open_netcdf(p, rename_latlon=False, chunks={}, device='cpu')
    assert lazy._variables['z'].is_lazy
    assert lazy['z'].dtype == torch.complex64
    q = str(tmp_path / 'parts.nc')
    tio.to_netcdf(lazy, q)
    assert lazy._variables['z'].is_lazy
    back = tio.open_netcdf(q, rename_latlon=False, as_complex=True,
                           device='cpu')
    same_array(back['z'].values, z.reshape(3, 4))


def _scipy_classic(path, version):
    """A classic file as other tools write them: a record (unlimited)
    time dimension with two record variables (one int16, padded in each
    record), a char variable, a scalar, and attributes of every type."""
    from scipy.io import netcdf_file
    rng = np.random.RandomState(6)
    f = netcdf_file(path, 'w', version=version)
    f.createDimension('time', None)
    f.createDimension('y', 5)
    f.createDimension('x', 7)
    f.createDimension('nchar', 4)
    f.title = b'classic from scipy'
    f.levels = np.array([1, 2, 3], np.int32)
    f.scale = np.float64(0.5)
    t = f.createVariable('time', 'f8', ('time',))
    t[:] = np.arange(6) * 24.0
    t.units = b'hours since 2021-01-01'
    a = f.createVariable('a', 'f4', ('time', 'y', 'x'))
    a[:] = rng.rand(6, 5, 7).astype(np.float32)
    a.long_name = b'a record variable'
    b = f.createVariable('b', 'i2', ('time', 'x'))
    b[:] = rng.randint(-300, 300, (6, 7)).astype(np.int16)
    b.valid = np.array([-300, 300], np.int16)
    c = f.createVariable('c', 'f8', ('y', 'x'))
    c[:] = rng.rand(5, 7)
    n = f.createVariable('name', 'c', ('y', 'nchar'))
    n[:] = np.array([list('r%03d' % i) for i in range(5)], 'S1')
    s = f.createVariable('s', 'i4', ())
    s[...] = 42
    f.close()


@pytest.mark.parametrize('version', [1, 2])
def test_classic_reader_equals_scipy(tmp_path, version):
    """The port reads classic files from a header parser and positional
    reads: its eager and lazy opens equal nd_tpu's (scipy's reader), and
    every slab the lazy views can ask for equals scipy's data."""
    p = str(tmp_path / 'c.nc')
    _scipy_classic(p, version)
    want = jio.open_netcdf(p, rename_latlon=False)
    same_dataset(tio.open_netcdf(p, rename_latlon=False, device='cpu'), want)
    same_dataset(tio.open_netcdf(p, rename_latlon=False, chunks={},
                                 device='cpu'), want)
    hold_classic_slabs(p)


@pytest.mark.parametrize('call_bytes', [-1, 1 << 62])
@pytest.mark.parametrize('version', [1, 2])
def test_classic_reader_routes_equal_scipy(tmp_path, monkeypatch, version,
                                           call_bytes):
    """Forced to read a row at a time (-1) or a block of whole rows
    wherever the rows are contiguous, the slab reader still returns
    scipy's data for every key."""
    p = str(tmp_path / 'c.nc')
    _scipy_classic(p, version)
    monkeypatch.setattr(tnc, '_READ_CALL_BYTES', call_bytes)
    hold_classic_slabs(p)


def hold_classic_slabs(p):
    """The classic layout of ``p`` and a set of slabs of each of its
    variables against scipy's reader."""
    from scipy.io import netcdf_file
    dims, gattrs, layout = tnc._classic_layout(p)
    f = netcdf_file(p, 'r', mmap=False)
    try:
        assert dims == {d: n or 0 for d, n in f.dimensions.items()}
        assert set(gattrs) == set(f._attributes)
        for k, v in gattrs.items():
            same_array(np.asarray(v), np.asarray(f._attributes[k]), k)
        keys = [(slice(0, None),), (2,), (slice(1, 6, 2),),
                (slice(1, 4), slice(2, 6)), (3, slice(0, 7, 3)),
                (slice(0, 6, 5), 4, slice(1, 5, 2)), (slice(2, 2),),
                (5, slice(6, 7), 0)]
        for name, vdims, attrs, dtype, shape, begin, stride in layout:
            ref = f.variables[name].data
            assert shape == ref.shape and dtype == ref.dtype, name
            for key in keys:
                key = key[:len(shape)]
                if any(isinstance(k, int) and k >= n or
                       isinstance(k, slice) and k.start >= n
                       for k, n in zip(key, shape)):
                    continue
                key = key + tuple(slice(0, n) for n in shape[len(key):])
                got = tnc._read_classic_slab(p, begin, stride, shape, dtype,
                                             key)
                same_array(got, ref[key], (name, key))
                assert got.dtype.isnative
    finally:
        f.close()


def test_classic_reader_rejects_what_it_cannot_read(tmp_path):
    p = str(tmp_path / 'bad.nc')
    with open(p, 'wb') as fh:
        fh.write(b'CDF\x05' + b'\0' * 20)
    with pytest.raises(ValueError, match='version 5'):
        tnc._classic_layout(p)
    with open(p, 'wb') as fh:
        fh.write(b'CDF\x02\0\0')
    with pytest.raises(ValueError, match='truncated'):
        tnc._classic_layout(p)
