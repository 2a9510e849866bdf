"""nd_tpu_torch.tiling against nd_tpu.tiling on twin cubes (the two
``generate_test_dataset``s draw the same values from one seed): tile
names, each package reading the other's tiles, resume, buffered
``map_over_tiles`` against the whole image (a boxcar and the omnibus
test), ``Delayed``, ``sort_into_array``, ``debuffer`` and ``auto_merge``
with categorical meta variables numbered as ``pandas.factorize`` numbers
them. Everything runs on the CPU (``device='cpu'``); merges are exact."""

import os

import numpy as np
import pytest
import torch

import nd_tpu_torch as ndt
from nd_tpu import tiling as jt
from nd_tpu.core import Dataset as JDataset
from nd_tpu.filters import BoxcarFilter as JBoxcar
from nd_tpu.io import open_netcdf as jopen
from nd_tpu.testing import generate_test_dataset as jgen
from nd_tpu_torch import tiling as tt
from nd_tpu_torch.core import DataArray, Dataset
from nd_tpu_torch.io import netcdf as tnc
from nd_tpu_torch.testing import generate_test_dataset as tgen
from torch_io_helpers import same_array, same_dataset

DIMS = {'y': 30, 'x': 24, 'time': 4}


@pytest.fixture
def twins():
    return jgen(dims=DIMS), tgen(dims=DIMS, device='cpu')


def _names(path):
    return sorted(f for f in os.listdir(path) if f.endswith('.nc'))


def _same_values(got, want, rtol=0):
    """A port Dataset's variables and coordinates equal nd_tpu's (or
    another port Dataset's), each transposed to the other's dims."""
    for v in want.data_vars:
        g = got[v].transpose(*want[v].dims).values
        w = np.asarray(want[v].values)
        if rtol:
            np.testing.assert_allclose(g, w, rtol=rtol)
        else:
            same_array(g, w, v)
    for c in ('y', 'x'):
        same_array(got[c].values, np.asarray(want[c].values), c)


@pytest.mark.parametrize('buffer', [0, 2, {'y': 3}])
@pytest.mark.parametrize('chunks', [{'y': 10}, {'y': 10, 'x': 10},
                                    {'y': 7, 'x': 11}])
def test_both_packages_tile_alike(tmp_path, twins, chunks, buffer):
    j, t = twins
    tt.tile(t, str(tmp_path / 't'), chunks=chunks, buffer=buffer)
    jt.tile(j, str(tmp_path / 'j'), chunks=chunks, buffer=buffer)
    names = _names(tmp_path / 't')
    assert names == _names(tmp_path / 'j')
    n = int(np.ceil(30 / chunks.get('y', 30))) \
        * int(np.ceil(24 / chunks.get('x', 24)))
    assert len(names) == n
    for name in names:
        same_dataset(ndt.open_dataset(str(tmp_path / 't' / name),
                                      rename_latlon=False, device='cpu'),
                     jopen(str(tmp_path / 'j' / name), rename_latlon=False))
    merged = tt.auto_merge(str(tmp_path / 't' / '*.nc'), device='cpu')
    _same_values(merged, j)
    same_dataset(merged, jt.auto_merge(str(tmp_path / 'j' / '*.nc')))


@pytest.mark.parametrize('writer', ['netcdf4', 'classic'])
def test_each_package_reads_the_others_tiles(tmp_path, twins, monkeypatch,
                                             writer):
    j, t = twins
    with monkeypatch.context() as m:
        if writer == 'classic':
            m.setattr(tnc, '_h5py', lambda: None)
        tt.tile(t, str(tmp_path / 't'), chunks={'y': 10, 'x': 10}, buffer=1)
    with open(str(tmp_path / 't' / _names(tmp_path / 't')[0]), 'rb') as fh:
        assert (fh.read(3) == b'CDF') == (writer == 'classic')
    jt.tile(j, str(tmp_path / 'j'), chunks={'y': 10, 'x': 10}, buffer=1)
    port_of_j = tt.auto_merge(str(tmp_path / 'j' / '*.nc'), device='cpu')
    same_dataset(port_of_j, jt.auto_merge(str(tmp_path / 'j' / '*.nc')))
    j_of_port = jt.auto_merge(str(tmp_path / 't' / '*.nc'))
    port_of_port = tt.auto_merge(str(tmp_path / 't' / '*.nc'), device='cpu')
    same_dataset(port_of_port, j_of_port)
    _same_values(port_of_port, j)


def test_tile_resumes(tmp_path, twins):
    """Existing tiles are skipped: an interrupted job resumes."""
    _, t = twins
    tt.tile(t, str(tmp_path), chunks={'y': 10})
    names = _names(tmp_path)
    os.remove(str(tmp_path / names[1]))
    mtimes = {f: os.path.getmtime(str(tmp_path / f)) for f in names
              if f != names[1]}
    tt.tile(t, str(tmp_path), chunks={'y': 10})
    assert _names(tmp_path) == names
    for f, m in mtimes.items():
        assert os.path.getmtime(str(tmp_path / f)) == m
    assert not [f for f in os.listdir(tmp_path) if f.endswith('.part')]


def test_tile_rejects_a_file_and_missing_chunks(tmp_path, twins):
    _, t = twins
    f = tmp_path / 'file.nc'
    f.write_bytes(b'')
    with pytest.raises(ValueError, match='cannot be a file'):
        tt.tile(t, str(f), chunks={'y': 10})
    with pytest.raises(ValueError, match='chunks'):
        tt.tile(t, str(tmp_path / 'd'))
    with pytest.raises(ValueError, match='no tile inputs'):
        tt.auto_merge(str(tmp_path / 'none' / '*.nc'))


@pytest.mark.parametrize('fn', ['identity', 'scale'])
def test_map_over_tiles_equals_nd_tpu(tmp_path, twins, fn):
    j, t = twins
    func = {'identity': lambda d: d, 'scale': lambda d: d * 2}[fn]
    tt.tile(t, str(tmp_path / 't'), chunks={'y': 10})
    jt.tile(j, str(tmp_path / 'j'), chunks={'y': 10})
    got = tt.map_over_tiles(str(tmp_path / 't' / '*.nc'), func,
                            device='cpu')
    want = jt.map_over_tiles(str(tmp_path / 'j' / '*.nc'), func)
    same_dataset(got, want)
    assert sorted(os.listdir(tmp_path / 't')) == \
        sorted(os.listdir(tmp_path / 'j'))


@pytest.mark.parametrize('workers', [1, 3, None])
def test_map_over_tiles_with_a_buffer_equals_the_whole_image(tmp_path,
                                                             twins, workers):
    """Boxcar over buffered tiles == boxcar over the whole image, in
    both packages, with every pool width."""
    j, t = twins
    whole = ndt.BoxcarFilter(w=3).apply(t)
    tt.tile(t, str(tmp_path / 't'), chunks={'y': 10}, buffer=1)
    got = tt.map_over_tiles(str(tmp_path / 't' / '*.nc'),
                            ndt.BoxcarFilter(w=3).apply, device='cpu',
                            max_workers=workers)
    _same_values(got, whole)
    jt.tile(j, str(tmp_path / 'j'), chunks={'y': 10}, buffer=1)
    want = jt.map_over_tiles(str(tmp_path / 'j' / '*.nc'),
                             JBoxcar(w=3).apply)
    _same_values(got, want, rtol=1e-6)


def test_map_over_tiles_change_detection(tmp_path):
    """The exact omnibus test over tiles (a pixelwise op: buffer 0)
    equals the whole cube, and nd_tpu's tiles."""
    j = jgen(dims={'y': 24, 'x': 24, 'time': 6}, mean=[1, 0, 0, 1],
             sigma=0.1)
    t = tgen(dims={'y': 24, 'x': 24, 'time': 6}, mean=[1, 0, 0, 1],
             sigma=0.1, device='cpu')
    for v in ('C11', 'C22'):
        j[v] = (j[v].dims, np.abs(j[v].values) + 0.5)
        t[v] = (t[v].dims, np.abs(t[v].values) + 0.5)
    algo = ndt.OmnibusTest(n=9, alpha=0.9)
    whole = algo.apply(t)
    tt.tile(t, str(tmp_path / 't'), chunks={'y': 8})
    got = tt.map_over_tiles(
        str(tmp_path / 't' / '*.nc'),
        lambda d: algo.apply(d).to_dataset(name='change'), device='cpu')
    assert got['change'].dtype == torch.bool
    same_array(got['change'].transpose(*whole.dims).data, whole.data)
    from nd_tpu.change import OmnibusTest as JOmnibus
    jalgo = JOmnibus(n=9, alpha=0.9)
    same_array(whole.data, np.asarray(jalgo.apply(j).values))


def test_map_over_tiles_the_readme_chain_with_a_buffer(tmp_path):
    """NLMeans then the omnibus test over 4-pixel buffered tiles equal
    the chain on the whole cube: the filtered values and the change
    map."""
    from torch_cubes import sar_cube
    cube = torch.from_numpy(sar_cube(40, 36, 12, seed=76, special=False))
    names = ('C11', 'C12__re', 'C12__im', 'C22')
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(names)},
                 coords={'y': np.arange(40.0), 'x': np.arange(36.0),
                         'time': np.datetime64('2023-01-03', 'ns')
                         + np.arange(12) * np.timedelta64(12, 'D')},
                 device='cpu')

    def chain(d):
        flt = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2,
                                h=3).apply(d)
        flt['change'] = ndt.OmnibusTest(ml=3, alpha=0.01).apply(flt)
        return flt
    whole = chain(ds)
    tt.tile(ds, str(tmp_path / 't'), chunks={'y': 16, 'x': 16}, buffer=4)
    got = tt.map_over_tiles(str(tmp_path / 't' / '*.nc'), chain,
                            path=str(tmp_path / 'out'), device='cpu')
    for v in names:
        np.testing.assert_allclose(got[v].values, whole[v].values,
                                   rtol=1e-5, atol=1e-6)
    same_array(got['change'].data, whole['change'].data)
    assert len(_names(tmp_path / 'out')) == 9


def test_map_over_tiles_deferred(tmp_path, twins):
    j, t = twins
    tt.tile(t, str(tmp_path), chunks={'y': 15})
    delayed = tt.map_over_tiles(str(tmp_path / '*.nc'), lambda d: d,
                                compute=False, device='cpu')
    assert isinstance(delayed, tt.Delayed)
    assert not [f for f in os.listdir(tmp_path) if '_new' in f]
    result = delayed.compute()
    assert set(result.data_vars) == set(j.data_vars)
    _same_values(result, j)
    nested = tt.Delayed(lambda a, b: a + b, tt.Delayed(lambda: 2),
                        [tt.Delayed(lambda: 3)][0])
    assert nested.compute() == 5
    assert tt.Delayed(sum, [tt.Delayed(lambda: 1), 2]).compute() == 3


def test_map_over_tiles_dataarray_result_merges_as_a_dataset(tmp_path,
                                                            twins):
    j, t = twins
    tt.tile(t, str(tmp_path), chunks={'y': 8})
    merged = tt.map_over_tiles(str(tmp_path / '*.nc'), lambda d: d['C11'],
                               merge=True, device='cpu')
    assert isinstance(merged, Dataset) and list(merged.data_vars) == ['C11']
    unnamed = tt.map_over_tiles(
        str(tmp_path / '*.nc'),
        lambda d: DataArray(d['C11'].data, dims=d['C11'].dims,
                            coords=dict(d['C11'].coords.items())),
        merge=True, path=str(tmp_path / 'u'), device='cpu')
    assert list(unnamed.data_vars) == ['data']
    same_array(unnamed['data'].values, merged['C11'].values)
    _same_values(merged[['C11']], j[['C11']])


def test_map_over_tiles_accepts_none_workers(tmp_path):
    for i in range(3):
        ds = Dataset({'a': (('x',), np.full(4, float(i)))},
                     coords={'x': np.arange(4.0) + 4 * i}, device='cpu')
        ndt.to_netcdf(ds, str(tmp_path / ('t%d.nc' % i)))
    outs = tt.map_over_tiles(str(tmp_path / 't*.nc'), lambda d: d,
                             merge=False, compute=True, max_workers=None,
                             device='cpu')
    assert len(outs) == 3
    assert all(o.endswith('_new.nc') for o in outs)


def test_sort_into_array_and_sort_key(twins):
    j, t = twins
    from nd_tpu_torch.utils import xr_split
    from nd_tpu.utils import xr_split as jsplit
    parts = list(xr_split(t, 'y', 3))
    grid = tt.sort_into_array(parts[::-1])
    jgrid = jt.sort_into_array(list(jsplit(j, 'y', 3))[::-1])
    assert grid.shape == jgrid.shape
    ydim = list(t.sizes).index('y')
    assert grid.shape[ydim] == 3
    for g, w in zip(grid.flat, jgrid.flat):
        same_array(g['y'].values, np.asarray(w['y'].values))
    keys = [tt.sort_key(p, ('y', 'x')) for p in parts]
    jkeys = [jt.sort_key(p, ('y', 'x')) for p in jsplit(j, 'y', 3)]
    assert keys == jkeys


@pytest.mark.parametrize('buffer', [1, 2, 3])
def test_debuffer_equals_nd_tpu(tmp_path, twins, buffer):
    j, t = twins
    tt.tile(t, str(tmp_path / 't'), chunks={'y': 7, 'x': 9}, buffer=buffer)
    jt.tile(j, str(tmp_path / 'j'), chunks={'y': 7, 'x': 9}, buffer=buffer)
    got = tt.debuffer([ndt.open_dataset(str(tmp_path / 't' / f),
                                        rename_latlon=False, device='cpu')
                       for f in _names(tmp_path / 't')], flat=False)
    want = jt.debuffer([jopen(str(tmp_path / 'j' / f), rename_latlon=False)
                        for f in _names(tmp_path / 'j')], flat=False)
    assert got.shape == want.shape
    for g, w in zip(got.flat, want.flat):
        assert dict(g.sizes) == dict(w.sizes)
        same_array(g['y'].values, np.asarray(w['y'].values))
        same_array(g['x'].values, np.asarray(w['x'].values))


def _orbit_tiles(tmp_path, t, j, orbits):
    """One tile a date, each with its orbit attribute."""
    tt.tile(t, str(tmp_path / 't'), chunks={'time': 1})
    jt.tile(j, str(tmp_path / 'j'), chunks={'time': 1})
    got = [ndt.open_dataset(str(tmp_path / 't' / f), device='cpu')
           for f in _names(tmp_path / 't')]
    want = [jopen(str(tmp_path / 'j' / f)) for f in _names(tmp_path / 'j')]
    for g, w, orbit in zip(got, want, orbits):
        g.attrs['orbit'] = w.attrs['orbit'] = orbit
        g.attrs['relative_orbit'] = w.attrs['relative_orbit'] = 117
    return got, want


@pytest.mark.parametrize('orbits', [
    ['descending', 'ascending', 'descending', 'ascending'],
    ['S1B', 'S1A', 'S1C', 'S1A'], ['b', 'b', 'a', 'c']])
def test_auto_merge_meta_variables_numbered_as_nd_tpu(tmp_path, twins,
                                                      orbits):
    """Categorical meta values are numbered in order of first appearance
    (pandas.factorize's order, not np.unique's), with the same legend."""
    j, t = twins
    got, want = _orbit_tiles(tmp_path, t, j, orbits)
    merged = tt.auto_merge(got, meta_variables=['orbit', 'relative_orbit'])
    jmerged = jt.auto_merge(want, meta_variables=['orbit', 'relative_orbit'])
    for meta in ('orbit', 'relative_orbit'):
        g, w = merged._variables[meta], jmerged._variables[meta]
        assert g.dims == w.dims
        same_array(g.values, np.asarray(w.values).astype(g.values.dtype))
        assert g.attrs == w.attrs
    assert merged._variables['orbit'].attrs['legend'] == tuple(
        enumerate(dict.fromkeys(orbits)))
    legend = dict(merged._variables['orbit'].attrs['legend'])
    assert [legend[c] for c in merged._variables['orbit'].values] == orbits
    assert 'legend' not in merged._variables['relative_orbit'].attrs


def test_factorize_equals_pandas():
    pd = pytest.importorskip('pandas')
    rng = np.random.RandomState(5)
    cases = [np.array(['c', 'a', 'b', 'a', 'c']),
             rng.choice(['x', 'yy', 'zzz'], size=40),
             np.array([None, 'b', None, 'a'], dtype=object),
             np.array(['2020-01-02', 'NaT', '2019-05-01', '2020-01-02'],
                      dtype='datetime64[ns]')]
    for vals in cases:
        codes, legend = tt._factorize(vals)
        pcodes, plegend = pd.factorize(vals)
        same_array(codes, pcodes.astype(np.int64))
        assert legend == list(plegend)


def test_auto_merge_meta_without_time():
    a = Dataset({'v': (('y', 'x'), np.zeros((2, 3)))},
                coords={'y': np.array([0., 1.]), 'x': np.array([0., 1., 2.])},
                attrs={'sensor': 'S1A'}, device='cpu')
    b = Dataset({'v': (('y', 'x'), np.ones((2, 3)))},
                coords={'y': np.array([2., 3.]), 'x': np.array([0., 1., 2.])},
                attrs={'sensor': 'S1A'}, device='cpu')
    merged = tt.auto_merge([a, b], buffer=False, meta_variables=['sensor'])
    assert 'time' not in merged.sizes
    assert merged._variables['sensor'].dims == ()
    assert merged._variables['sensor'].attrs['legend'] == ((0, 'S1A'),)
    ja = JDataset({'v': (('y', 'x'), np.zeros((2, 3)))},
                  coords={'y': [0, 1], 'x': [0, 1, 2]},
                  attrs={'sensor': 'S1A'})
    jb = JDataset({'v': (('y', 'x'), np.ones((2, 3)))},
                  coords={'y': [2, 3], 'x': [0, 1, 2]},
                  attrs={'sensor': 'S1A'})
    jm = jt.auto_merge([ja, jb], buffer=False, meta_variables=['sensor'])
    same_array(merged['v'].values, np.asarray(jm['v'].values))
    assert merged.attrs == jm.attrs


def test_auto_merge_keeps_common_attrs_and_time(tmp_path, twins):
    j, t = twins
    tt.tile(t, str(tmp_path / 't'), chunks={'y': 10})
    parts = [ndt.open_dataset(str(tmp_path / 't' / f), device='cpu')
             for f in _names(tmp_path / 't')]
    for i, p in enumerate(parts):
        p.attrs['tile'] = i
        p.attrs['mission'] = 'S1'
    merged = tt.auto_merge(parts)
    assert merged.attrs['mission'] == 'S1' and 'tile' not in merged.attrs
    same_array(merged['time'].values, np.asarray(j['time'].values))


def test_tile_from_a_lazy_path_reads_only_slabs(tmp_path, twins,
                                               monkeypatch):
    """tile() of a path never reads the whole cube: its largest read is
    one buffered tile, into host memory."""
    from nd_tpu_torch.io import lazy as tlazy
    j, t = twins
    path = str(tmp_path / 'cube.nc')
    ndt.to_netcdf(t, path)
    reads = []
    orig = tlazy.LazyNetCDFArray._materialize

    def counting(self, key):
        out = orig(self, key)
        reads.append(out.size)
        return out
    monkeypatch.setattr(tlazy.LazyNetCDFArray, '_materialize', counting)
    tt.tile(path, str(tmp_path / 'tiles'), chunks={'y': 10, 'x': 12},
            buffer=1)
    assert reads and max(reads) < 30 * 24 * 4 / 2
    merged = tt.auto_merge(str(tmp_path / 'tiles' / '*.nc'), device='cpu')
    _same_values(merged, j)


def test_tile_of_a_lazy_geotiff(tmp_path):
    from nd_tpu_torch.crs import Affine
    from nd_tpu_torch.io import geotiff as tgt
    rng = np.random.RandomState(4)
    data = (rng.rand(1, 64, 64) * 100).astype(np.float32)
    p = str(tmp_path / 'big.tif')
    tgt.write_geotiff(p, data, tiled=True, tile_size=16,
                      transform=Affine(0.01, 0, 10.0, 0, -0.01, 50.0),
                      crs='epsg:4326')
    da = ndt.io.open_rasterio(p, chunks={}, device='cpu')
    ds = da.to_dataset(name='v')
    assert ds._variables['v'].is_lazy
    ds.nd.tile(str(tmp_path / 'tiles'), chunks={'y': 32, 'x': 32})
    assert ds._variables['v'].is_lazy             # nothing read onto it
    merged = ndt.auto_merge(str(tmp_path / 'tiles' / '*.nc'), device='cpu')
    same_array(merged['v'].values, data)


def test_nd_tile_accessor_equals_the_function(tmp_path, twins):
    _, t = twins
    t.nd.tile(str(tmp_path / 'a'), chunks={'x': 10}, buffer=2)
    tt.tile(t, str(tmp_path / 'b'), chunks={'x': 10}, buffer=2)
    assert _names(tmp_path / 'a') == _names(tmp_path / 'b')
    assert ndt.auto_merge is tt.auto_merge and ndt.tiling is tt


def test_tile_and_map_under_many_threads(tmp_path, twins, monkeypatch):
    """More pool threads than cores and a short switch interval: the
    lazy reads of tile() and the prefetch and write-behind pools of
    map_over_tiles lose no tile and mix no slab (classic route)."""
    import sys
    j, t = twins
    monkeypatch.setattr(tnc, '_h5py', lambda: None)
    path = str(tmp_path / 'cube.nc')
    ndt.to_netcdf(t, path)
    whole = ndt.BoxcarFilter(w=3).apply(t)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tt.tile(path, str(tmp_path / 'tiles'), chunks={'y': 3, 'x': 6},
                buffer=1, max_workers=4 * os.cpu_count())
        got = tt.map_over_tiles(str(tmp_path / 'tiles' / '*.nc'),
                                ndt.BoxcarFilter(w=3).apply, device='cpu',
                                path=str(tmp_path / 'out'),
                                max_workers=4 * os.cpu_count())
    finally:
        sys.setswitchinterval(interval)
    assert len(_names(tmp_path / 'tiles')) == 40
    assert len(_names(tmp_path / 'out')) == 40
    _same_values(got, whole)
