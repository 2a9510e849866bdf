"""netCDF parity of nd_tpu_torch.io with nd_tpu.io, both ways, exact:
files that nd_tpu writes read the same in both packages, files that the
port writes (netCDF-4 through h5py, and netCDF classic through
``_write_netcdf_classic``, the route of a machine without h5py) read the
same in nd_tpu; the CF time decode without pandas equals nd_tpu's to the
nanosecond; and the port's I/O runs with h5py, pandas, lxml, cv2 and
zstandard blocked (the card's machine has none of them)."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import nd_tpu_torch as ndt
from nd_tpu import io as jio
from nd_tpu.core import Dataset as JDataset
from nd_tpu.io import netcdf as jnc
from nd_tpu_torch import io as tio
from nd_tpu_torch.core import Dataset
from nd_tpu_torch.io import netcdf as tnc
from torch_io_helpers import same_array, same_dataset

CRS = '+proj=utm +zone=33 +datum=WGS84 +units=m +no_defs'


def _cube(rng):
    shape = (5, 6, 4)
    c11 = rng.rand(*shape).astype(np.float32)
    c11[rng.rand(*shape) < 0.2] = np.nan
    c12 = (rng.rand(*shape) + 1j * rng.rand(*shape)).astype(np.complex64)
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(4) * np.timedelta64(12, 'D')
    return dict(
        data_vars={'C11': (('y', 'x', 'time'), c11),
                   'C12': (('y', 'x', 'time'), c12),
                   'C22': (('y', 'x', 'time'),
                           rng.rand(*shape).astype(np.float32))},
        coords={'y': 5e5 - 10 * np.arange(5.0), 'x': 3e5 + 10 * np.arange(6.0),
                'time': times},
        attrs={'crs': CRS, 'transform': (10.0, 0.0, 3e5, 0.0, -10.0, 5e5),
               'title': 'cube', 'n_looks': 3, 'scale': 0.25})


def _bool(rng):
    return dict(data_vars={'mask': (('y',), rng.rand(5) > 0.5)},
                coords={'y': np.arange(5)})


def _coord2d(rng):
    return dict(data_vars={'v': (('y', 'x'), rng.rand(4, 3))},
                coords={'y': np.arange(4.0), 'x': np.arange(3.0),
                        'lat': (('y', 'x'), rng.rand(4, 3))})


def _scalar_coord(rng):
    return dict(data_vars={'v': (('y', 'x'), rng.rand(4, 3))},
                coords={'y': np.arange(4.0), 'x': np.arange(3.0),
                        'time': np.datetime64('2021-05-06T07:08:09', 'ns')})


def _no_coord(rng):
    return dict(data_vars={'v': (('y', 'x'), np.arange(12.).reshape(3, 4))})


def _dtypes(rng):
    return dict(data_vars={
        'i1': (('y',), rng.randint(-100, 100, 6).astype(np.int8)),
        'i2': (('y',), rng.randint(-900, 900, 6).astype(np.int16)),
        'i4': (('y',), rng.randint(-10 ** 6, 10 ** 6, 6).astype(np.int32)),
        'f4': (('y',), rng.rand(6).astype(np.float32)),
        'f8': (('y',), rng.rand(6))},
        coords={'y': np.arange(6, dtype=np.int32)})


def _dtypes_hdf5(rng):
    spec = _dtypes(rng)
    spec['data_vars'].update({
        'i8': (('y',), rng.randint(-10 ** 12, 10 ** 12, 6)),
        'u1': (('y',), rng.randint(0, 255, 6).astype(np.uint8)),
        'u2': (('y',), rng.randint(0, 60000, 6).astype(np.uint16)),
        'f2': (('y',), rng.rand(6).astype(np.float16))})
    return spec


def _strings(rng):
    return dict(data_vars={'v': (('band',), rng.rand(3))},
                coords={'band': np.array(['VV', 'VH', 'HH'])})


def _aux_only(rng):
    return dict(coords={'x': np.arange(3.0),
                        'label': (('x',), np.array([1., 2., 3.]))})


HDF5_CASES = {'cube': _cube, 'bool': _bool, 'coord2d': _coord2d,
              'scalar_coord': _scalar_coord, 'no_coord': _no_coord,
              'dtypes': _dtypes_hdf5, 'strings': _strings,
              'aux_only': _aux_only}
CLASSIC_CASES = {'cube': _cube, 'coord2d': _coord2d,
                 'scalar_coord': _scalar_coord, 'no_coord': _no_coord,
                 'dtypes': _dtypes}


def twins(make, seed=0):
    spec = make(np.random.RandomState(seed))
    j = JDataset(spec.get('data_vars'), coords=spec.get('coords'),
                 attrs=spec.get('attrs'))
    t = Dataset(spec.get('data_vars'), coords=spec.get('coords'),
                attrs=spec.get('attrs'), device='cpu')
    return j, t


def _has_complex(spec_make):
    return spec_make is _cube


@pytest.mark.parametrize('case', sorted(HDF5_CASES))
def test_port_reads_what_nd_tpu_writes(tmp_path, case):
    j, _ = twins(HDF5_CASES[case])
    p = str(tmp_path / 'j.nc')
    jio.to_netcdf(j, p)
    cplx = _has_complex(HDF5_CASES[case])
    same_dataset(tio.open_netcdf(p, as_complex=cplx, device='cpu'),
                 jio.open_netcdf(p, as_complex=cplx))


@pytest.mark.parametrize('case', sorted(HDF5_CASES))
def test_nd_tpu_reads_what_the_port_writes(tmp_path, case):
    """The port's netCDF-4 file reads in nd_tpu as nd_tpu's own file of
    the same dataset does, and back in the port as it was written."""
    j, t = twins(HDF5_CASES[case])
    pt, pj = str(tmp_path / 't.nc'), str(tmp_path / 'j.nc')
    assert tio.to_netcdf(t, pt) == pt
    jio.to_netcdf(j, pj)
    cplx = _has_complex(HDF5_CASES[case])
    want = jio.open_netcdf(pj, as_complex=cplx)
    same_dataset(jio.open_netcdf(pt, as_complex=cplx), want)
    back = tio.open_netcdf(pt, as_complex=cplx, device='cpu')
    same_dataset(back, want)
    for name in t._variables:
        same_array(back._variables[name].data, t._variables[name].data, name)


@pytest.mark.parametrize('case', sorted(CLASSIC_CASES))
def test_classic_writer_reads_back_in_both_packages(tmp_path, case):
    """``_write_netcdf_classic`` (CDF-2, scipy): nd_tpu reads the file as
    the port does, and both give back what was written (attrs as the
    classic format stores them: numbers as arrays or int32)."""
    _, t = twins(CLASSIC_CASES[case])
    p = str(tmp_path / 'c.nc')
    tnc._write_netcdf_classic(tio.disassemble_complex(t), p)
    with open(p, 'rb') as fh:
        assert fh.read(4) == b'CDF\x02'
    cplx = _has_complex(CLASSIC_CASES[case])
    got = tio.open_netcdf(p, as_complex=cplx, device='cpu')
    same_dataset(got, jio.open_netcdf(p, as_complex=cplx))
    assert set(got._variables) == set(t._variables)
    for name, var in list(t._variables.items()) + list(t._coords.items()):
        back = (got._variables if name in t._variables else got._coords)[name]
        assert back.dims == var.dims
        same_array(back.data, var.data, name)
    for k, v in t.attrs.items():
        assert np.array_equal(np.asarray(got.attrs[k]), np.asarray(v)), k


def test_classic_bool_stays_int8_as_in_nd_tpu(tmp_path):
    """A bool written classic reads back int8 with its ``dtype`` attr in
    both packages (nd_tpu's classic reader does not restore bool)."""
    mask = np.random.RandomState(0).rand(5) > 0.5
    t = Dataset({'mask': (('y',), mask)},
                coords={'y': np.arange(5, dtype=np.int32)}, device='cpu')
    p = str(tmp_path / 'b.nc')
    tnc._write_netcdf_classic(t, p)
    got = tio.open_netcdf(p, device='cpu')
    same_dataset(got, jio.open_netcdf(p))
    assert got['mask'].dtype == torch.int8
    assert got['mask'].attrs == {'dtype': 'bool'}
    same_array(got['mask'].data, t['mask'].data.to(torch.int8))


@pytest.mark.parametrize('case,match', [
    ('i8', 'no int64'), ('u2', 'no uint16'), ('strings', r'no \|S2'),
    ('aux_only', 'covers no data variable'), ('ns_time', 'not exact'),
])
def test_classic_writer_raises_on_what_cdf2_cannot_hold(tmp_path, case,
                                                        match):
    if case in ('i8', 'u2'):
        spec = _dtypes_hdf5(np.random.RandomState(0))
        ds = Dataset({case: spec['data_vars'][case]}, device='cpu')
    elif case == 'ns_time':
        ds = Dataset(coords={'time': np.array(['2020-01-01T00:00:00.000000001'],
                                              'datetime64[ns]')})
    else:
        _, ds = twins({'strings': _strings, 'aux_only': _aux_only}[case])
    p = str(tmp_path / 'x.nc')
    with pytest.raises((TypeError, ValueError), match=match):
        tnc._write_netcdf_classic(ds, p)
    assert not os.path.exists(p)


def test_classic_writer_raises_past_the_cdf2_size_limit(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(tnc, '_CLASSIC_VAR_LIMIT', 64)
    ds = Dataset({'v': (('y',), np.zeros(16))}, device='cpu')
    with pytest.raises(ValueError, match='under 4 GiB'):
        tnc._write_netcdf_classic(ds, str(tmp_path / 'big.nc'))


def test_public_route_writes_netcdf4_where_h5py_imports(tmp_path):
    _, t = twins(_no_coord)
    p = str(tmp_path / 'h.nc')
    ndt.to_netcdf(t, p)
    assert tnc.writer() == 'netCDF-4'
    with open(p, 'rb') as fh:
        assert fh.read(8) == b'\x89HDF\r\n\x1a\n'


def test_complevel_zero_writes_contiguous(tmp_path):
    import h5py
    _, t = twins(_cube)
    p = str(tmp_path / 'c0.nc')
    tio.to_netcdf(t, p, complevel=0)
    with h5py.File(p, 'r') as f:
        assert f['C11'].chunks is None and f['C11'].compression is None
    p5 = str(tmp_path / 'c5.nc')
    tio.to_netcdf(t, p5)
    with h5py.File(p5, 'r') as f:
        assert f['C11'].compression == 'gzip'


def test_accessor_writes_as_the_function(tmp_path):
    _, t = twins(_cube)
    pa, pf = str(tmp_path / 'a.nc'), str(tmp_path / 'f.nc')
    t.nd.to_netcdf(pa)
    tio.to_netcdf(t, pf)
    same_dataset(tio.open_netcdf(pa, as_complex=True, device='cpu'),
                 tio.open_netcdf(pf, as_complex=True, device='cpu'))


def _h5(path, build):
    import h5py
    with h5py.File(path, 'w') as f:
        build(f)
    return path


def _time_fill(f):
    d = f.create_dataset('time', data=np.array([0, 86400, -9999], np.int64))
    d.attrs['units'] = 'seconds since 2000-01-01'
    d.attrs['_FillValue'] = np.int64(-9999)
    d.make_scale('time')


def _missing(f):
    d = f.create_dataset('v', data=np.array([1.5, -9999.0, 2.5]))
    d.attrs['missing_value'] = -9999.0


def _calendar(f):
    d = f.create_dataset('t', data=np.array([0, 360], np.int64))
    d.attrs['units'] = 'days since 2000-01-01'
    d.attrs['calendar'] = '360_day'


def _scalar_string(f):
    f.create_dataset('label', data='hello')


def _packed(f):
    d = f.create_dataset('v', data=np.array([[1, 2, -1], [4, 5, 6]],
                                            np.int16))
    d.attrs['scale_factor'] = 0.5
    d.attrs['add_offset'] = 10.0
    d.attrs['_FillValue'] = np.int16(-1)
    d.attrs['long_name'] = np.bytes_(b'packed')


def _phony(f):
    f.create_dataset('a', data=np.zeros((3, 3)))
    f.create_dataset('b', data=np.ones((3, 4), np.float32))


def _float_days(f):
    d = f.create_dataset('time', data=np.array([0.0, 0.5, 1 / 3, 2.25,
                                                np.nan, -1.1]))
    d.attrs['units'] = 'days since 1858-11-17 00:00:00.0'
    d.make_scale('time')


H5_FILES = {'time_fill': _time_fill, 'missing_value': _missing,
            'calendar': _calendar, 'scalar_string': _scalar_string,
            'packed': _packed, 'phony_dims': _phony,
            'float_days': _float_days}


@pytest.mark.parametrize('name', sorted(H5_FILES))
def test_hand_written_hdf5_reads_as_in_nd_tpu(tmp_path, name):
    p = _h5(str(tmp_path / 'h.nc'), H5_FILES[name])
    for decode_cf in (True, False):
        same_dataset(tio.open_netcdf(p, decode_cf=decode_cf, device='cpu'),
                     jio.open_netcdf(p, decode_cf=decode_cf))


def test_hand_written_classic_reads_as_in_nd_tpu(tmp_path):
    """A classic file with a record dim, fill, scale and CF time (the
    JAX package's own classic case)."""
    from scipy.io import netcdf_file
    p = str(tmp_path / 'classic.nc')
    f = netcdf_file(p, 'w')
    f.createDimension('time', None)
    f.createDimension('y', 4)
    f.createDimension('x', 5)
    f.createVariable('y', 'f8', ('y',))[:] = np.arange(4.0)
    f.createVariable('x', 'f8', ('x',))[:] = np.arange(5.0)
    t = f.createVariable('time', 'f8', ('time',))
    t[:] = np.array([0.0, 1.5])
    t.units = b'days since 2020-01-01'
    v = f.createVariable('temp', 'i2', ('time', 'y', 'x'))
    data = (np.arange(40) % 30).astype(np.int16).reshape(2, 4, 5)
    data[0, 0, 0] = -999
    v[:] = data
    v._FillValue = np.int16(-999)
    v.scale_factor = 0.5
    b = f.createVariable('flag', 'b', ('x',))
    b[:] = np.array([1, 0, 1, 1, 0], np.int8)
    f.history = b'classic writer'
    f.close()
    got = tio.open_netcdf(p, device='cpu')
    same_dataset(got, jio.open_netcdf(p))
    assert got['temp'].dtype == torch.float64


@pytest.mark.parametrize('unit', ['nanoseconds', 'microseconds',
                                  'milliseconds', 'seconds', 'minutes',
                                  'hours', 'days', 'weeks'])
@pytest.mark.parametrize('epoch', ['1970-01-01', '2001-02-03 04:05:06.789',
                                   '1858-11-17 00:00:00.0', '1970-1-1 0:0:0',
                                   '2015-06-30T12:00:00Z'])
def test_cf_time_decode_equals_pandas_to_the_nanosecond(unit, epoch):
    rng = np.random.RandomState(7)
    units = '%s since %s' % (unit, epoch)
    span = 1e3 if unit == 'weeks' else 1e4     # within datetime64[ns]
    for vals in (rng.randn(500) * span, rng.rand(500),
                 np.round(rng.randn(100) * 100, 3),
                 np.array([0.5, 1.25, np.nan, -0.1, 1 / 3, 2 / 3, 1e-9]),
                 rng.randint(-10 ** 4, 10 ** 4, 50),
                 (rng.randn(100) * 100).astype(np.float32),
                 rng.randint(0, 100, 10).astype(np.uint16), np.arange(5.0)):
        same_array(tnc._decode_cf_time(vals, units),
                   jnc._decode_cf_time(vals, units), units)


def test_cf_time_units_that_do_not_decode():
    for units in ('days since the launch', 'furlongs since 2000-01-01',
                  'kelvin'):
        assert tnc._decode_cf_time(np.arange(3), units) is None
        assert jnc._decode_cf_time(np.arange(3), units) is None


def test_add_time_reads_snap_dates():
    attrs = {'start_date': '02-DEC-2018 06:54:06.123456'}
    j = jio.add_time(JDataset(coords={'y': np.arange(3)}, attrs=attrs))
    t = tio.add_time(Dataset(coords={'y': np.arange(3)}, attrs=attrs,
                             device='cpu'))
    same_dataset(t, j)


def test_open_dataset_dispatch_and_unknown_extension(tmp_path):
    p = str(tmp_path / 'garbage.xyz')
    with open(p, 'w') as fh:
        fh.write('not a raster')
    with pytest.raises(IOError):
        tio.open_dataset(p, device='cpu')
    _, t = twins(_no_coord)
    pn = str(tmp_path / 'n.nc')
    tio.to_netcdf(t, pn)
    same_dataset(ndt.open_dataset(pn, device='cpu'),
                 tio.open_netcdf(pn, device='cpu'))


def test_open_netcdf_renames_lat_lon(tmp_path):
    rng = np.random.RandomState(0)
    j = JDataset({'v': (('lat', 'lon'), rng.rand(3, 4))},
                 coords={'lat': np.arange(3.0), 'lon': np.arange(4.0)})
    p = str(tmp_path / 'll.nc')
    jio.to_netcdf(j, p)
    for rename in (True, False):
        same_dataset(tio.open_netcdf(p, rename_latlon=rename, device='cpu'),
                     jio.open_netcdf(p, rename_latlon=rename))


def test_jp2_non_jpeg2000_raises_decoder_error(tmp_path):
    """A .jp2 that is no JPEG 2000 raises the decoder's own error, as in
    nd_tpu (open_dataset wraps it in an IOError)."""
    from nd_tpu.io.jp2 import Jp2Error as JErr
    from nd_tpu_torch.io.jp2 import Jp2Error
    p = str(tmp_path / 'b.jp2')
    with open(p, 'wb') as fh:
        fh.write(b'\0' * 16)
    with pytest.raises(Jp2Error, match='not a JP2 file') as got:
        tio.open_rasterio(p, device='cpu')
    with pytest.raises(JErr) as want:
        jio.open_rasterio(p)
    assert str(got.value) == str(want.value)
    with pytest.raises(IOError, match='not a JP2 file'):
        tio.open_dataset(p, device='cpu')


def test_open_rasterio_jp2_equals_nd_tpu(tmp_path):
    """open_rasterio opens a .jp2 (reversible, world file and .prj
    sidecars) equal to nd_tpu's, at full resolution and as an
    overview."""
    pil = pytest.importorskip('PIL.Image')
    rng = np.random.RandomState(7)
    a = rng.randint(0, 4096, (40, 52), dtype=np.uint16)
    p = str(tmp_path / 'scene.jp2')
    pil.fromarray(a).save(p, irreversible=False)
    with open(str(tmp_path / 'scene.j2w'), 'w') as fh:
        fh.write('10.0\n0.0\n0.0\n-10.0\n300005.0\n5500015.0\n')
    with open(str(tmp_path / 'scene.prj'), 'w') as fh:
        fh.write(ndt.CRS.from_epsg(32633).to_wkt())
    for level in (None, 0):
        got = tio.open_rasterio(p, overview_level=level, device='cpu')
        same_dataset(got, jio.open_rasterio(p, overview_level=level))
    np.testing.assert_array_equal(
        tio.open_rasterio(p, device='cpu').values[0], a)


BLOCKED = textwrap.dedent('''
    import sys
    for name in ('h5py', 'pandas', 'lxml', 'cv2', 'zstandard', 'PIL'):
        sys.modules[name] = None          # the card's machine has none
    import importlib, os, pkgutil
    import numpy as np
    import nd_tpu_torch as ndt
    from nd_tpu_torch import io as tio
    from nd_tpu_torch.core import Dataset
    from nd_tpu_torch.io import envi, netcdf
    for m in pkgutil.iter_modules(tio.__path__):
        importlib.import_module('nd_tpu_torch.io.' + m.name)
    out, dimap = sys.argv[1], sys.argv[2]
    rng = np.random.RandomState(0)
    times = np.datetime64('2023-01-03', 'ns') + np.arange(3) * \\
        np.timedelta64(12, 'D')
    c12 = (rng.rand(4, 5, 3) + 1j * rng.rand(4, 5, 3)).astype(np.complex64)
    ds = Dataset({'C11': (('y', 'x', 'time'),
                          rng.rand(4, 5, 3).astype(np.float32)),
                  'C12': (('y', 'x', 'time'), c12)},
                 coords={'y': 50 - np.arange(4.0), 'x': np.arange(5.0),
                         'time': times},
                 attrs={'crs': 'epsg:4326',
                        'transform': (1.0, 0.0, -0.5, 0.0, -1.0, 50.5)},
                 device='cpu')
    assert netcdf.writer() == 'netCDF classic (CDF-2)', netcdf.writer()
    p = os.path.join(out, 'stack.nc')
    ndt.to_netcdf(ds, p)
    with open(p, 'rb') as fh:
        assert fh.read(4) == b'CDF\\x02'
    back = ndt.open_dataset(p, as_complex=True, device='cpu')
    assert np.array_equal(back['C12'].values, c12)
    assert np.array_equal(back['time'].values, times)
    c11 = ds['C11'].values[..., 0]
    one = Dataset({'C11': (('y', 'x'), c11)}, coords={
        'y': ds['y'].values, 'x': ds['x'].values}, attrs=ds.attrs,
        device='cpu')
    tio.to_geotiff(one, os.path.join(out, 'a.tif'), compress='deflate')
    da = tio.open_rasterio(os.path.join(out, 'a.tif'), device='cpu')
    assert np.array_equal(da.values[0], c11)
    tio.to_zarr(ds, os.path.join(out, 's.zarr'))
    z = tio.open_zarr(os.path.join(out, 's.zarr'), device='cpu')
    assert np.array_equal(z['C12'].values, c12)
    cube = rng.rand(2, 4, 5).astype('>f4')
    cube.tofile(os.path.join(out, 'e.img'))
    with open(os.path.join(out, 'e.hdr'), 'w') as fh:
        fh.write('ENVI\\nsamples = 5\\nlines = 4\\nbands = 2\\n'
                 'data type = 4\\ninterleave = bsq\\nbyte order = 1\\n')
    assert np.array_equal(envi.read_envi(os.path.join(out, 'e.img')), cube)
    d = tio.open_beam_dimap(dimap, device='cpu')
    from nd_tpu_torch.tiling import auto_merge, map_over_tiles, tile
    lazy = ndt.open_dataset(p, chunks={}, device='cpu')
    assert lazy._variables['C11'].is_lazy
    assert np.array_equal(lazy.isel(y=slice(1, 3))['C11'].values,
                          ds['C11'].values[1:3])
    tiles = os.path.join(out, 'tiles')
    tile(p, tiles, chunks={'y': 2, 'x': 3}, buffer=1)
    assert len(os.listdir(tiles)) == 4
    merged = map_over_tiles(os.path.join(tiles, '*.nc'), lambda t: t * 2.0,
                            path=os.path.join(out, 'doubled'), device='cpu')
    assert np.array_equal(merged['C11'].values, ds['C11'].values * 2)
    again = auto_merge(os.path.join(out, 'doubled', '*.nc'), device='cpu')
    assert np.array_equal(again['C12__im'].values, c12.imag * 2)
    import json
    from nd_tpu_torch.io import open_sentinel2_granule
    from nd_tpu_torch.ops.rasterize import rasterize_values
    import nd_tpu_torch.vector as vector
    s2 = sys.argv[3]
    with open(os.path.join(s2, 'MANIFEST.json')) as fh:
        manifest = json.load(fh)
    g = open_sentinel2_granule(os.path.join(s2, manifest['granule']),
                               device='cpu')
    import hashlib
    for b in g.data_vars:
        assert hashlib.sha256(np.ascontiguousarray(g[b].values).tobytes()
                              ).hexdigest() == \
            manifest['bands'][b]['reduce']['0']['sha256'], b
    geoms, records, _ = vector.read_shapefile(
        os.path.join(s2, manifest['parcels']))
    labels = rasterize_values(
        [(geom, r['class']) for geom, r in zip(geoms, records)],
        g['x'].values, g['y'].values, device='cpu')
    assert labels.shape == (1098, 1098) and int(labels.max()) == 4
    print('ok', sorted(d.data_vars), str(d['time'].values[0]),
          sorted(g.data_vars), int((labels > 0).sum()))
''')


def test_io_runs_without_h5py_pandas_lxml_cv2_zstandard(tmp_path):
    """The card machine's modules: the I/O, the lazy opens and tiling,
    and (with PIL blocked too) the committed Sentinel-2 granule, the
    vector module's import, read_shapefile and rasterize_values."""
    from test_torch_dimap import write_dimap
    from torch_s2_fixture import OUT as s2
    dimap = write_dimap(tmp_path / 'product', tie_points=False)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + os.environ.get('PYTHONPATH', '').split(os.pathsep)))
    proc = subprocess.run([sys.executable, '-c', BLOCKED, str(tmp_path),
                           dimap, s2], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith('ok'), proc.stdout
    assert '2023-01-03T10:00:00' in proc.stdout
