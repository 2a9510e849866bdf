"""nd_tpu_torch's JPEG 2000 reader and Sentinel-2 granule reader against
nd_tpu's, on the CPU: every case of tests/test_jp2.py re-created with
Pillow's OpenJPEG, where the port's decode must be bit-equal to
nd_tpu's (and to OpenJPEG's where nd_tpu's is); the native Tier-1
decoder against the port's Python ``_T1Decoder`` on every code-block of
a multi-band file; a failed host build raises; and the committed
fixture (tests/data/torch_s2) decodes to its MANIFEST.json in both
packages."""

import json
import os
import struct

import numpy as np
import pytest

from nd_tpu.io import jp2 as JJ
from nd_tpu_torch.io import jp2 as TJ
import torch_s2_fixture as FX

PIL = pytest.importorskip('PIL.Image')
from PIL import features  # noqa: E402

pytestmark = pytest.mark.skipif(
    not features.check('jpg_2000'),
    reason='Pillow lacks OpenJPEG (the encoder of the test files)')


def _save(tmp_path, arr, name='t.jp2', irreversible=False, **kw):
    p = str(tmp_path / name)
    PIL.fromarray(arr).save(p, irreversible=irreversible, **kw)
    return p


def _both(p, reduce=0):
    """The port's decode, held bit-equal to nd_tpu's, with dtype."""
    got = TJ.decode_jp2(p, reduce=reduce)
    want = JJ.decode_jp2(p, reduce=reduce)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def _smooth(shape, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    return (128 + 80 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 6, shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize('shape,kw', [
    ((48, 64), {}),
    ((47, 61), {}),                          # odd extents
    ((129, 131), {'codeblock_size': (32, 32)}),
    ((100, 90), {'tile_size': (32, 32)}),    # multi-tile
    ((64, 64), {'quality_layers': [50, 20, 0]}),   # multi-layer
    ((33, 40), {'num_resolutions': 1}),      # no DWT
    ((33, 40), {'num_resolutions': 3}),
    ((64, 80), {'progression': 'RPCL', 'precinct_size': (32, 32)}),
    ((64, 80), {'progression': 'RLCP'}),
])
def test_gray_bit_exact(tmp_path, shape, kw):
    rng = np.random.RandomState(sum(shape) + len(kw))
    a = rng.randint(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(_both(_save(tmp_path, a, **kw)), a)


def test_rgb_rct_bit_exact(tmp_path):
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (40, 56, 3), dtype=np.uint8)
    np.testing.assert_array_equal(_both(_save(tmp_path, a)), a)


def test_uint16_bit_exact(tmp_path):
    rng = np.random.RandomState(4)
    a = rng.randint(0, 65536, (40, 48), dtype=np.uint16)
    np.testing.assert_array_equal(_both(_save(tmp_path, a)), a)


def test_structured_content(tmp_path):
    grad = (np.add.outer(np.arange(64), np.arange(80)) % 256) \
        .astype(np.uint8)
    np.testing.assert_array_equal(_both(_save(tmp_path, grad)), grad)
    const = np.full((33, 65), 77, np.uint8)
    np.testing.assert_array_equal(
        _both(_save(tmp_path, const, name='c.jp2')), const)


@pytest.mark.parametrize('seed,shape,kw', [
    (11, (96, 112), {}),
    (12, (95, 113), {}),                      # odd extents
    (13, (96, 112), {'tile_size': (32, 32)}),  # multi-tile
    (14, (96, 112), {'num_resolutions': 3}),
    (15, (96, 112), {'quality_layers': [60, 35]}),    # truncated
    (16, (96, 112), {'quality_mode': 'rates',
                     'quality_layers': [20]}),
])
def test_irreversible_97_equals_nd_tpu(tmp_path, seed, shape, kw):
    """The 9/7 profile: the same numpy arithmetic in both packages, so
    the port is bit-equal to nd_tpu (nd_tpu is held to OpenJPEG by
    PSNR in tests/test_jp2.py)."""
    a = _smooth(shape, seed=seed)
    _both(_save(tmp_path, a, irreversible=True, **kw))


def test_irreversible_97_rgb_ict(tmp_path):
    a = _smooth((96, 112), seed=2)
    rgb = np.stack([a, np.roll(a, 7, 0), 255 - a], axis=-1)
    out = _both(_save(tmp_path, rgb, irreversible=True))
    assert out.shape == rgb.shape


def test_raw_codestream(tmp_path):
    rng = np.random.RandomState(5)
    a = rng.randint(0, 256, (30, 34), dtype=np.uint8)
    np.testing.assert_array_equal(_both(_save(tmp_path, a, 't.j2k')), a)


def test_bytes_input_and_errors(tmp_path):
    a = np.arange(12 * 16, dtype=np.uint8).reshape(12, 16)
    with open(_save(tmp_path, a), 'rb') as fh:
        buf = fh.read()
    np.testing.assert_array_equal(TJ.decode_jp2(buf), a)
    for bad in (b'\0' * 16, buf[:4] + b'xxxx' + buf[8:]):
        with pytest.raises(TJ.Jp2Error) as got:
            TJ.decode_jp2(bad)
        with pytest.raises(JJ.Jp2Error) as want:
            JJ.decode_jp2(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match='t1='):
        TJ.decode_jp2(buf, t1='gpu')


def _wrap_geojp2(plain_jp2, geotiff_payload):
    """Splice a GeoJP2 uuid box (GeoTIFF payload) into a JP2 file,
    right before the codestream box."""
    with open(plain_jp2, 'rb') as fh:
        buf = fh.read()
    uuid = bytes([0xb1, 0x4b, 0xf8, 0xbd, 0x08, 0x3d, 0x4b, 0x43,
                  0xa5, 0xae, 0x8c, 0xd7, 0xd5, 0xa6, 0xce, 0x03])
    box = struct.pack('>I', 8 + 16 + len(geotiff_payload)) + b'uuid' \
        + uuid + geotiff_payload
    pos = 0
    while pos + 8 <= len(buf):
        (lbox,) = struct.unpack('>I', buf[pos:pos + 4])
        if buf[pos + 4:pos + 8] == b'jp2c':
            return buf[:pos] + box + buf[pos:]
        pos += lbox or len(buf) - pos
    raise AssertionError('no jp2c box')


def _same_raster(got, want):
    assert got.dims == want.dims
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    assert got.values.dtype == np.asarray(want.values).dtype
    for c in want.coords:
        np.testing.assert_array_equal(got[c].values,
                                      np.asarray(want[c].values))
    assert got.attrs == want.attrs


def test_geojp2_georeferencing(tmp_path):
    from nd_tpu.crs import CRS, Affine
    from nd_tpu.io import open_rasterio as jopen
    from nd_tpu.io.geotiff import write_geotiff
    from nd_tpu_torch.io import open_rasterio as topen

    rng = np.random.RandomState(6)
    a = rng.randint(0, 256, (24, 32), dtype=np.uint8)
    plain = _save(tmp_path, a, name='geo.jp2')
    gt = str(tmp_path / 'carrier.tif')
    write_geotiff(gt, np.zeros((1, 1, 1), np.uint8),
                  transform=Affine(10.0, 0.0, 600000.0, 0.0, -10.0,
                                   5900040.0), crs=CRS.from_epsg(32633))
    with open(gt, 'rb') as fh:
        payload = fh.read()
    out_path = str(tmp_path / 'withgeo.jp2')
    with open(out_path, 'wb') as fh:
        fh.write(_wrap_geojp2(plain, payload))
    got = topen(out_path, device='cpu')
    _same_raster(got, jopen(out_path))
    np.testing.assert_array_equal(got.values[0], a)
    assert got.attrs['transform'] == (10.0, 0.0, 600000.0, 0.0, -10.0,
                                      5900040.0)
    assert 'zone=33' in got.attrs['crs']
    assert float(got['x'].values[0]) == 600005.0
    # the overview scales the GeoJP2 transform
    _same_raster(topen(out_path, overview_level=0, device='cpu'),
                 jopen(out_path, overview_level=0))


@pytest.mark.parametrize('payload', [
    b'not a tiff at all',                   # no byte-order mark
    b'II*\0\x08',                           # IFD offset cut short
    b'II*\0\x08\0\0\0\x05\0',                 # IFD entries cut short
])
def test_geojp2_unreadable_box_falls_back_to_world_file(tmp_path, payload):
    """A GeoJP2 box whose GeoTIFF does not parse is ignored, as in
    nd_tpu: the world file and .prj georeference the raster."""
    from nd_tpu.crs import CRS
    from nd_tpu.io import open_rasterio as jopen
    from nd_tpu_torch.io import open_rasterio as topen

    rng = np.random.RandomState(9)
    a = rng.randint(0, 256, (24, 32), dtype=np.uint8)
    plain = _save(tmp_path, a, name='plain.jp2')
    out_path = str(tmp_path / 'badgeo.jp2')
    with open(out_path, 'wb') as fh:
        fh.write(_wrap_geojp2(plain, payload))
    with open(str(tmp_path / 'badgeo.j2w'), 'w') as fh:
        fh.write('10.0\n0.0\n0.0\n-10.0\n600005.0\n5900035.0\n')
    with open(str(tmp_path / 'badgeo.prj'), 'w') as fh:
        fh.write(CRS.from_epsg(32633).to_wkt())
    got = topen(out_path, device='cpu')
    _same_raster(got, jopen(out_path))
    np.testing.assert_array_equal(got.values[0], a)
    assert got.attrs['transform'] == (10.0, 0.0, 600000.0, 0.0, -10.0,
                                      5900040.0)
    assert '+lon_0=15.0' in got.attrs['crs']


def test_open_dataset_dispatches_jp2(tmp_path):
    from nd_tpu.io import open_dataset as jopen
    from nd_tpu_torch.io import open_dataset as topen
    rng = np.random.RandomState(8)
    a = rng.randint(0, 256, (16, 20), dtype=np.uint8)
    p = _save(tmp_path, a, name='d.jp2')
    _same_raster(topen(p, device='cpu'), jopen(p))
    # chunks= is ignored: JPEG 2000 has no windowed layout here
    _same_raster(topen(p, chunks={}, device='cpu'), jopen(p, chunks={}))


_MTD_TL = """<?xml version="1.0" encoding="UTF-8"?>
<n1:Level-1C_Tile_ID xmlns:n1="https://psd-14.sentinel2.eo.esa.int/\
PSD/S2_PDI_Level-1C_Tile_Metadata.xsd">
 <n1:Geometric_Info>
  <Tile_Geocoding metadataLevel="Brief">
   <HORIZONTAL_CS_NAME>WGS84 / UTM zone 33N</HORIZONTAL_CS_NAME>
   <HORIZONTAL_CS_CODE>EPSG:32633</HORIZONTAL_CS_CODE>
   <Size resolution="10"><NROWS>24</NROWS><NCOLS>32</NCOLS></Size>
   <Size resolution="20"><NROWS>12</NROWS><NCOLS>16</NCOLS></Size>
   <Geoposition resolution="10">
    <ULX>600000</ULX><ULY>5900040</ULY>
    <XDIM>10</XDIM><YDIM>-10</YDIM>
   </Geoposition>
   <Geoposition resolution="20">
    <ULX>600000</ULX><ULY>5900040</ULY>
    <XDIM>20</XDIM><YDIM>-20</YDIM>
   </Geoposition>
  </Tile_Geocoding>
 </n1:Geometric_Info>
</n1:Level-1C_Tile_ID>
"""


def _same_dataset(got, want):
    assert sorted(got.data_vars) == sorted(want.data_vars)
    for v in want.data_vars:
        assert got[v].dims == want[v].dims
        np.testing.assert_array_equal(got[v].values,
                                      np.asarray(want[v].values))
        assert got[v].values.dtype == np.asarray(want[v].values).dtype
    for c in ('x', 'y'):
        np.testing.assert_array_equal(got[c].values,
                                      np.asarray(want[c].values))
    assert got.attrs == want.attrs


def test_sentinel2_safe_granule(tmp_path):
    from nd_tpu.io import open_sentinel2_granule as jopen
    from nd_tpu_torch.io import open_sentinel2_granule as topen

    gdir = tmp_path / 'L1C_T33UUP_A012345_20250101T101049'
    (gdir / 'IMG_DATA').mkdir(parents=True)
    (gdir / 'MTD_TL.xml').write_text(_MTD_TL)
    rng = np.random.RandomState(9)
    bands10 = {}
    for b in ('B02', 'B03', 'B04'):
        bands10[b] = rng.randint(0, 4096, (24, 32), dtype=np.uint16)
        PIL.fromarray(bands10[b]).save(
            str(gdir / 'IMG_DATA' / ('T33UUP_20250101T101049_%s.jp2' % b)),
            irreversible=False)
    a20 = rng.randint(0, 4096, (12, 16), dtype=np.uint16)
    PIL.fromarray(a20).save(
        str(gdir / 'IMG_DATA' / 'T33UUP_20250101T101049_B11.jp2'),
        irreversible=False)
    for kw in ({}, {'resolution': 20}, {'overview_level': 0},
               {'bands': ['B03']}, {'resolution': 20, 'overview_level': 1}):
        got = topen(str(gdir), device='cpu', **kw)
        _same_dataset(got, jopen(str(gdir), **kw))
    ds = topen(str(gdir / 'MTD_TL.xml'), device='cpu')
    assert set(ds.data_vars) == {'B02', 'B03', 'B04'}
    for b, a in bands10.items():
        np.testing.assert_array_equal(ds[b].values, a)
    assert ds['x'].values[0] == 600005.0 and ds['y'].values[0] == 5900035.0
    with pytest.raises(ValueError, match='resolution 60'):
        topen(str(gdir), resolution=60, device='cpu')
    with pytest.raises(ValueError, match='not the 10 m grid'):
        topen(str(gdir), bands=['B11'], device='cpu')
    ov = topen(str(gdir), overview_level=0, device='cpu')
    assert ov['x'].values[0] == 600010.0 and ov.attrs['res'] == (20.0, 20.0)


def test_derived_quantization_deltas(tmp_path):
    """Sqcd style 1 (scalar derived) wiring: the same band steps and
    magnitude bits in both packages, and the literal Annex E formula."""
    a = _smooth((48, 48), seed=21)
    p = _save(tmp_path, a, name='l.jp2', irreversible=True,
              num_resolutions=4)
    buf = open(p, 'rb').read()
    tiles = []
    for J in (JJ, TJ):
        cs = J._parse_markers(buf[buf.find(b'\xff\x4f\xff\x51'):])
        cs.qcd = {'style': 1, 'guard': 2, 'exps': [12], 'mants': [1536]}
        cs.qcc = {}
        tiles.append(J._build_tile(cs, 0)[0])
    prec = 8
    gains = {'LL': 0, 'HL': 1, 'LH': 1, 'HH': 2}
    checked = 0
    for r, (jr, tr) in enumerate(zip(tiles[0]['comps'][0]['resolutions'],
                                     tiles[1]['comps'][0]['resolutions'])):
        eps_b = 12 - (r - 1 if r else 0)
        for jb, tb in zip(jr['bands'], tr['bands']):
            want = 2.0 ** (prec + gains[tb.otype] - eps_b) \
                * (1.0 + 1536 / 2048.0)
            assert tb.delta == jb.delta == want
            assert tb.mb == jb.mb == eps_b + 2 - 1
            checked += 1
    assert checked == 1 + 3 * 3


@pytest.mark.parametrize('reduce', [1, 2, 3])
def test_reduced_resolution_decode_bit_exact(tmp_path, reduce):
    a = _smooth((96, 112), seed=4)
    p = _save(tmp_path, a, name='r.jp2')
    img = PIL.open(p)
    img.reduce = reduce
    np.testing.assert_array_equal(_both(p, reduce), np.asarray(img))


def test_reduced_resolution_decode_lossy_and_tiled(tmp_path):
    a = _smooth((95, 113), seed=5)
    p = _save(tmp_path, a, name='r2.jp2', irreversible=True,
              tile_size=(32, 32))
    assert _both(p, 1).shape == (48, 57)
    for J in (TJ, JJ):
        with pytest.raises(ValueError, match='reduce'):
            J.decode_jp2(p, reduce=9)


def test_open_rasterio_jp2_overview_level(tmp_path):
    from nd_tpu.io import open_rasterio as jopen
    from nd_tpu_torch.io import open_rasterio as topen
    a = _smooth((64, 64), seed=6)
    p = _save(tmp_path, a, name='ov.jp2')
    with open(str(tmp_path / 'ov.j2w'), 'w') as fh:
        fh.write('10.0\n0.0\n0.0\n-10.0\n600005.0\n5900035.0\n')
    for level in (None, 0, 1):
        _same_raster(topen(p, overview_level=level, device='cpu'),
                     jopen(p, overview_level=level))
    half = topen(p, overview_level=0, device='cpu')
    assert half.shape == (1, 32, 32)
    assert float(half['x'].values[0]) == 600010.0


def test_native_t1_equals_python_on_every_codeblock(tmp_path):
    """The native Tier-1 decoder is bit-equal (vals and lastp) to the
    port's _T1Decoder on every code-block of a lossless RGB file and a
    truncated lossy one, and the two decodes of each file agree."""
    rng = np.random.RandomState(33)
    rgb = rng.randint(0, 256, (40, 72, 3), np.uint8)
    p1 = _save(tmp_path, rgb, name='n1.jp2', codeblock_size=(16, 16))
    b = _smooth((95, 77), seed=34)
    p2 = _save(tmp_path, np.stack([b, 255 - b, b // 2], -1), name='n2.jp2',
               irreversible=True, quality_layers=[50, 30])
    for p in (p1, p2):
        jobs = TJ.codeblock_jobs(p)
        assert len(jobs) > 20
        native = TJ._t1_decode_many(jobs, 'native')
        python = TJ._t1_decode_many(jobs, 'python')
        for (nv, nl), (pv, pl) in zip(native, python):
            assert nv.dtype == pv.dtype and nl.dtype == pl.dtype
            np.testing.assert_array_equal(nv, pv)
            np.testing.assert_array_equal(nl, pl)
        np.testing.assert_array_equal(TJ.decode_jp2(p, t1='python'),
                                      TJ.decode_jp2(p))


def test_codeblock_jobs_follow_reduce(tmp_path):
    a = _smooth((96, 112), seed=7)
    p = _save(tmp_path, a, name='cb.jp2', codeblock_size=(16, 16))
    counts = [len(TJ.codeblock_jobs(p, reduce=r)) for r in (0, 1, 2)]
    assert counts[0] > counts[1] > counts[2] > 0


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that fails, or none at all, raises from
    the build and from every native decode; nothing switches to the
    Python decoder."""
    from nd_tpu_torch import native
    a = np.arange(12 * 16, dtype=np.uint8).reshape(12, 16)
    p = _save(tmp_path, a)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, 'CXX', 'false')       # exits 1
    with pytest.raises(RuntimeError, match='host build of jp2_t1.cpp '
                                           'failed'):
        native.library()
    with pytest.raises(RuntimeError, match='host build'):
        TJ.decode_jp2(p)
    assert not [f for f in os.listdir(tmp_path / 'build')
                if not f.startswith('.')], 'a failed build left a file'
    monkeypatch.setattr(native, 'CXX', 'no-such-compiler-on-path')
    with pytest.raises(RuntimeError, match='not found'):
        TJ.decode_jp2(p)
    np.testing.assert_array_equal(TJ.decode_jp2(p, t1='python'), a)


def test_native_library_builds_into_the_package():
    from nd_tpu_torch import native
    info = native.build_info()
    path = info['path']
    assert os.path.dirname(path).endswith(os.path.join('nd_tpu_torch',
                                                       '.build'))
    assert os.path.basename(path).startswith('libnd_jp2_t1_')
    assert native.CXX_FLAGS == ('-O3', '-fopenmp', '-shared', '-fPIC',
                                '-std=c++17')


# ---- the committed fixture ------------------------------------------------

MANIFEST = os.path.join(FX.OUT, 'MANIFEST.json')


def _manifest():
    with open(MANIFEST) as fh:
        return json.load(fh)


@pytest.mark.parametrize('band', sorted(FX.BANDS))
def test_fixture_decodes_to_its_manifest(band):
    """Each band of tests/data/torch_s2 at reduce 0, 1 and 2, through both
    packages, against MANIFEST.json (and OpenJPEG for the reversible
    bands, where it decodes)."""
    entry = _manifest()['bands'][band]
    path = FX.band_path(band)
    assert os.path.getsize(path) == entry['bytes']
    for r, row in entry['reduce'].items():
        got = TJ.decode_jp2(path, reduce=int(r))
        assert list(got.shape) == row['shape']
        assert str(got.dtype) == row['dtype']
        assert FX.sha256(got) == row['sha256'], (band, r)
        assert FX.sha256(JJ.decode_jp2(path, reduce=int(r))) == \
            row['sha256'], (band, r)
        if entry['reversible']:
            ref = FX.openjpeg(path, int(r))
            if row['openjpeg_sha256'] is None:
                assert ref is None
            else:
                assert FX.sha256(ref) == row['openjpeg_sha256']


def test_fixture_bytes_stay_small():
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FX.OUT) for f in fs)
    assert total <= 4 * 2 ** 20, total


@pytest.mark.parametrize('kw', [
    {}, {'resolution': 20}, {'resolution': 60}, {'overview_level': 0},
    {'overview_level': 1}, {'resolution': 20, 'bands': ['B12']}])
def test_fixture_granule_equals_nd_tpu(kw):
    from nd_tpu.io import open_sentinel2_granule as jopen
    from nd_tpu_torch.io import open_sentinel2_granule as topen
    gdir = os.path.join(FX.OUT, FX.GRANULE)
    got = topen(gdir, device='cpu', **kw)
    _same_dataset(got, jopen(gdir, **kw))
    bands = _manifest()['bands']
    reduce = kw.get('overview_level', -1) + 1
    for b in got.data_vars:
        assert FX.sha256(got[b].values) == \
            bands[b]['reduce'][str(reduce)]['sha256']
    res = kw.get('resolution', 10) * 2 ** reduce
    assert got.attrs['res'] == (float(res), float(res))
    assert got['x'].values[0] == FX.ULX + res / 2
