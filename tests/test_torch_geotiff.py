"""GeoTIFF parity of nd_tpu_torch.io with nd_tpu.io, exact: the port's
files are byte-equal to nd_tpu's for the same data and options (every
codec this machine has, strips and tiles, overviews, geo-keys), each
package reads the other's files as its own, and the reader's breadth
(BigTIFF, big-endian, the float predictor, JPEG, world files and
``.prj``) matches nd_tpu's."""

import os
import struct
import zlib

import numpy as np
import pytest

from nd_tpu import io as jio
from nd_tpu.core import DataArray as JDataArray
from nd_tpu.core import Dataset as JDataset
from nd_tpu.io import geotiff as jgt
from nd_tpu_torch import io as tio
from nd_tpu_torch.core import DataArray, Dataset
from nd_tpu_torch.io import geotiff as tgt
from test_geotiff_breadth import _classic_tiff, _fp3_encode_rows
from torch_io_helpers import same_array, same_dataset, tree_bytes

CODECS = ['none', 'deflate', 'lzw', 'packbits', 'zstd']


def _have(module):
    try:
        __import__(module)
    except ImportError:
        return False
    return True


def _codec(codec):
    if codec == 'zstd' and not _have('zstandard'):
        pytest.skip('zstandard is not installed')
    return codec


@pytest.mark.parametrize('codec', CODECS)
@pytest.mark.parametrize('tiled', [False, True])
@pytest.mark.parametrize('dtype', [np.uint8, np.int16, np.uint16,
                                   np.float32, np.float64, np.complex64])
def test_write_geotiff_is_byte_equal(tmp_path, codec, tiled, dtype):
    rng = np.random.RandomState(0)
    data = rng.rand(2, 37, 45) * 200
    if dtype is np.complex64:
        data = data + 1j * rng.rand(2, 37, 45)
    data = data.astype(dtype)
    kw = dict(compress=_codec(codec), tiled=tiled, tile_size=16,
              crs='epsg:32633', nodata=0,
              overviews=[2] if np.dtype(dtype).kind != 'c' else None)
    pt, pj = str(tmp_path / 't.tif'), str(tmp_path / 'j.tif')
    tgt.write_geotiff(pt, data, transform=_affine(True), **kw)
    jgt.write_geotiff(pj, data, transform=_affine(False), **kw)
    assert tree_bytes(pt) == tree_bytes(pj)
    with tgt.TiffFile(pt) as t, jgt.TiffFile(pj) as j:
        same_array(t.read(), j.read())
        same_array(t.read(), data)
        assert t.overviews == j.overviews
        for level in range(len(j.overviews)):
            same_array(t.read_overview(level), j.read_overview(level))
        assert tuple(t.transform) == tuple(j.transform)
        assert t.crs.to_proj4() == j.crs.to_proj4() and t.nodata == j.nodata


def _affine(port):
    from nd_tpu.crs import Affine as JAffine
    from nd_tpu_torch.crs import Affine
    return (Affine if port else JAffine)(10.0, 0.0, 5e5, 0.0, -10.0, 4e6)


def _geo_pair(seed=0, nt=3):
    rng = np.random.RandomState(seed)
    ny, nx = 20, 24
    vals = {v: rng.rand(ny, nx, nt).astype(np.float32) for v in
            ('C11', 'C22')}
    coords = {'y': 4e6 - 10 * (np.arange(ny) + 0.5),
              'x': 5e5 + 10 * (np.arange(nx) + 0.5)}
    attrs = {'crs': '+proj=utm +zone=33 +datum=WGS84 +units=m +no_defs'}
    spec = {k: (('y', 'x', 'band'), v) for k, v in vals.items()}
    return (JDataset(spec, coords=coords, attrs=attrs),
            Dataset(spec, coords=coords, attrs=attrs, device='cpu'))


@pytest.mark.parametrize('codec', CODECS)
@pytest.mark.parametrize('layout', ['strips', 'tiles_overviews'])
def test_to_geotiff_is_byte_equal_and_reads_back(tmp_path, codec, layout):
    j, t = _geo_pair()
    kw = dict(compress=_codec(codec), tiled=layout != 'strips',
              tile_size=16, overviews=None if layout == 'strips' else True)
    pt, pj = str(tmp_path / 't.tif'), str(tmp_path / 'j.tif')
    assert tio.to_geotiff(t, pt, **kw) == pt
    jio.to_geotiff(j, pj, **kw)
    assert tree_bytes(pt) == tree_bytes(pj)
    got = tio.open_rasterio(pt, device='cpu')
    same_dataset(got, jio.open_rasterio(pj))
    same_dataset(got, jio.open_rasterio(pt))
    assert got.shape == (6, 20, 24)
    same_array(got.data[1], t['C11'].data[..., 1])
    if layout != 'strips':
        same_dataset(tio.open_rasterio(pt, overview_level=0, device='cpu'),
                     jio.open_rasterio(pj, overview_level=0))


def test_to_geotiff_of_a_dataarray_with_nodata(tmp_path):
    j, t = _geo_pair(nt=1)
    pt, pj = str(tmp_path / 't.tif'), str(tmp_path / 'j.tif')
    tio.to_geotiff(t['C11'].isel(band=0), pt, nodata=0.0)
    jio.to_geotiff(j['C11'].isel(band=0), pj, nodata=0.0)
    assert tree_bytes(pt) == tree_bytes(pj)
    got = tio.open_rasterio(pt, device='cpu')
    same_dataset(got, jio.open_rasterio(pj))
    assert got.attrs['nodatavals'] == (0.0,)


def test_rewrite_of_a_read_raster_is_byte_equal(tmp_path):
    rng = np.random.RandomState(2)
    data = rng.randint(0, 4000, (2, 30, 40)).astype(np.int16)
    src = str(tmp_path / 'src.tif')
    jgt.write_geotiff(src, data, transform=_affine(False), crs='epsg:4326')
    pt, pj = str(tmp_path / 't.tif'), str(tmp_path / 'j.tif')
    tio.to_geotiff(tio.open_rasterio(src, device='cpu'), pt)
    jio.to_geotiff(jio.open_rasterio(src), pj)
    assert tree_bytes(pt) == tree_bytes(pj)


def _write(path, data):
    with open(path, 'wb') as fh:
        fh.write(data)
    return path


def _bigtiff(path):
    img = np.arange(30, dtype=np.uint16).reshape(5, 6)
    raw = img.astype('<u2').tobytes()
    header = b'II' + struct.pack('<HHHQ', 43, 8, 0, 16)
    fields = [(256, 3, [6]), (257, 3, [5]), (258, 3, [16]), (259, 3, [1]),
              (262, 3, [1]), (277, 3, [1]), (278, 4, [5]),
              (279, 4, [len(raw)]), (339, 3, [1])]
    n = len(fields) + 1
    fields.append((273, 16, [16 + 8 + 20 * n + 8]))
    body = struct.pack('<Q', n)
    for tag, typ, vals in sorted(fields):
        packed = struct.pack('<' + {3: 'H', 4: 'I', 16: 'Q'}[typ]
                             * len(vals), *vals)
        body += struct.pack('<HHQ', tag, typ, len(vals))
        body += packed + b'\0' * (8 - len(packed))
    body += struct.pack('<Q', 0)
    return _write(path, header + body + raw)


def _predictor3(path):
    img = (np.random.RandomState(3).rand(7, 9).astype(np.float32) * 100 - 50)
    payload = zlib.compress(_fp3_encode_rows(img))
    return _write(path, _classic_tiff(
        [(256, 4, [9]), (257, 4, [7]), (258, 3, [32]), (259, 3, [8]),
         (262, 3, [1]), (273, 4, [0]), (277, 3, [1]), (278, 4, [7]),
         (279, 4, [len(payload)]), (317, 3, [3]), (339, 3, [3])], [payload]))


def _big_endian(path):
    """A big-endian ('MM') strip TIFF of int16 and a horizontal
    predictor over Deflate."""
    img = np.random.RandomState(4).randint(-500, 500, (6, 8)).astype('>i2')
    diff = img.astype(np.int64)
    diff[:, 1:] = np.diff(diff, axis=1)
    payload = zlib.compress(diff.astype('>i2').tobytes())
    entries = [(256, 3, 8), (257, 3, 6), (258, 3, 16), (259, 3, 8),
               (262, 3, 1), (273, 4, 0), (277, 3, 1), (278, 3, 6),
               (279, 4, len(payload)), (317, 3, 2), (339, 3, 2)]
    ifd_size = 2 + 12 * len(entries) + 4
    data_off = 8 + ifd_size
    out = b'MM\0*' + struct.pack('>I', 8) + struct.pack('>H', len(entries))
    for tag, typ, val in entries:
        val = data_off if tag == 273 else val
        packed = struct.pack('>H', val) + b'\0\0' if typ == 3 \
            else struct.pack('>I', val)
        out += struct.pack('>HHI', tag, typ, 1) + packed
    return _write(path, out + struct.pack('>I', 0) + payload)


def _jpeg(path):
    cv2 = pytest.importorskip('cv2')
    from scipy.ndimage import gaussian_filter
    img = gaussian_filter(np.random.RandomState(1).rand(32, 48) * 255,
                          4).astype(np.uint8)
    payload = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1] \
        .tobytes()
    return _write(path, _classic_tiff(
        [(256, 4, [48]), (257, 4, [32]), (258, 3, [8]), (259, 3, [7]),
         (262, 3, [1]), (273, 4, [0]), (277, 3, [1]), (278, 4, [32]),
         (279, 4, [len(payload)]), (339, 3, [1])], [payload]))


FOREIGN = {'bigtiff': _bigtiff, 'predictor3': _predictor3,
           'big_endian': _big_endian, 'jpeg': _jpeg}


@pytest.mark.parametrize('name', sorted(FOREIGN))
def test_foreign_tiffs_read_as_in_nd_tpu(tmp_path, name):
    p = FOREIGN[name](str(tmp_path / (name + '.tif')))
    with tgt.TiffFile(p) as t, jgt.TiffFile(p) as j:
        same_array(t.read(), j.read())
        assert t.bigtiff == j.bigtiff and t.bo == j.bo
    same_dataset(tio.open_rasterio(p, device='cpu'), jio.open_rasterio(p))


def test_big_endian_values(tmp_path):
    p = _big_endian(str(tmp_path / 'be.tif'))
    got = tio.open_rasterio(p, device='cpu')
    img = np.random.RandomState(4).randint(-500, 500, (6, 8))
    same_array(got.data[0], img.astype(np.int16))


def test_windowed_reads_match_nd_tpu(tmp_path):
    rng = np.random.RandomState(5)
    data = rng.rand(3, 70, 50).astype(np.float32)
    p = str(tmp_path / 'w.tif')
    tgt.write_geotiff(p, data, tiled=True, tile_size=16, compress='lzw')
    with tgt.TiffFile(p) as t, jgt.TiffFile(p) as j:
        for window in ([0, 2], 3, 41, 5, 37), ([1], 0, 70, 0, 50):
            same_array(t.read_window(*window), j.read_window(*window))


def test_png_with_world_file_and_prj(tmp_path):
    cv2 = pytest.importorskip('cv2')
    from nd_tpu_torch.crs import CRS
    img = np.random.RandomState(0).randint(0, 255, (20, 30), np.uint8)
    p = str(tmp_path / 'img.png')
    cv2.imwrite(p, img)
    with open(str(tmp_path / 'img.pgw'), 'w') as fh:
        fh.write('10\n0\n0\n-10\n105\n495\n')
    with open(str(tmp_path / 'img.prj'), 'w') as fh:
        fh.write(CRS.from_epsg(32633).to_wkt())
    got = tio.open_rasterio(p, device='cpu')
    same_dataset(got, jio.open_rasterio(p))
    same_array(got.data[0], img)


def test_rgb_bmp_and_wld_fallback(tmp_path):
    cv2 = pytest.importorskip('cv2')
    rgb = np.random.RandomState(1).randint(0, 255, (4, 5, 3), np.uint8)
    p = str(tmp_path / 'pic.bmp')
    cv2.imwrite(p, rgb[:, :, ::-1])
    same_dataset(tio.open_rasterio(p, device='cpu'), jio.open_rasterio(p))
    with open(str(tmp_path / 'pic.wld'), 'w') as fh:
        fh.write('2\n0\n0\n-2\n1\n11\n')
    got = tio.open_rasterio(p, device='cpu')
    same_dataset(got, jio.open_rasterio(p))
    assert got.attrs['transform'] == (2.0, 0.0, 0.0, 0.0, -2.0, 12.0)
    with pytest.raises(ValueError):
        tio.open_rasterio(p, overview_level=0)


def test_rotated_world_file_gives_2d_coords(tmp_path):
    cv2 = pytest.importorskip('cv2')
    p = str(tmp_path / 'r.png')
    cv2.imwrite(p, np.arange(12, dtype=np.uint8).reshape(3, 4))
    with open(str(tmp_path / 'r.pgw'), 'w') as fh:
        fh.write('2\n0.5\n0.25\n-2\n100\n200\n')
    got = tio.open_rasterio(p, device='cpu')
    same_dataset(got, jio.open_rasterio(p))
    assert got._coords['xc'].dims == ('y', 'x')


@pytest.mark.parametrize('codec', ['lzw', 'packbits'])
def test_codecs_equal_nd_tpu_on_long_runs(codec):
    """The LZW and PackBits encoders (code-width changes, table resets,
    long runs) emit nd_tpu's bytes and decode them back."""
    rng = np.random.RandomState(6)
    raw = bytes(np.concatenate([rng.randint(0, 255, 9000), np.zeros(700),
                                np.arange(5000) % 7]).astype(np.uint8))
    if codec == 'lzw':
        enc = tgt._lzw_encode(raw)
        assert enc == jgt._lzw_encode(raw)
        assert tgt._lzw_decode(enc) == raw
    else:
        enc = tgt._packbits_encode(raw, 1000)
        assert enc == jgt._packbits_encode(raw, 1000)
        assert tgt._packbits_decode(enc) == raw


def test_dataarray_input_keeps_band_order(tmp_path):
    rng = np.random.RandomState(7)
    vals = rng.rand(2, 5, 6).astype(np.float32)
    coords = {'band': np.array([1, 2]), 'y': np.arange(5.0) + 0.5,
              'x': np.arange(6.0) + 0.5}
    j = JDataArray(vals, dims=('band', 'y', 'x'), coords=coords)
    t = DataArray(vals, dims=('band', 'y', 'x'), coords=coords,
                  device='cpu')
    pt, pj = str(tmp_path / 't.tif'), str(tmp_path / 'j.tif')
    tio.to_geotiff(t, pt)
    jio.to_geotiff(j, pj)
    assert tree_bytes(pt) == tree_bytes(pj)
    assert os.path.getsize(pt) > 0
