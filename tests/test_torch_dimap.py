"""ENVI and BEAM-DIMAP parity of nd_tpu_torch.io with nd_tpu.io, exact.

The tests write their own products: ENVI ``.img``/``.hdr`` pairs in
every interleave and both byte orders, and small SNAP products (a
``.dim`` XML beside a ``.data`` directory of ENVI bands) with the dates
in SNAP's ``03-Jan-2023 10:00:00.000000`` form, geolocated either by an
affine image-to-model transform or by tie-point grids. The port parses
the XML with ElementTree, nd_tpu with lxml."""

import os

import numpy as np
import pytest

from nd_tpu.io import beam_dimap as jdimap
from nd_tpu.io import envi as jenvi
from nd_tpu_torch import io as tio
from nd_tpu_torch.io import envi as tenvi
from torch_io_helpers import same_array, same_dataset

WKT = ('GEOGCS["WGS84(DD)", DATUM["WGS84", SPHEROID["WGS84", 6378137.0, '
       '298.257223563]], PRIMEM["Greenwich", 0.0], UNIT["degree", '
       '0.017453292519943295], AXIS["Geodetic longitude", EAST], '
       'AXIS["Geodetic latitude", NORTH]]')
NY, NX = 6, 7


def write_envi(path, cube, interleave='bsq', byte_order=0, dtype_code=4,
               extra=''):
    """``cube`` (bands, lines, samples) as ``<path>.img`` + ``.hdr``."""
    bands, lines, samples = cube.shape
    order = {'bsq': (0, 1, 2), 'bil': (1, 0, 2), 'bip': (1, 2, 0)}
    dt = cube.dtype.newbyteorder('>' if byte_order else '<')
    np.ascontiguousarray(cube.transpose(order[interleave])).astype(dt) \
        .tofile(path + '.img')
    with open(path + '.hdr', 'w') as fh:
        fh.write('ENVI\ndescription = {Sentinel-1 band - Unit: intensity}\n'
                 'samples = %d\nlines = %d\nbands = %d\nheader offset = 0\n'
                 'file type = ENVI Standard\ndata type = %d\n'
                 'interleave = %s\nbyte order = %d\n%s'
                 % (samples, lines, bands, dtype_code, interleave,
                    byte_order, extra))
    return path + '.img'


def write_dimap(directory, tie_points=False, seed=0):
    """A small SNAP product; returns the path of its ``.dim``."""
    rng = np.random.RandomState(seed)
    directory = str(directory)
    data = os.path.join(directory, 'product.data')
    os.makedirs(os.path.join(data, 'tie_point_grids'), exist_ok=True)
    map_info = 'map info = {Geographic Lat/Lon, 1.0, 1.0, 12.0, 50.0, ' \
        '0.01, 0.01, WGS84, units=Degrees}\n'
    bands = {'Sigma0_VV': rng.rand(1, NY, NX).astype(np.float32),
             'C12_real': rng.rand(1, NY, NX).astype(np.float32),
             'C12_imag': rng.rand(1, NY, NX).astype(np.float32),
             'looks': rng.randint(0, 9, (2, NY, NX)).astype(np.int16)}
    for name, cube in bands.items():
        write_envi(os.path.join(data, name), cube, byte_order=1,
                   dtype_code=2 if cube.dtype == np.int16 else 4,
                   extra=map_info + 'coordinate system string = {%s}\n'
                   % WKT)
    grids = ''
    if tie_points:
        lat = 50 - np.linspace(0, 0.05, 12).reshape(3, 4).astype(np.float32)
        lon = 12 + np.linspace(0, 0.07, 12).reshape(3, 4).astype(np.float32)
        for name, g in (('latitude', lat), ('longitude', lon)):
            write_envi(os.path.join(data, 'tie_point_grids', name), g[None],
                       byte_order=1)
        grids = ''.join(
            '<Tie_Point_Grid_File><TIE_POINT_GRID_FILE_PATH '
            'href="product.data/tie_point_grids/%s.hdr"/>'
            '</Tie_Point_Grid_File>' % n for n in ('latitude', 'longitude'))
        geo = ''
    else:
        geo = ('<Coordinate_Reference_System><WKT>%s</WKT>'
               '</Coordinate_Reference_System><Geoposition>'
               '<IMAGE_TO_MODEL_TRANSFORM>-0.01,0.0,0.0,0.01,50.0,12.0'
               '</IMAGE_TO_MODEL_TRANSFORM></Geoposition>' % WKT)
    files = ''.join('<Data_File><DATA_FILE_PATH href="product.data/%s.hdr"/>'
                    '</Data_File>' % n for n in bands)
    md = ''.join('<MDATTR name="%s" type="%s">%s</MDATTR>' % a for a in (
        ('first_line_time', 'utc', '03-Jan-2023 10:00:00.000000'),
        ('PASS', 'ascii', 'ASCENDING'), ('ACQUISITION_MODE', 'ascii', 'IW'),
        ('REL_ORBIT', 'int32', '117'), ('ABS_ORBIT', 'int32', '46371'),
        ('first_near_lat', 'float64', '50.0'),
        ('first_far_lat', 'float64', '50.01'),
        ('last_near_lat', 'float64', '49.95'),
        ('last_far_lat', 'float64', '49.96'),
        ('first_near_long', 'float64', '12.0'),
        ('first_far_long', 'float64', '12.07'),
        ('last_near_long', 'float64', '12.01'),
        ('last_far_long', 'float64', '12.08')))
    xml = ('<?xml version="1.0" encoding="ISO-8859-1"?>\n<Dimap_Document '
           'name="product.dim"><Raster_Dimensions><NCOLS>%d</NCOLS>'
           '<NROWS>%d</NROWS><NBANDS>%d</NBANDS></Raster_Dimensions>'
           '<Data_Access>%s%s</Data_Access>%s<Dataset_Sources>'
           '<MDElem name="metadata"><MDElem name="Abstracted_Metadata">%s'
           '</MDElem></MDElem></Dataset_Sources></Dimap_Document>\n'
           % (NX, NY, len(bands), files, grids, geo, md))
    path = os.path.join(directory, 'product.dim')
    with open(path, 'w') as fh:
        fh.write(xml)
    return path


@pytest.mark.parametrize('interleave', ['bsq', 'bil', 'bip'])
@pytest.mark.parametrize('byte_order', [0, 1])
@pytest.mark.parametrize('dtype,code', [(np.uint8, 1), (np.int16, 2),
                                        (np.float32, 4), (np.float64, 5),
                                        (np.complex64, 6), (np.uint16, 12)])
def test_envi_reads_as_in_nd_tpu(tmp_path, interleave, byte_order, dtype,
                                 code):
    rng = np.random.RandomState(1)
    cube = (rng.rand(3, 4, 5) * 200).astype(dtype)
    p = write_envi(str(tmp_path / 'r'), cube, interleave, byte_order, code,
                   extra='band names = {a, b, c}\n')
    got = tenvi.EnviRaster(p)
    want = jenvi.EnviRaster(p)
    assert got.header == want.header and got.band_names == want.band_names
    same_array(got.read(), want.read())
    same_array(got.read(), cube)
    same_array(tenvi.read_envi(p, band=2), jenvi.read_envi(p, band=2))


def test_envi_map_info_transform(tmp_path):
    p = write_envi(str(tmp_path / 'g'), np.zeros((1, 2, 2), np.float32),
                   extra='map info = {UTM, 2.0, 3.0, 500000.0, 4000000.0, '
                   '10.0, 10.0, 33, North, WGS-84}\n')
    assert tuple(tenvi.EnviRaster(p).transform) == \
        tuple(jenvi.EnviRaster(p).transform)


@pytest.mark.parametrize('tie_points', [False, True])
@pytest.mark.parametrize('as_complex', [True, False])
def test_beam_dimap_reads_as_in_nd_tpu(tmp_path, tie_points, as_complex):
    p = write_dimap(tmp_path, tie_points=tie_points)
    got = tio.open_beam_dimap(p, as_complex=as_complex, device='cpu')
    same_dataset(got, jdimap.open_beam_dimap(p, as_complex=as_complex))
    assert str(got['time'].values[0]) == '2023-01-03T10:00:00.000000000'
    assert ('C12' in got.data_vars) == as_complex


def test_beam_dimap_metadata_only_and_dispatch(tmp_path):
    p = write_dimap(tmp_path)
    same_dataset(tio.open_beam_dimap(p, read_data=False, device='cpu'),
                 jdimap.open_beam_dimap(p, read_data=False))
    same_dataset(tio.open_dataset(p, device='cpu'),
                 jdimap.open_beam_dimap(p))
