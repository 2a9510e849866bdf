"""nd_tpu_torch.crs against nd_tpu.crs: the port keeps its own numpy copy
of the CRS layer (importing any module of nd_tpu imports JAX), so every
result must be identical, NaN for NaN: max abs difference 0.

Covered: ``transform_coords`` forward and inverse over every projection
family and datum path the JAX package's CRS tests exercise (EPSG codes,
ESRI codes and proj strings), ``CRS`` parsing and serialisation,
``Affine``, the Vincenty geodesics and an NTv2 grid shift.
"""

import numpy as np
import pytest

from nd_tpu import crs as jcrs
from nd_tpu.crs import ntv2 as jntv2
from nd_tpu_torch import crs as tcrs
from nd_tpu_torch.crs import ntv2 as tntv2
from test_ntv2 import _build_gsb

# (CRS, lon/lat box it is used over): one or more per projection family
FAMILIES = [
    ('epsg:3395', (-170.0, 170.0, -80.0, 80.0)),              # merc
    ('epsg:3857', (-170.0, 170.0, -80.0, 80.0)),              # webmerc
    ('ESRI:102100', (-170.0, 170.0, -80.0, 80.0)),            # webmerc
    ('epsg:27700', (-8.0, 2.0, 50.0, 59.0)),                  # tmerc, OSGB36
    ('epsg:32633', (12.0, 18.0, 40.0, 60.0)),                 # utm
    ('epsg:3413', (-180.0, 180.0, 60.0, 89.0)),               # polar stere
    ('+proj=stere +lat_0=52 +lon_0=5 +k=0.9999 +ellps=WGS84',
     (0.0, 10.0, 48.0, 56.0)),                                # oblique stere
    ('epsg:28992', (3.0, 7.5, 50.5, 53.7)),                   # sterea
    ('epsg:3035', (-10.0, 33.0, 35.0, 70.0)),                 # laea oblique
    ('epsg:6931', (-179.0, 179.0, 35.0, 89.0)),               # laea polar
    ('epsg:5070', (-125.0, -65.0, 20.0, 55.0)),               # aea
    ('epsg:3577', (115.0, 150.0, -45.0, -8.0)),               # aea south
    ('epsg:2154', (-5.0, 10.0, 41.0, 52.0)),                  # lcc 2SP
    ('epsg:27572', (-5.0, 8.0, 42.0, 51.0)),                  # lcc, NTF
    ('epsg:31370', (2.5, 6.4, 49.5, 51.5)),                   # lcc, BD72
    ('+proj=lcc +lat_0=40 +lon_0=-100 +k_0=0.99 +ellps=WGS84',
     (-120.0, -80.0, 25.0, 55.0)),                            # lcc 1SP
    ('epsg:6933', (-179.0, 179.0, -85.0, 85.0)),              # cea
    ('epsg:54009', (-170.0, 170.0, -85.0, 85.0)),             # moll
    ('epsg:2056', (5.9, 10.5, 45.8, 47.8)),                   # somerc
    ('epsg:21781', (5.9, 10.5, 45.8, 47.8)),                  # somerc LV03
    ('+proj=geos +h=35785831 +lon_0=0 +sweep=y +ellps=WGS84',
     (-55.0, 55.0, -55.0, 55.0)),                             # geos
    ('+proj=ortho +lat_0=40 +lon_0=-100 +ellps=WGS84',
     (-140.0, -60.0, 5.0, 75.0)),                             # ortho
    ('+proj=aeqd +lat_0=48 +lon_0=12 +ellps=WGS84',
     (-60.0, 84.0, -40.0, 80.0)),                             # aeqd
    ('epsg:29873', (109.0, 120.0, 0.5, 7.5)),                 # omerc
    ('epsg:26931', (-141.0, -130.0, 54.0, 60.0)),             # omerc AK
    ('epsg:5514', (12.0, 19.0, 48.0, 51.0)),                  # krovak
    ('epsg:8857', (-179.0, 179.0, -85.0, 85.0)),              # eqearth
    ('ESRI:54030', (-179.0, 179.0, -85.0, 85.0)),             # robin
    ('+proj=sinu +lon_0=0 +ellps=WGS84', (-179.0, 179.0, -85.0, 85.0)),
    ('+proj=eqc +lat_ts=0 +lon_0=0 +ellps=WGS84',
     (-179.0, 179.0, -85.0, 85.0)),                           # eqc
    ('epsg:26917', (-84.0, -78.0, 40.0, 50.0)),               # NAD83 UTM
    ('epsg:26717', (-84.0, -78.0, 40.0, 50.0)),               # NAD27 UTM
    ('epsg:23032', (6.0, 12.0, 40.0, 55.0)),                  # ED50 UTM
    ('epsg:29902', (-10.5, -6.0, 51.5, 55.5)),                # Irish grid
    ('epsg:4269', (-120.0, -70.0, 25.0, 50.0)),               # NAD83 geog
]


def _grid(box, n=23, m=19):
    lo0, lo1, la0, la1 = box
    lon, lat = np.meshgrid(np.linspace(lo0, lo1, n),
                           np.linspace(la0, la1, m))
    return lon, lat


@pytest.mark.parametrize('code,box', FAMILIES, ids=[c for c, _ in FAMILIES])
def test_transform_coords_is_identical(code, box):
    lon, lat = _grid(box)
    jx, jy = jcrs.transform_coords('epsg:4326', code, lon, lat, xp=np)
    tx, ty = tcrs.transform_coords('epsg:4326', code, lon, lat, xp=np)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    assert np.isfinite(tx).any()
    # and the inverse, from the forward's output
    jlo, jla = jcrs.transform_coords(code, 'epsg:4326', jx, jy, xp=np)
    tlo, tla = tcrs.transform_coords(code, 'epsg:4326', jx, jy, xp=np)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(tla, jla)


@pytest.mark.parametrize('code', [c for c, _ in FAMILIES])
def test_crs_parses_and_serialises_alike(code):
    j = jcrs.CRS.from_user_input(code)
    t = tcrs.CRS.from_user_input(code)
    assert t.proj == j.proj
    assert t.to_proj4() == j.to_proj4()
    assert t.to_wkt() == j.to_wkt()
    assert t.to_epsg() == j.to_epsg()
    assert tcrs.CRS.from_wkt(t.to_wkt()) == t
    assert tcrs.CRS.from_proj4(t.to_proj4()) == t


def test_projected_to_projected_is_identical():
    lon, lat = _grid((-8.0, 2.0, 50.0, 58.0))
    x, y = jcrs.transform_coords('epsg:4326', 'epsg:27700', lon, lat)
    j = jcrs.transform_coords('epsg:27700', 'epsg:3035', x, y, xp=np)
    t = tcrs.transform_coords('epsg:27700', 'epsg:3035', x, y, xp=np)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])


def test_affine_is_identical():
    rng = np.random.RandomState(3)
    coefs = rng.uniform(-3, 3, 6)
    ja, ta = jcrs.Affine(*coefs), tcrs.Affine(*coefs)
    assert tuple(ta) == tuple(ja)
    cols, rows = rng.uniform(0, 100, (2, 50))
    for jt, tt in ((ja, ta), (~ja, ~ta), (ja * ~ja, ta * ~ta),
                   (jcrs.Affine.rotation(30.0) * jcrs.Affine.scale(2, 3),
                    tcrs.Affine.rotation(30.0) * tcrs.Affine.scale(2, 3)),
                   (jcrs.Affine.translation(5, -7),
                    tcrs.Affine.translation(5, -7))):
        assert tuple(tt) == tuple(jt)
        np.testing.assert_array_equal(tt * (cols, rows), jt * (cols, rows))
    assert ta.to_gdal() == ja.to_gdal()
    assert tcrs.Affine.from_gdal(*ja.to_gdal()) == ta
    assert ta.determinant == ja.determinant


@pytest.mark.parametrize('ellps', ['WGS84', 'GRS80', 'bessel'])
def test_geodesics_are_identical(ellps):
    rng = np.random.RandomState(4)
    lon1, lon2 = rng.uniform(-180, 180, (2, 200))
    lat1, lat2 = rng.uniform(-80, 80, (2, 200))
    je, te = jcrs.ELLIPSOIDS[ellps], tcrs.ELLIPSOIDS[ellps]
    j = jcrs.geodesic_inverse(lon1, lat1, lon2, lat2, je)
    t = tcrs.geodesic_inverse(lon1, lat1, lon2, lat2, te)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    azi, s = rng.uniform(0, 360, 200), rng.uniform(0, 5e6, 200)
    j = jcrs.geodesic_direct(lon1, lat1, azi, s, je)
    t = tcrs.geodesic_direct(lon1, lat1, azi, s, te)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_ntv2_grid_shift_is_identical(tmp_path):
    path = tmp_path / 'synthetic.gsb'
    path.write_bytes(_build_gsb('<'))
    lon, lat = _grid((-9.5, -0.5, 40.5, 49.5), 17, 13)   # inside the grid
    jf, tf = jntv2.read_gsb(str(path)), tntv2.read_gsb(str(path))
    for a, b in zip(tf.forward(lon, lat), jf.forward(lon, lat)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(tf.forward(lon, lat)[0], lon)   # shifted
    for a, b in zip(tf.inverse(lon, lat), jf.inverse(lon, lat)):
        np.testing.assert_array_equal(a, b)
    src = '+proj=longlat +ellps=clrk66 +nadgrids=%s +no_defs' % path
    j = jcrs.transform_coords(src, 'epsg:4326', lon, lat, xp=np)
    t = tcrs.transform_coords(src, 'epsg:4326', lon, lat, xp=np)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
