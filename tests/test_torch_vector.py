"""nd_tpu_torch.vector against nd_tpu.vector on the CPU: the geometry
types, ``read_shapefile`` (the committed parcels and hand-written DBF
cases), ``read_file`` (Shapefile and GeoJSON, with ``clip``), ``to_file``,
``vector.rasterize`` (numeric, categorical with its legend and without
encoding, ``date_field``, ``crs=``, points and lines), ``warp.get_geometry``
and the polygon generators of ``testing``, each equal to nd_tpu's (masks
bit-equal)."""

import datetime
import json
import os
import struct

import numpy as np
import pytest

from nd_tpu import testing as JT
from nd_tpu import vector as JV
from nd_tpu import warp as JW
from nd_tpu.vector import geometry as JG
from nd_tpu.vector import shapefile as JS
from nd_tpu_torch import testing as TT
from nd_tpu_torch import vector as TV
from nd_tpu_torch import warp as TW
from nd_tpu_torch.vector import geometry as TG
from nd_tpu_torch.vector import shapefile as TS
import torch_s2_fixture as FX
from torch_io_helpers import same_dataset

PARCELS = os.path.join(FX.OUT, 'parcels.shp')


def same_geom(a, b):
    assert a.geom_type == b.geom_type
    assert a.bounds == b.bounds
    assert JG.mapping(a) == TG.mapping(b)


def same_table(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        if c == 'geometry':
            for a, b in zip(want[c], got[c]):
                same_geom(a, b)
        else:
            assert got[c].dtype == want[c].dtype, c
            np.testing.assert_array_equal(got[c].values, want[c].values)
    gc, wc = got.attrs.get('crs'), want.attrs.get('crs')
    assert (gc is None) == (wc is None)
    if wc is not None:
        assert gc.to_proj4() == wc.to_proj4()


def test_geometry_types_match():
    shell = [(0, 0), (4, 0), (4, 4), (0, 4)]
    hole = [(1, 1), (3, 1), (3, 3), (1, 3)]
    pairs = [(JG.box(0, 0, 2, 2), TG.box(0, 0, 2, 2)),
             (JG.Polygon(shell, [hole]), TG.Polygon(shell, [hole])),
             (JG.MultiPolygon([JG.box(0, 0, 1, 1), JG.box(2, 2, 3, 3)]),
              TG.MultiPolygon([TG.box(0, 0, 1, 1), TG.box(2, 2, 3, 3)])),
             (JG.Point(1.5, 2.5), TG.Point(1.5, 2.5)),
             (JG.LineString([(0, 0), (1, 1), (3, 0)]),
              TG.LineString([(0, 0), (1, 1), (3, 0)]))]
    move = lambda x, y: (np.asarray(x) * 2 + 1, np.asarray(y) - 3)  # noqa
    for a, b in pairs:
        same_geom(a, b)
        same_geom(JG.shape(JG.mapping(a)), TG.shape(TG.mapping(b)))
        if hasattr(a, 'area'):
            assert a.area == b.area
        for pt in ((0.5, 0.5), (2.0, 2.0), (1.5, 2.5), (9.0, 9.0)):
            assert a.contains(JG.Point(*pt)) == b.contains(TG.Point(*pt))
            assert a.intersects(JG.Point(*pt)) == \
                b.intersects(TG.Point(*pt))
        for other in ((1, 1, 3, 3), (5, 5, 6, 6), (0.2, 0.2, 0.4, 0.4)):
            assert a.intersects(JG.box(*other)) == \
                b.intersects(TG.box(*other))
        same_geom(JG.transform_geom(move, a), TG.transform_geom(move, b))
    assert pairs[1][1].centroid.x == pairs[1][0].centroid.x
    # edges that cross with no vertex inside either polygon
    cross = [(-1, 1), (5, 1), (5, 2), (-1, 2)]
    assert pairs[0][1].intersects(TG.Polygon(cross)) == \
        pairs[0][0].intersects(JG.Polygon(cross)) is True


def test_read_shapefile_parcels():
    """The committed parcels (holes and multipart polygons, written with
    struct by tests/torch_s2_fixture.py) read the same in both packages."""
    jg, jr, jc = JS.read_shapefile(PARCELS)
    tg, tr, tc = TS.read_shapefile(PARCELS)
    assert tr == jr and tc == jc == FX.PRJ
    assert len(tg) == len(jg) > 250
    for a, b in zip(jg, tg):
        same_geom(a, b)
    kinds = {g.geom_type for g in tg}
    assert kinds == {'Polygon', 'MultiPolygon'}
    assert any(g.interiors for g in tg if g.geom_type == 'Polygon')
    assert set(r['class'] for r in tr) == {1, 2, 3, 4}


def _dbf(path, fields, rows):
    """A DBF file by hand: ``fields`` (name, type, length, decimals),
    ``rows`` of raw field bytes, a leading ``*`` marks a deleted row."""
    rec_len = 1 + sum(f[2] for f in fields)
    hdr_len = 32 + 32 * len(fields) + 1
    out = [struct.pack('<BBBBIHH20x', 3, 124, 1, 1, len(rows), hdr_len,
                       rec_len)]
    for name, ftype, length, dec in fields:
        out.append(name.encode().ljust(11, b'\0') + ftype.encode()
                   + b'\0' * 4 + bytes([length, dec]) + b'\0' * 14)
    out.append(b'\x0d')
    out.extend(rows)
    out.append(b'\x1a')
    with open(path, 'wb') as fh:
        fh.write(b''.join(out))


def test_read_dbf_field_types(tmp_path):
    """Unset dates read as None, blank numbers as NaN, logicals, deleted
    rows as None: the same records in both packages."""
    p = str(tmp_path / 't.dbf')
    fields = [('DATE', 'D', 8, 0), ('N', 'N', 6, 0), ('F', 'N', 8, 2),
              ('L', 'L', 1, 0), ('S', 'C', 5, 0)]
    _dbf(p, fields, [
        b' 20200115    42    3.25Tabc  ',
        b'         ' + b' ' * 6 + b' ' * 8 + b'?     ',
        b'*20210101     1    1.00Fzz   ',
        b' 2020011x    -7   -0.50ndef  '])
    got, want = TS._read_dbf(p), JS._read_dbf(p)
    assert got[0] == want[0] == {'DATE': datetime.date(2020, 1, 15), 'N': 42,
                                 'F': 3.25, 'L': True, 'S': 'abc'}
    assert got[1]['DATE'] is None and np.isnan(got[1]['N'])
    assert got[2] is None and want[2] is None
    assert got[3]['DATE'] is None and got[3] == want[3]
    for a, b in zip(got, want):
        if a is not None:
            assert set(a) == set(b)


def test_read_file_shapefile_and_clip():
    want = JV.read_file(PARCELS)
    got = TV.read_file(PARCELS)
    same_table(got, want)
    proj4 = got.attrs['crs'].to_proj4()       # the .prj's ESRI WKT
    for term in ('+proj=tmerc', '+lon_0=15.0', '+k=0.9996', '+x_0=500000.0'):
        assert term in proj4, proj4
    clip = (FX.ULX + 2000, FX.ULY - 4000, FX.ULX + 5000, FX.ULY - 1000)
    want_c = JV.read_file(PARCELS, clip=JG.box(*clip))
    got_c = TV.read_file(PARCELS, clip=TG.box(*clip))
    same_table(got_c, want_c)
    assert 0 < len(got_c) < len(got)


def test_read_geojson_with_clip(tmp_path):
    gj = {'type': 'FeatureCollection', 'features': [
        {'type': 'Feature', 'properties': {'name': 'a', 'value': 1.5},
         'geometry': {'type': 'Polygon', 'coordinates': [
             [[0, 0], [2, 0], [2, 2], [0, 2], [0, 0]]]}},
        {'type': 'Feature', 'properties': {'name': 'b', 'value': 2.5},
         'geometry': {'type': 'Point', 'coordinates': [5, 5]}},
        {'type': 'Feature', 'properties': {'name': 'c', 'value': 0.5},
         'geometry': {'type': 'MultiPolygon', 'coordinates': [
             [[[6, 6], [7, 6], [7, 7], [6, 6]]],
             [[[8, 8], [9, 8], [9, 9], [8, 8]]]]}},
        {'type': 'Feature', 'properties': {'name': 'none'},
         'geometry': None}]}
    p = str(tmp_path / 'features.geojson')
    with open(p, 'w') as fh:
        json.dump(gj, fh)
    same_table(TV.read_file(p), JV.read_file(p))
    for clip in ((4, 4, 6, 6), (-1, -1, 1, 1), (20, 20, 30, 30)):
        same_table(TV.read_file(p, clip=TG.box(*clip)),
                   JV.read_file(p, clip=JG.box(*clip)))
    with pytest.raises(IOError, match='unsupported vector format'):
        TV.read_file(str(tmp_path / 'x.kml'))


def test_generators_draw_the_same():
    for seed in (0, 3):
        for a, b in zip(JT.generate_test_polygons(7, random_seed=seed),
                        TT.generate_test_polygons(7, random_seed=seed)):
            same_geom(a, b)
        same_geom(JT.random_polygon(2, 3, 1.5, n=9, random_seed=seed),
                  TT.random_polygon(2, 3, 1.5, n=9, random_seed=seed))
        same_table(TT.generate_test_geodataframe(n=9, random_seed=seed),
                   JT.generate_test_geodataframe(n=9, random_seed=seed))


def test_to_file_equals_nd_tpu(tmp_path):
    """GeoJSON written by both packages: the same document, reprojected
    to EPSG:4326 where the table carries another CRS."""
    import pandas as pd
    jdf = JT.generate_test_geodataframe(n=6, random_seed=4)
    tdf = TT.generate_test_geodataframe(n=6, random_seed=4)
    for df, mod, name in ((jdf, JV, 'j'), (tdf, TV, 't')):
        mod.to_file(df, str(tmp_path / (name + '.geojson')))
    docs = [json.load(open(str(tmp_path / (n + '.geojson'))))
            for n in 'jt']
    assert docs[0] == docs[1]
    same_table(TV.read_file(str(tmp_path / 't.geojson')),
               JV.read_file(str(tmp_path / 'j.geojson')))
    for mod, geom, name in ((JV, JG, 'jp'), (TV, TG, 'tp')):
        df = pd.DataFrame({'name': ['bern'], 'when': [pd.NaT],
                           'n': [np.int64(3)]})
        df['geometry'] = [geom.Point(2600000.0, 1200000.0)]
        mod.to_file(df, str(tmp_path / (name + '.geojson')),
                    crs='epsg:2056')
    jp, tp = [json.load(open(str(tmp_path / (n + '.geojson'))))
              for n in ('jp', 'tp')]
    assert jp == tp
    lon, lat = tp['features'][0]['geometry']['coordinates']
    assert abs(lon - 7.438632) < 1e-4 and abs(lat - 46.951083) < 1e-3


def _cubes(dims, seed=42, extent=(-10.0, 50.0, 0.0, 60.0)):
    j = JT.generate_test_dataset(dims=dims, random_seed=seed, extent=extent)
    t = TT.generate_test_dataset(dims=dims, random_seed=seed, extent=extent,
                                 device='cpu')
    return j, t


@pytest.mark.parametrize('kw', [
    {'columns': ['float']},
    {'columns': ['integer']},
    {'columns': ['category']},
    {'columns': ['category'], 'encode_labels': False},
    {'columns': ['integer', 'float'], 'date_field': 'date'},
    {'columns': ['integer'], 'date_field': 'date', 'date_fmt': '%Y-%m-%d'},
    {},
])
def test_rasterize_equals_nd_tpu(kw):
    j, t = _cubes({'y': 40, 'x': 44, 'time': 2})
    jdf = JT.generate_test_geodataframe(n=7, random_seed=2)
    tdf = TT.generate_test_geodataframe(n=7, random_seed=2)
    if 'date_fmt' in kw:
        for df in (jdf, tdf):
            df['date'] = df['date'].dt.strftime('%Y-%m-%d')
    want = JV.rasterize(jdf, j, **kw)
    got = TV.rasterize(tdf, t, **kw)
    if kw.get('encode_labels') is False:
        # the object layer: the same labels, held as a host array
        for name in want.data_vars:
            np.testing.assert_array_equal(
                np.asarray(got[name].values, dtype=object).astype(str),
                np.asarray(want[name].values, dtype=object).astype(str))
        return
    same_dataset(got, want)
    for name in got.data_vars:
        assert got[name].data.device.type == 'cpu'
        assert np.asarray(got[name].values).any()


def test_rasterize_reprojects_and_reads_files(tmp_path):
    """A table in EPSG:4326 burned on a UTM grid (``crs=`` and the
    table's own CRS), and a shapefile path burned on the fixture's grid
    (clipped to the grid on read)."""
    j, t = _cubes({'y': 30, 'x': 36, 'time': 1}, extent=(
        FX.ULX, FX.ULY - 3000.0, FX.ULX + 3600.0, FX.ULY))
    for ds in (j, t):
        ds.attrs['crs'] = '+proj=utm +zone=33 +datum=WGS84 +units=m +no_defs'
    lon_lat = (14.0, 49.6, 14.06, 49.63)
    jdf = JT.generate_test_geodataframe(n=5, extent=lon_lat, random_seed=8)
    tdf = TT.generate_test_geodataframe(n=5, extent=lon_lat, random_seed=8)
    jdf.attrs.pop('crs')
    tdf.attrs.pop('crs')
    same_dataset(TV.rasterize(tdf, t, columns=['integer'], crs='epsg:4326'),
                 JV.rasterize(jdf, j, columns=['integer'], crs='epsg:4326'))
    got = TV.rasterize(PARCELS, t, columns=['class'])
    same_dataset(got, JV.rasterize(PARCELS, j, columns=['class']))
    assert set(np.unique(got['class'].values)) > {0}


def test_rasterize_points_and_lines_through_vector():
    import pandas as pd
    j, t = _cubes({'y': 20, 'x': 20, 'time': 1})
    tabs = []
    for geom in (JG, TG):
        df = pd.DataFrame({'v': [3, 4, 5]})
        df['geometry'] = [geom.Point(-5.1, 55.2),
                          geom.LineString([(-9.0, 51.0), (-1.0, 59.0)]),
                          geom.box(-8.0, 52.0, -6.0, 54.0)]
        df.attrs['crs'] = None
        tabs.append(df)
    same_dataset(TV.rasterize(tabs[1], t), JV.rasterize(tabs[0], j))


@pytest.mark.parametrize('crs', [None, 'epsg:4326', 'epsg:3035',
                                 'epsg:32633'])
def test_get_geometry_equals_nd_tpu(crs):
    j, t = _cubes({'y': 12, 'x': 14, 'time': 1},
                  extent=(12.0, 48.0, 16.0, 52.0))
    kw = {} if crs is None else {'crs': crs}
    same_geom(JW.get_geometry(j, **kw), TW.get_geometry(t, **kw))
