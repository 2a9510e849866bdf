"""Coordinate reference systems, from scratch (no PROJ database).

The port's own copy of ``nd_tpu/crs/crs.py`` (numpy only: importing
any module of ``nd_tpu`` imports JAX). A compact CRS model that parses
pyproj/rasterio CRS, proj strings, dicts, WKT and EPSG ints. A CRS is:
ellipsoid + datum shift + projection id + projection parameters.
"""

from __future__ import annotations

import math
import re

import numpy as np

from .proj import (ELLIPSOIDS, DATUM_TO_WGS84, Ellipsoid, project_forward,
                   project_inverse, geodetic_to_geocentric,
                   geocentric_to_geodetic, helmert_transform)

__all__ = ['CRS', 'transform_coords']


_WKT_GCS_NAMES = {
    4326: 'WGS 84',
    4277: 'OSGB 1936',
}


_GENERATED = None


def _generated_registry():
    """The data-driven EPSG table (``epsg_registry.json.gz``, built by
    ``tools/gen_epsg_registry.py`` from the PROJ/EPSG dataset): every
    projected + geographic-2D code whose method, datum path and axes
    the engine implements (~4.7k codes — State Plane zones, national
    grids, the UTM-on-datum long tail). The curated ``_EPSG`` table
    keeps priority for the codes it defines."""
    global _GENERATED
    if _GENERATED is None:
        import gzip
        import json
        import os
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'epsg_registry.json.gz')
        try:
            with gzip.open(path, 'rb') as f:
                raw = json.load(f)
            table = {}
            for k, v in raw.items():
                if 'towgs84' in v:
                    v = dict(v)
                    v['towgs84'] = tuple(v['towgs84'])
                table[int(k)] = v
            _GENERATED = table
        except Exception:   # registry file absent: curated-only mode
            _GENERATED = {}
    return _GENERATED


def _utm_params(zone, south=False, ellps='WGS84', datum=None):
    p = {'proj': 'utm', 'zone': zone, 'lon_0': zone * 6 - 183,
         'k': 0.9996, 'x_0': 500000.0, 'y_0': 10000000.0 if south else 0.0,
         'ellps': ellps, 'units': 'm'}
    if datum is not None:
        p['datum'] = datum
    if south:
        p['south'] = True
    return p


_EPSG = {
    4326: {'proj': 'longlat', 'ellps': 'WGS84', 'datum': 'WGS84'},
    4269: {'proj': 'longlat', 'ellps': 'GRS80', 'datum': 'NAD83'},
    4277: {'proj': 'longlat', 'ellps': 'airy', 'datum': 'OSGB36'},
    3395: {'proj': 'merc', 'lon_0': 0, 'k': 1, 'x_0': 0, 'y_0': 0,
           'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    3857: {'proj': 'webmerc', 'lon_0': 0, 'x_0': 0, 'y_0': 0,
           'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    27700: {'proj': 'tmerc', 'lat_0': 49, 'lon_0': -2, 'k': 0.9996012717,
            'x_0': 400000, 'y_0': -100000, 'ellps': 'airy',
            'datum': 'OSGB36', 'units': 'm'},
    # polar stereographic grids (NSIDC Arctic / Antarctic)
    3413: {'proj': 'stere', 'lat_0': 90, 'lat_ts': 70, 'lon_0': -45,
           'x_0': 0, 'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84',
           'units': 'm'},
    3031: {'proj': 'stere', 'lat_0': -90, 'lat_ts': -71, 'lon_0': 0,
           'x_0': 0, 'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84',
           'units': 'm'},
    # equal-area / conformal-conic EO grids
    3035: {'proj': 'laea', 'lat_0': 52, 'lon_0': 10, 'x_0': 4321000,
           'y_0': 3210000, 'ellps': 'GRS80', 'units': 'm'},
    5070: {'proj': 'aea', 'lat_0': 23, 'lon_0': -96, 'lat_1': 29.5,
           'lat_2': 45.5, 'x_0': 0, 'y_0': 0, 'ellps': 'GRS80',
           'datum': 'NAD83', 'units': 'm'},
    2154: {'proj': 'lcc', 'lat_0': 46.5, 'lon_0': 3, 'lat_1': 49,
           'lat_2': 44, 'x_0': 700000, 'y_0': 6600000,
           'ellps': 'GRS80', 'units': 'm'},
    3034: {'proj': 'lcc', 'lat_0': 52, 'lon_0': 10, 'lat_1': 35,
           'lat_2': 65, 'x_0': 4000000, 'y_0': 2800000,
           'ellps': 'GRS80', 'units': 'm'},
    3577: {'proj': 'aea', 'lat_0': 0, 'lon_0': 132, 'lat_1': -18,
           'lat_2': -36, 'x_0': 0, 'y_0': 0, 'ellps': 'GRS80',
           'units': 'm'},
    # EASE-Grid 2.0 (NSIDC): global cylindrical + polar azimuthal
    6933: {'proj': 'cea', 'lat_ts': 30, 'lon_0': 0, 'x_0': 0,
           'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    6931: {'proj': 'laea', 'lat_0': 90, 'lon_0': 0, 'x_0': 0,
           'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    6932: {'proj': 'laea', 'lat_0': -90, 'lon_0': 0, 'x_0': 0,
           'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    3573: {'proj': 'laea', 'lat_0': 90, 'lon_0': -100, 'x_0': 0,
           'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    # World Mollweide (ESRI:54009 — commonly requested by that number)
    54009: {'proj': 'moll', 'lon_0': 0, 'x_0': 0, 'y_0': 0,
            'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    # Swiss national grids (Swiss oblique Mercator on Bessel 1841)
    2056: {'proj': 'somerc', 'lat_0': 46.95240555555556,
           'lon_0': 7.439583333333333, 'k_0': 1, 'x_0': 2600000,
           'y_0': 1200000, 'ellps': 'bessel',
           'towgs84': (674.374, 15.056, 405.346, 0.0, 0.0, 0.0, 0.0),
           'units': 'm'},
    21781: {'proj': 'somerc', 'lat_0': 46.95240555555556,
            'lon_0': 7.439583333333333, 'k_0': 1, 'x_0': 600000,
            'y_0': 200000, 'ellps': 'bessel',
            'towgs84': (674.374, 15.056, 405.346, 0.0, 0.0, 0.0, 0.0),
            'units': 'm'},
    # World Azimuthal Equidistant (ESRI:54032)
    54032: {'proj': 'aeqd', 'lat_0': 0, 'lon_0': 0, 'x_0': 0,
            'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84',
            'units': 'm'},
    # S-JTSK / Krovak East North (Czechia + Slovakia national grid)
    5514: {'proj': 'krovak', 'lat_0': 49.5,
           'lon_0': 24.833333333333332, 'alpha': 30.288139722222223,
           'k': 0.9999, 'x_0': 0, 'y_0': 0, 'ellps': 'bessel',
           'towgs84': (589.0, 76.0, 480.0, 0.0, 0.0, 0.0, 0.0),
           'units': 'm'},
    # WGS 84 / Equal Earth Greenwich
    8857: {'proj': 'eqearth', 'lon_0': 0, 'x_0': 0, 'y_0': 0,
           'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    # Timbalai 1948 / RSO Borneo (m) — Hotine oblique Mercator
    # variant B (the EPSG Guidance Note worked example)
    29873: {'proj': 'omerc', 'lat_0': 4.0, 'lonc': 115.0,
            'alpha': 53.31582047222222, 'gamma': 53.13010236111111,
            'k': 0.99984, 'x_0': 590476.87, 'y_0': 442857.65,
            'ellps': 'evrstSS',
            'towgs84': (-679.0, 669.0, -48.0, 0.0, 0.0, 0.0, 0.0),
            'units': 'm'},
    # NAD83 / Alaska zone 1 (Hotine oblique Mercator variant B)
    26931: {'proj': 'omerc', 'lat_0': 57.0,
            'lonc': -133.66666666666666, 'alpha': 323.1301023611111,
            'gamma': 323.1301023611111, 'k': 0.9999, 'x_0': 5000000,
            'y_0': -5000000, 'ellps': 'GRS80', 'datum': 'NAD83',
            'units': 'm'},
    # GDM2000 / Peninsular RSO (variant A: no_uoff)
    3375: {'proj': 'omerc', 'lat_0': 4.0, 'lonc': 102.25,
           'alpha': 323.0257964666666, 'gamma': 323.1301023611111,
           'k': 0.99984, 'x_0': 804671.0, 'y_0': 0.0,
           'ellps': 'GRS80', 'no_uoff': True, 'units': 'm'},
    # ETRS89 geographic + UTM zones (the standard European grids used
    # by Sentinel-2 tiles and national mapping)
    4258: {'proj': 'longlat', 'ellps': 'GRS80', 'datum': 'ETRS89'},
    # Amersfoort / RD New (Dutch national grid): oblique stereographic
    # via the conformal sphere (EPSG method 9809, +proj=sterea)
    28992: {'proj': 'sterea', 'lat_0': 52.15616055555555,
            'lon_0': 5.38763888888889, 'k': 0.9999079,
            'x_0': 155000.0, 'y_0': 463000.0, 'ellps': 'bessel',
            'towgs84': (565.417, 50.3319, 465.552, -0.398957,
                        0.343988, -1.8774, 4.0725),
            'units': 'm'},
    # BD72 / Belgian Lambert 72 (conic apex at the pole; note the
    # centimetre-level false origin offsets in the official definition)
    31370: {'proj': 'lcc', 'lat_0': 90.0, 'lon_0': 4.367486666666666,
            'lat_1': 51.16666723333333, 'lat_2': 49.8333339,
            'x_0': 150000.013, 'y_0': 5400088.438, 'ellps': 'intl',
            'towgs84': (-106.8686, 52.2978, -103.7239, 0.3366,
                        -0.457, 1.8422, -1.2747),
            'units': 'm'},
    # TM65 / Irish Grid (modified Airy ellipsoid)
    29902: {'proj': 'tmerc', 'lat_0': 53.5, 'lon_0': -8.0,
            'k': 1.000035, 'x_0': 200000.0, 'y_0': 250000.0,
            'ellps': 'mod_airy',
            'towgs84': (482.5, -130.6, 564.6, -1.042, -0.214,
                        -0.631, 8.15),
            'units': 'm'},
    # NTF (Paris) / Lambert zone II (one-parallel LCC). The official
    # axis is lon_0 = 0 east of the Paris meridian; the Paris offset
    # (2 deg 20' 14.025" = 2.337229166666667 deg) is folded into a
    # Greenwich lon_0 so every coordinate in the pipeline stays
    # Greenwich-referenced (the projection grid is identical).
    27572: {'proj': 'lcc', 'lat_0': 46.8, 'lat_1': 46.8,
            'k_0': 0.99987742, 'lon_0': 2.337229166666667,
            'x_0': 600000.0, 'y_0': 2200000.0, 'ellps': 'clrk80ign',
            'towgs84': (-168.0, -60.0, 320.0, 0.0, 0.0, 0.0, 0.0),
            'units': 'm'},
}

# ESRI authority codes (the "World_*" 54xxx family on WGS 84). A few
# of these are ALSO reachable by their bare number through _EPSG below
# (common user shorthand); the authoritative spelling is 'ESRI:NNNNN'.
_ESRI = {
    54002: {'proj': 'eqc', 'lat_ts': 0, 'lat_0': 0, 'lon_0': 0,
            'x_0': 0, 'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84',
            'units': 'm'},
    54004: {'proj': 'merc', 'lon_0': 0, 'k': 1, 'x_0': 0, 'y_0': 0,
            'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    54008: {'proj': 'sinu', 'lon_0': 0, 'x_0': 0, 'y_0': 0,
            'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    54009: {'proj': 'moll', 'lon_0': 0, 'x_0': 0, 'y_0': 0,
            'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    54030: {'proj': 'robin', 'lon_0': 0, 'x_0': 0, 'y_0': 0,
            'ellps': 'WGS84', 'datum': 'WGS84', 'units': 'm'},
    54032: {'proj': 'aeqd', 'lat_0': 0, 'lon_0': 0, 'x_0': 0,
            'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84',
            'units': 'm'},
    54034: {'proj': 'cea', 'lat_ts': 0, 'lon_0': 0, 'x_0': 0,
            'y_0': 0, 'ellps': 'WGS84', 'datum': 'WGS84',
            'units': 'm'},
}
# the legacy ArcGIS Online / Google web-Mercator aliases
_ESRI[102100] = dict(_EPSG[3857])
_ESRI[102113] = dict(_EPSG[3857])
# bare-number shorthand for the ESRI codes users most often request
# by number alone
_EPSG[54030] = _ESRI[54030]
_EPSG[102100] = _ESRI[102100]
_EPSG[102113] = _ESRI[102113]
for _zone in range(28, 39):
    # ETRS89 / UTM (Sentinel-2 tile grids, European national mapping)
    _EPSG[25800 + _zone] = _utm_params(_zone, ellps='GRS80',
                                       datum='ETRS89')
    # ED50 / UTM (legacy European charts, North Sea oil & gas)
    _EPSG[23000 + _zone] = _utm_params(_zone, ellps='intl',
                                       datum='ED50')
for _zone in range(1, 61):
    _EPSG[32600 + _zone] = _utm_params(_zone, south=False)
    _EPSG[32700 + _zone] = _utm_params(_zone, south=True)
for _zone in range(1, 24):
    # NAD83 / UTM zones 1N-23N (the default grids for US Landsat/NAIP)
    _EPSG[26900 + _zone] = _utm_params(_zone, ellps='GRS80',
                                       datum='NAD83')
for _zone in range(1, 23):
    # NAD27 / UTM zones 1N-22N (Clarke 1866; CONUS-average datum
    # shift — see DATUM_TO_WGS84['NAD27'])
    _EPSG[26700 + _zone] = _utm_params(_zone, ellps='clrk66',
                                       datum='NAD27')

_PROJECTION_WKT_NAMES = {
    'stere': 'Polar_Stereographic',
    'tmerc': 'Transverse_Mercator',
    'utm': 'Transverse_Mercator',
    'merc': 'Mercator_1SP',
    'webmerc': 'Popular_Visualisation_Pseudo_Mercator',
    'sinu': 'Sinusoidal',
    'eqc': 'Equirectangular',
    'lcc': 'Lambert_Conformal_Conic_2SP',
    'aea': 'Albers_Conic_Equal_Area',
    'laea': 'Lambert_Azimuthal_Equal_Area',
    'cea': 'Cylindrical_Equal_Area',
    'moll': 'Mollweide',
    'geos': 'Geostationary_Satellite',
    'somerc': 'Hotine_Oblique_Mercator_Azimuth_Center',
    'ortho': 'Orthographic',
    'aeqd': 'Azimuthal_Equidistant',
    'omerc': 'Hotine_Oblique_Mercator',
    'krovak': 'Krovak',
    'eqearth': 'Equal_Earth',
    'sterea': 'Oblique_Stereographic',
    'robin': 'Robinson',
}

_WKT_NAME_TO_PROJ = {
    'polar_stereographic': 'stere',
    'stereographic': 'stere',
    'transverse_mercator': 'tmerc',
    'mercator_1sp': 'merc',
    'mercator_2sp': 'merc',
    'mercator': 'merc',
    'sinusoidal': 'sinu',
    'equirectangular': 'eqc',
    'mercator_auxiliary_sphere': 'webmerc',
    'popular visualisation pseudo mercator': 'webmerc',
    'popular_visualisation_pseudo_mercator': 'webmerc',
    'pseudo-mercator': 'webmerc',
    # conformal conic (WKT1 *_1SP/_2SP; WKT2 "(1SP)"/"(2SP)" suffixes
    # arrive with the parens intact after name normalization)
    'lambert_conformal_conic_2sp': 'lcc',
    'lambert_conformal_conic_1sp': 'lcc',
    'lambert_conformal_conic': 'lcc',
    'lambert_conic_conformal_(2sp)': 'lcc',
    'lambert_conic_conformal_(1sp)': 'lcc',
    'lambert_conic_conformal': 'lcc',
    # equal-area families
    'albers_conic_equal_area': 'aea',
    'albers_equal_area': 'aea',
    'albers': 'aea',
    'lambert_azimuthal_equal_area': 'laea',
    'lambert_azimuthal_equal_area_(spherical)': 'laea',
    'cylindrical_equal_area': 'cea',
    'lambert_cylindrical_equal_area': 'cea',
    'lambert_cylindrical_equal_area_(spherical)': 'cea',
    'mollweide': 'moll',
    # geostationary view (GDAL WKT1 / WKT2 sweep-suffixed method names)
    'geostationary_satellite': 'geos',
    'geostationary_satellite_(sweep_x)': 'geos',
    'geostationary_satellite_(sweep_y)': 'geos',
    # Swiss oblique Mercator: GDAL writes the Hotine azimuth-center
    # method name with azimuth 90 for +proj=somerc
    'hotine_oblique_mercator_azimuth_center': 'somerc',
    'swiss_oblique_cylindrical': 'somerc',
    'swiss_oblique_mercator': 'somerc',
    'orthographic': 'ortho',
    'azimuthal_equidistant': 'aeqd',
    'modified_azimuthal_equidistant': 'aeqd',
    # Hotine oblique Mercator: plain name = EPSG variant A (false
    # grid at the natural origin, +no_uoff); the azimuth-center name
    # is variant B — resolved to somerc only in the Swiss azimuth-90
    # convention (see from_wkt)
    'hotine_oblique_mercator': 'omerc',
    'oblique_mercator': 'omerc',
    'rectified_skew_orthomorphic': 'omerc',
    'krovak': 'krovak',
    'krovak_(north_orientated)': 'krovak',
    'equal_earth': 'eqearth',
    # EPSG 9809 double stereographic (conformal sphere) vs the Snyder
    # conformal-latitude aspect: distinct projections, like PROJ's
    # sterea/stere split
    'oblique_stereographic': 'sterea',
    'double_stereographic': 'sterea',
    'roussilhe': 'sterea',
    'robinson': 'robin',
}

# projections whose WKT standard_parallel_1/2 mean the conic
# parallels +lat_1/+lat_2 (everything else maps SP1 to +lat_ts)
_CONIC_PROJS = ('lcc', 'aea')

_NUMERIC_KEYS = ('lat_0', 'lon_0', 'lat_1', 'lat_2', 'lat_ts', 'k', 'k_0',
                 'x_0', 'y_0', 'zone', 'a', 'b', 'rf', 'h', 'to_meter',
                 'alpha', 'gamma', 'lonc')

# proj4 +units= names -> meters per unit
_UNIT_TO_METER = {
    'm': 1.0, 'meter': 1.0, 'metre': 1.0, 'km': 1000.0,
    'ft': 0.3048, 'us-ft': 1200.0 / 3937.0, 'mi': 1609.344,
    'us-mi': 6336000.0 / 3937.0, 'yd': 0.9144, 'cm': 0.01,
    'mm': 0.001,
}


def _lookup_ellps(name):
    """Named-ellipsoid lookup with a proper error (not a KeyError)."""
    try:
        return ELLIPSOIDS[name]
    except KeyError:
        raise ValueError(
            'unknown ellipsoid %r; supported: %s (or pass +a/+b/+rf)'
            % (name, ', '.join(sorted(ELLIPSOIDS))))


class CRS:
    """A coordinate reference system.

    Construct with a parameter dict (proj4-style keys) or use the
    ``from_*`` classmethods. Instances are immutable and hashable.
    """

    def __init__(self, params=None, epsg=None):
        if isinstance(params, CRS):
            self._params = dict(params._params)
            self._epsg = params._epsg
            return
        if isinstance(params, str):
            other = CRS.from_string(params)
            self._params = other._params
            self._epsg = other._epsg
            return
        params = dict(params or {})
        if 'init' in params:
            init = params.pop('init')
            m = re.match(r'(?i)epsg:(\d+)', init.strip())
            if not m:
                raise ValueError('unsupported init: %r' % init)
            other = CRS.from_epsg(int(m.group(1)))
            merged = dict(other._params)
            merged.update(params)
            self._params = merged
            # overrides that CHANGE the definition void the code —
            # to_epsg()/AUTHORITY must not claim a CRS this is not
            changed = any(other._params.get(k) != v
                          for k, v in params.items())
            self._epsg = None if changed else other._epsg
            if self._epsg is None:
                self._epsg = self._match_epsg()
            return
        self._params = params
        self._epsg = epsg
        if epsg is None:
            self._epsg = self._match_epsg()

    _EPSG_CANONICAL = None   # lazily-built {canonical: code} lookup

    def _match_epsg(self):
        # canonicalizing all ~190 registry entries per construction
        # was the hot path of every CRS parse; build the reverse
        # lookup once
        if CRS._EPSG_CANONICAL is None:
            table = {}
            for code, p in _EPSG.items():
                table.setdefault(CRS._canonical_params(p), code)
            CRS._EPSG_CANONICAL = table
        return CRS._EPSG_CANONICAL.get(self._canonical())

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_epsg(cls, code):
        code = int(code)
        if code not in _EPSG:
            gen = _generated_registry().get(code)
            if gen is None:
                raise ValueError(
                    'EPSG:%d is neither in the curated registry nor '
                    'in the generated EPSG table (%d codes); its '
                    'projection method, datum path or axes are '
                    'outside the engine' % (code,
                                            len(_generated_registry())))
            return cls(dict(gen), epsg=code)
        return cls(dict(_EPSG[code]), epsg=code)

    @classmethod
    def from_authority(cls, authority, code):
        """Look up ``authority:code`` — 'EPSG' or 'ESRI'."""
        auth = str(authority).strip().upper()
        code = int(code)
        if auth == 'EPSG':
            return cls.from_epsg(code)
        if auth == 'ESRI':
            params = _ESRI.get(code) or _EPSG.get(code)
            if params is None:
                raise ValueError(
                    'ESRI:%d is not in the built-in registry' % code)
            return cls(dict(params))
        raise ValueError('unknown CRS authority %r' % authority)

    @classmethod
    def from_dict(cls, d):
        return cls(d)

    @classmethod
    def from_string(cls, s):
        s = s.strip()
        m = re.match(r'(?i)^(?:\+init=)?(epsg|esri):(\d+)$', s)
        if m:
            return cls.from_authority(m.group(1), int(m.group(2)))
        if s.upper().startswith(('PROJCS', 'GEOGCS', 'PROJCRS', 'GEOGCRS')):
            return cls.from_wkt(s)
        if s.startswith('+') or '=' in s:
            return cls.from_proj4(s)
        raise ValueError('cannot parse CRS from %r' % s)

    @classmethod
    def from_user_input(cls, value):
        if isinstance(value, CRS):
            return value
        if isinstance(value, (int, np.integer)):
            return cls.from_epsg(int(value))
        if isinstance(value, dict):
            return cls.from_dict(value)
        if isinstance(value, str):
            return cls.from_string(value)
        # duck-typing: pyproj/rasterio-like objects
        for attr in ('to_wkt', 'wkt'):
            if hasattr(value, attr):
                wkt = getattr(value, attr)
                wkt = wkt() if callable(wkt) else wkt
                return cls.from_wkt(wkt)
        raise ValueError('cannot interpret CRS from %r' % (value,))

    @classmethod
    def from_proj4(cls, s):
        params = {}
        for tok in s.split():
            tok = tok.lstrip('+')
            if not tok:
                continue
            if '=' in tok:
                k, v = tok.split('=', 1)
                if k in _NUMERIC_KEYS:
                    v = float(v)
                    if k == 'zone':
                        v = int(v)
                elif ',' in v:
                    # list-valued parameters (e.g. +towgs84=dx,dy,dz,...)
                    try:
                        v = tuple(float(x) for x in v.split(','))
                        if k == 'towgs84':
                            # 3-parameter form pads to the 7-parameter
                            # Helmert (rotations 0, scale 0) — also
                            # keeps proj4-vs-WKT equality canonical
                            v = v + (0.0,) * (7 - len(v)) if len(v) < 7 \
                                else v
                    except ValueError:
                        pass
                params[k] = v
            else:
                params[tok] = True
        units = params.get('units')
        if units and 'to_meter' not in params:
            factor = _UNIT_TO_METER.get(str(units).lower())
            if factor is None:
                raise ValueError('unknown +units=%s (pass +to_meter '
                                 'explicitly)' % units)
            if factor != 1.0:
                params['to_meter'] = factor
        if 'init' in params:
            return cls({'init': params.pop('init'), **params})
        if params.get('proj') == 'utm' and 'zone' in params:
            zone = int(params['zone'])
            base = _utm_params(zone, south=bool(params.get('south')))
            base.update({k: v for k, v in params.items()
                         if k not in ('proj', 'zone', 'south')})
            return cls(base)
        return cls(params)

    @classmethod
    def from_wkt(cls, wkt):
        """Parse WKT1 (PROJCS/GEOGCS) or WKT2 (PROJCRS/GEOGCRS) text."""
        def _find_all(pattern):
            return re.findall(pattern, wkt, flags=re.IGNORECASE)

        params = {}
        proj_m = _find_all(r'PROJECTION\[\"([^\"]+)\"')
        if not proj_m:
            # WKT2 spells the projection as CONVERSION > METHOD["..."]
            proj_m = _find_all(r'METHOD\[\"([^\"]+)\"')
        spheroid = _find_all(
            r'SPHEROID\[\"([^\"]+)\",\s*([0-9.eE+-]+),\s*([0-9.eE+-]+)')
        if not spheroid:
            spheroid = _find_all(
                r'ELLIPSOID\[\"([^\"]+)\",\s*([0-9.eE+-]+),'
                r'\s*([0-9.eE+-]+)')
        towgs = _find_all(r'TOWGS84\[([^\]]+)\]')
        # the CRS's own EPSG code is the AUTHORITY/ID node attached to
        # the ROOT element (bracket depth 1) — inner nodes carry codes
        # for units (9001), datums, axes, ...
        authority = []
        for m in re.finditer(
                r'(?:AUTHORITY|ID)\[\"EPSG\",\s*\"?(\d+)\"?\]', wkt,
                flags=re.IGNORECASE):
            head = wkt[:m.start()]
            if head.count('[') - head.count(']') == 1:
                authority.append(m.group(1))

        if spheroid:
            name, a, rf = spheroid[0]
            a, rf = float(a), float(rf)
            ell = None
            for key, e in ELLIPSOIDS.items():
                if abs(e.a - a) < 0.5 and (
                        (rf == 0 and e.f == 0)
                        or (rf != 0 and e.f != 0
                            and abs(1 / e.f - rf) < 1e-6)):
                    ell = key
                    break
            if ell is not None:
                params['ellps'] = ell
            else:
                params['a'] = a
                if rf:
                    params['rf'] = rf
        gcs_names = _find_all(r'(?:GEOGCS|GEOGCRS|BASEGEOGCRS)'
                              r'\[\"([^\"]+)\"')
        if gcs_names:
            n = gcs_names[0].lower().replace(' ', '')
            if 'osgb' in n:
                params['datum'] = 'OSGB36'
            elif 'wgs' in n and '84' in n:
                params['datum'] = 'WGS84'
            elif 'nad83' in n:
                params['datum'] = 'NAD83'
        if towgs:
            vals = [float(v) for v in towgs[0].split(',')]
            while len(vals) < 7:
                vals.append(0.0)
            params['towgs84'] = tuple(vals)

        if proj_m:
            # normalize WKT1 ("Transverse_Mercator") and WKT2
            # ("Transverse Mercator", "Polar Stereographic (variant B)")
            # method names to one lookup form
            pname = re.sub(r'\s*\(variant [a-c]\)', '',
                           proj_m[0].strip().lower()).replace(' ', '_')
            proj = _WKT_NAME_TO_PROJ.get(pname)
            if proj is None:
                raise NotImplementedError(
                    'WKT projection %r is not supported' % proj_m[0])
            params['proj'] = proj
            # value may be followed by ANGLEUNIT/LENGTHUNIT/ID in WKT2,
            # so don't require an immediate closing bracket
            sp1_key = 'lat_1' if proj in _CONIC_PROJS else 'lat_ts'
            for pk, pv in _find_all(
                    r'PARAMETER\[\"([^\"]+)\",\s*([0-9.eE+-]+)'):
                pk = pk.strip().lower().replace(' ', '_')
                pv = float(pv)
                key = {
                    'central_meridian': 'lon_0',
                    'longitude_of_center': 'lon_0',
                    'longitude_of_natural_origin': 'lon_0',
                    'longitude_of_origin': 'lon_0',
                    'latitude_of_origin': 'lat_0',
                    'latitude_of_center': 'lat_0',
                    'latitude_of_natural_origin': 'lat_0',
                    'latitude_of_false_origin': 'lat_0',
                    'longitude_of_false_origin': 'lon_0',
                    'scale_factor': 'k',
                    'scale_factor_at_natural_origin': 'k',
                    'false_easting': 'x_0',
                    'false_northing': 'y_0',
                    'easting_at_false_origin': 'x_0',
                    'northing_at_false_origin': 'y_0',
                    'standard_parallel_1': sp1_key,
                    'latitude_of_1st_standard_parallel': sp1_key,
                    'standard_parallel_2': 'lat_2',
                    'latitude_of_2nd_standard_parallel': 'lat_2',
                    'latitude_of_standard_parallel': 'lat_ts',
                    'satellite_height': 'h',
                    'azimuth': 'alpha',
                    'azimuth_of_initial_line': 'alpha',
                    'azimuth_at_projection_centre': 'alpha',
                    'co-latitude_of_cone_axis': 'alpha',
                    'rectified_grid_angle': 'gamma',
                    'angle_from_rectified_to_skew_grid': 'gamma',
                    'latitude_of_projection_centre': 'lat_0',
                    'longitude_of_projection_centre': 'lonc',
                    'scale_factor_on_initial_line': 'k',
                    'pseudo_standard_parallel_1': 'lat_1',
                    'latitude_of_pseudo_standard_parallel': 'lat_1',
                    'scale_factor_on_pseudo_standard_parallel': 'k',
                }.get(pk)
                if key:
                    params[key] = pv
            if proj == 'geos':
                if 'sweep_x' in pname:
                    params['sweep'] = 'x'
                elif 'sweep' not in params:
                    params['sweep'] = 'y'
            if proj == 'somerc':
                # the azimuth-90 (Swiss) case is the somerc
                # formulation (the GDAL convention for +proj=somerc);
                # a general initial line is the Hotine oblique
                # Mercator variant B
                alpha = params.get('alpha', 90.0)
                if abs(abs(alpha) - 90.0) > 1e-9:
                    proj = params['proj'] = 'omerc'
                else:
                    params.pop('alpha', None)
                    params.pop('gamma', None)
            if proj == 'omerc':
                # the projection centre longitude is +lonc, not +lon_0
                # (generic WKT mapping lands *_of_center on lon_0)
                if 'lonc' not in params and 'lon_0' in params:
                    params['lonc'] = params.pop('lon_0')
                raw = proj_m[0].strip().lower().replace(' ', '_')
                # EPSG variant A (natural-origin false grid) vs B
                # (projection-centre false grid): the plain WKT1 name
                # and ESRI's Natural_Origin flavor are variant A;
                # 'variant_b' / '*_center' names are variant B
                if ('variant_b' not in raw
                        and 'center' not in raw
                        and 'centre' not in raw):
                    params['no_uoff'] = True
            if pname.startswith('polar_stereographic') \
                    and 'lat_ts' not in params \
                    and abs(params.get('lat_0', 0.0)) != 90.0:
                # WKT1 convention (GDAL/ESRI): latitude_of_origin IS
                # the standard parallel; the pole is implied by its
                # hemisphere. Without this, EPSG:3413-style files
                # failed ('only polar aspects') or scaled wrongly.
                params['lat_ts'] = params.get('lat_0', 90.0)
                params['lat_0'] = 90.0 if params['lat_ts'] >= 0 \
                    else -90.0
            if pname.startswith('polar_stereographic') \
                    and 'lat_ts' in params and 'lat_0' not in params:
                # WKT2 variant B carries only the standard parallel
                # ('Latitude of standard parallel'); the pole is its
                # hemisphere. Without this EPSG:3031-style WKT2
                # silently projected with the NORTH-polar aspect.
                params['lat_0'] = 90.0 if params['lat_ts'] >= 0 \
                    else -90.0
            # projected linear unit: any UNIT/LENGTHUNIT factor that
            # is not the degree (0.01745...) scales the CRS's
            # coordinates AND its false easting/northing parameters.
            # Ignoring it treated US state-plane feet as meters
            # (a silent 3.28x position error).
            unit_factors = [
                float(fv) for fv in re.findall(
                    r'(?:LENGTH)?UNIT\[\"[^\"]*\",\s*'
                    r'([0-9.eE+-]+)', wkt)
                if abs(float(fv) - 0.017453292519943295) > 1e-6
                and float(fv) > 0]
            if unit_factors:
                factor = unit_factors[-1]
                if abs(factor - 1.0) > 1e-12:
                    params['to_meter'] = factor
                    # stored x_0/y_0 came from PARAMETER values in
                    # CRS units; proj4 convention keeps them meters
                    for fk in ('x_0', 'y_0'):
                        if fk in params:
                            params[fk] = params[fk] * factor
            params.setdefault('units', 'm')
        else:
            params['proj'] = 'longlat'

        epsg = int(authority[-1]) if authority else None
        crs = cls(params)
        if epsg is not None and crs._epsg is None:
            crs._epsg = epsg
        return crs

    # -- introspection ------------------------------------------------------------
    @property
    def proj(self):
        return self._params.get('proj', 'longlat')

    @property
    def params(self):
        return dict(self._params)

    @property
    def ellipsoid(self):
        if 'a' in self._params:
            return Ellipsoid('user', self._params['a'],
                             rf=self._params.get('rf'),
                             b=self._params.get('b'))
        return _lookup_ellps(self._params.get('ellps', 'WGS84'))

    @property
    def datum_shift(self):
        if 'towgs84' in self._params:
            return tuple(self._params['towgs84'])
        datum = self._params.get('datum', 'WGS84')
        try:
            return DATUM_TO_WGS84[datum]
        except KeyError:
            raise NotImplementedError(
                'datum %r has no built-in Helmert shift to WGS84; '
                'supply +towgs84=dx,dy,dz[,rx,ry,rz,s] explicitly '
                '(a silent zero shift would be tens to hundreds of '
                'meters wrong)' % datum)

    @property
    def is_geographic(self):
        return self.proj in ('longlat', 'latlong')

    @property
    def is_projected(self):
        return not self.is_geographic

    @property
    def linear_units(self):
        return 'degree' if self.is_geographic \
            else self._params.get('units', 'm')

    def to_epsg(self):
        return self._epsg

    def to_proj4(self):
        parts = []
        for k, v in sorted(self._params.items()):
            if v is True:
                parts.append('+%s' % k)
            elif isinstance(v, (tuple, list)):
                # proj4 list parameters (e.g. +towgs84) are
                # comma-separated, not Python tuple reprs
                parts.append('+%s=%s' % (k, ','.join('%.12g' % float(x)
                                                     for x in v)))
            else:
                parts.append('+%s=%s' % (k, v))
        if 'no_defs' not in self._params:
            parts.append('+no_defs')
        return ' '.join(parts)

    def to_dict(self):
        return dict(self._params)

    def to_wkt(self):
        ell = self.ellipsoid
        rf = (1.0 / ell.f) if ell.f else 0.0
        datum = self._params.get('datum', 'WGS84')
        towgs = ','.join('%.12g' % v for v in self.datum_shift)
        gcs_auth = ''
        gcs_code = {'WGS84': 4326, 'OSGB36': 4277, 'NAD83': 4269}.get(datum)
        gcs_name = {'WGS84': 'WGS 84', 'OSGB36': 'OSGB 1936',
                    'NAD83': 'NAD83'}.get(datum, 'unknown')
        if gcs_code:
            gcs_auth = ',AUTHORITY["EPSG","%d"]' % gcs_code
        geogcs = ('GEOGCS["%s",DATUM["%s",SPHEROID["%s",%.9g,%.12g],'
                  'TOWGS84[%s]],PRIMEM["Greenwich",0],'
                  'UNIT["degree",0.0174532925199433]%s]'
                  % (gcs_name, datum, ell.name, ell.a, rf, towgs, gcs_auth))
        if self.is_geographic:
            return geogcs
        pname = _PROJECTION_WKT_NAMES.get(self.proj, self.proj)
        if self.proj == 'geos' \
                and str(self._params.get('sweep', 'y')).lower() == 'x':
            pname = 'Geostationary_Satellite_(Sweep_X)'
        polar = self.proj == 'stere' and 'lat_ts' in self._params
        if self.proj == 'stere' \
                and abs(abs(float(self._params.get('lat_0', 90.0)))
                        - 90.0) > 1e-9:
            # non-polar aspect: GDAL's WKT1 name for +proj=stere
            pname = 'Stereographic'
        conic = self.proj in _CONIC_PROJS
        par = []
        if self.proj == 'geos' and 'h' in self._params:
            par.append('PARAMETER["satellite_height",%.12g]'
                       % float(self._params['h']))
        if self.proj == 'somerc':
            # GDAL convention for +proj=somerc under the Hotine
            # azimuth-center method name
            par.append('PARAMETER["azimuth",90]')
            par.append('PARAMETER["rectified_grid_angle",90]')
        fields = [('latitude_of_origin', 'lat_0'),
                  ('central_meridian', 'lon_0'),
                  ('standard_parallel_1', 'lat_ts'),
                  ('scale_factor', 'k'),
                  ('false_easting', 'x_0'),
                  ('false_northing', 'y_0')]
        if self.proj == 'omerc':
            if not self._params.get('no_uoff'):
                pname = 'Hotine_Oblique_Mercator_Azimuth_Center'
            alpha = float(self._params.get('alpha', 90.0))
            par.append('PARAMETER["azimuth",%.12g]' % alpha)
            par.append('PARAMETER["rectified_grid_angle",%.12g]'
                       % float(self._params.get('gamma', alpha)))
            # the projection-centre longitude may arrive as +lon_0
            # (the math path accepts both); emitting only a present
            # 'lonc' key silently dropped it from the WKT round-trip
            lonc = self._params.get('lonc',
                                    self._params.get('lon_0', 0.0))
            par.append('PARAMETER["longitude_of_center",%.12g]'
                       % float(lonc))
            fields = [('latitude_of_center', 'lat_0'),
                      ('scale_factor', 'k'),
                      ('false_easting', 'x_0'),
                      ('false_northing', 'y_0')]
        if self.proj == 'krovak':
            par.append('PARAMETER["azimuth",%.12g]'
                       % float(self._params.get(
                           'alpha', 30.288139722222223)))
            par.append('PARAMETER["pseudo_standard_parallel_1",%.12g]'
                       % float(self._params.get('lat_1', 78.5)))
            fields = [('latitude_of_center', 'lat_0'),
                      ('longitude_of_center', 'lon_0'),
                      ('scale_factor', 'k'),
                      ('false_easting', 'x_0'),
                      ('false_northing', 'y_0')]
        if conic:
            # GDAL WKT1 order for conics: SP1, SP2, then the origin
            fields = [('standard_parallel_1', 'lat_1'),
                      ('standard_parallel_2', 'lat_2'),
                      ('latitude_of_origin', 'lat_0'),
                      ('central_meridian', 'lon_0'),
                      ('scale_factor', 'k'),
                      ('false_easting', 'x_0'),
                      ('false_northing', 'y_0')]
        for wk, pk in fields:
            if pk == 'lat_0' and polar:
                # WKT1 Polar_Stereographic: latitude_of_origin IS the
                # standard parallel (GDAL/ESRI convention)
                par.append('PARAMETER["latitude_of_origin",%.12g]'
                           % float(self._params['lat_ts']))
                continue
            if pk == 'lat_ts' and polar:
                continue
            if pk == 'k':
                k = self._params.get('k', self._params.get('k_0'))
                if k is not None:
                    par.append('PARAMETER["scale_factor",%.12g]'
                               % float(k))
                continue
            if pk in self._params or pk in ('lat_0', 'lon_0'):
                pv = float(self._params.get(pk, 0.0))
                fmt = '%.12g'
                if pk in ('x_0', 'y_0'):
                    # WKT false easting/northing are in the CRS's
                    # linear unit; params store meters (proj4) — full
                    # precision so the unit conversion round-trips
                    pv = pv / float(self._params.get('to_meter', 1.0))
                    fmt = '%.17g'
                par.append(('PARAMETER["%s",' + fmt + ']') % (wk, pv))
        auth = (',AUTHORITY["EPSG","%d"]' % self._epsg) if self._epsg \
            else ''
        to_m = float(self._params.get('to_meter', 1.0) or 1.0)
        unit = 'UNIT["metre",1]' if to_m == 1.0 \
            else 'UNIT["unit",%.17g]' % to_m
        return ('PROJCS["%s",%s,PROJECTION["%s"],%s,'
                '%s%s]'
                % (self._name(), geogcs, pname, ','.join(par), unit,
                   auth))

    def _name(self):
        if self._epsg:
            return 'EPSG:%d' % self._epsg
        return self.proj

    @property
    def wkt(self):
        return self.to_wkt()

    # -- equality ------------------------------------------------------------------
    @staticmethod
    def _canonical_params(params):
        out = {}
        p = dict(params)
        proj = p.get('proj', 'longlat')
        if proj == 'latlong':
            proj = 'longlat'
        if proj == 'utm':
            zone = int(p.get('zone', 0))
            if zone:
                base = _utm_params(zone, south=bool(p.get('south')))
                base.update({k: v for k, v in p.items()
                             if k not in ('proj', 'zone', 'south')})
                p = base
            proj = 'tmerc'
            p.pop('zone', None)
            p.pop('south', None)
        out['proj'] = proj
        if proj != 'longlat':
            if 'lat_ts' in p:
                out['lat_ts'] = round(float(p['lat_ts']), 9)
            if 'lat_1' in p:
                out['lat_1'] = round(float(p['lat_1']), 9)
                # a missing second parallel means SP2 == SP1 (PROJ)
                out['lat_2'] = round(float(p.get('lat_2',
                                                 p['lat_1'])), 9)
            for k in ('lat_0', 'lon_0', 'x_0', 'y_0'):
                out[k] = round(float(p.get(k, 0.0)), 9)
            out['k'] = round(float(p.get('k', p.get('k_0', 1.0))), 12)
            if proj == 'geos':
                # different satellite heights / sweep axes are
                # different grids — conflating them made
                # transform_coords hand back inputs unchanged
                out['h'] = round(float(p.get('h', 0.0)), 3)
                out['sweep'] = str(p.get('sweep', 'y')).lower()
            if proj == 'omerc':
                alpha = float(p.get('alpha', 90.0))
                out['alpha'] = round(alpha, 9)
                out['gamma'] = round(float(p.get('gamma', alpha)), 9)
                out['lonc'] = round(float(p.get(
                    'lonc', p.get('lon_0', 0.0))), 9)
                out['no_uoff'] = bool(p.get('no_uoff'))
                # once the centre longitude is captured as lonc, a raw
                # +lon_0 spelling plays no role in the math — it must
                # not break identity with the +lonc spelling
                out['lon_0'] = 0.0
            if proj == 'krovak':
                out['alpha'] = round(float(p.get(
                    'alpha', 30.288139722222223)), 9)
                out['lat_1'] = round(float(p.get('lat_1', 78.5)), 9)
                out['lat_2'] = out['lat_1']
                out['czech'] = bool(p.get('czech'))
            if 'to_meter' in p:
                out['to_meter'] = round(float(p['to_meter']), 12)
        ell = _lookup_ellps(p['ellps']) if 'ellps' in p else (
            Ellipsoid('user', p['a'], rf=p.get('rf'), b=p.get('b'))
            if 'a' in p else ELLIPSOIDS['WGS84'])
        out['a'] = round(ell.a, 6)
        out['f'] = round(ell.f, 12)
        datum = p.get('datum', None)
        if 'towgs84' in p or datum is None \
                or datum in DATUM_TO_WGS84:
            shift = p.get('towgs84',
                          DATUM_TO_WGS84.get(datum or 'WGS84',
                                             (0, 0, 0, 0, 0, 0, 0)))
            out['towgs84'] = tuple(round(float(v), 6) for v in shift)
        else:
            # an unknown datum is NOT the same thing as WGS84: keep
            # its name in the identity so e.g. +datum=potsdam never
            # compares equal to plain WGS84 (transform_coords raises
            # for it instead of silently skipping the shift)
            out['datum'] = str(datum)
        return tuple(sorted(out.items()))

    def _canonical(self):
        # params are immutable after construction: cache the
        # canonical form (it backs __eq__/__hash__, called per warp)
        c = getattr(self, '_canonical_cache', None)
        if c is None:
            c = CRS._canonical_params(self._params)
            self._canonical_cache = c
        return c

    def __eq__(self, other):
        try:
            other = CRS.from_user_input(other)
        except Exception:
            return NotImplemented
        return self._canonical() == other._canonical()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._canonical())

    def __repr__(self):
        if self._epsg:
            return 'CRS.from_epsg(%d)' % self._epsg
        return 'CRS(%r)' % (self._params,)


def _resolve_nadgrids(crs):
    """The parsed NTv2 grid for a CRS's ``+nadgrids``, or None.

    PROJ semantics: a comma list tried in order; an ``@``-prefixed
    entry is optional (skipped silently when the file is missing);
    ``null`` ends the search with no shift; a missing required file
    raises — a silent fall-through would be metres wrong.
    """
    import os
    ng = crs._params.get('nadgrids')
    if ng is None:
        return None
    for entry in str(ng).split(','):
        entry = entry.strip()
        optional = entry.startswith('@')
        name = entry[1:] if optional else entry
        if name == 'null':
            return None
        if os.path.exists(name):
            from .ntv2 import open_gsb
            return open_gsb(name)
        if not optional:
            raise FileNotFoundError(
                'NTv2 grid %r (+nadgrids) not found; grid-shift '
                'datum transforms need the .gsb file on disk'
                % name)
    return None


def transform_coords(src_crs, dst_crs, x, y, xp=np):
    """Transform coordinate arrays between two CRS.

    Pure array math on an array namespace ``xp`` (the port calls it with
    numpy, in float64 on the host). Replaces pyproj.Transformer /
    rasterio.warp.transform.
    """
    src = CRS.from_user_input(src_crs)
    dst = CRS.from_user_input(dst_crs)
    if src == dst:
        return (xp.asarray(x), xp.asarray(y))
    lon, lat = project_inverse(src.proj, x, y, src.ellipsoid, src._params,
                               xp=xp)

    def _null_grid(crs):
        # '+nadgrids=@null' is the legacy sphere Web Mercator idiom:
        # it DISABLES datum conversion (PROJ semantics) — treating
        # the sphere as a different ellipsoid shifted EPSG:3857-style
        # strings by ~30 km
        return str(crs._params.get('nadgrids', '')) == '@null'

    skip_datum = _null_grid(src) or _null_grid(dst)
    if not skip_datum:
        # two CRS on the SAME unknown datum need no shift at all —
        # only a cross-datum transform needs the (possibly missing)
        # Helmert parameters
        sd, dd = (src._params.get('datum'), dst._params.get('datum'))
        if sd is not None and sd == dd \
                and 'towgs84' not in src._params \
                and 'towgs84' not in dst._params:
            skip_datum = True
    sgrid = None if skip_datum else _resolve_nadgrids(src)
    dgrid = None if skip_datum else _resolve_nadgrids(dst)
    if sgrid is not None or dgrid is not None:
        # NTv2 grid-shift path (+nadgrids=file.gsb): the grid encodes
        # source-datum -> WGS84; it supersedes +towgs84 on its side
        # (PROJ precedence). A grid-less other side still applies its
        # Helmert shift through geocentric coordinates.
        wgs = _lookup_ellps('WGS84')
        if sgrid is not None:
            lon, lat = sgrid.forward(lon, lat, xp=xp)
        elif any(src.datum_shift):
            X, Y, Z = geodetic_to_geocentric(lon, lat, 0.0,
                                             src.ellipsoid, xp=xp)
            X, Y, Z = helmert_transform(X, Y, Z, src.datum_shift,
                                        inverse=False, xp=xp)
            lon, lat, _ = geocentric_to_geodetic(X, Y, Z, wgs, xp=xp)
        if dgrid is not None:
            lon, lat = dgrid.inverse(lon, lat, xp=xp)
        elif any(dst.datum_shift):
            X, Y, Z = geodetic_to_geocentric(lon, lat, 0.0, wgs,
                                             xp=xp)
            X, Y, Z = helmert_transform(X, Y, Z, dst.datum_shift,
                                        inverse=True, xp=xp)
            lon, lat, _ = geocentric_to_geodetic(X, Y, Z,
                                                 dst.ellipsoid, xp=xp)
    elif not skip_datum and src.datum_shift != dst.datum_shift:
        X, Y, Z = geodetic_to_geocentric(lon, lat, 0.0, src.ellipsoid,
                                         xp=xp)
        if any(src.datum_shift):
            X, Y, Z = helmert_transform(X, Y, Z, src.datum_shift,
                                        inverse=False, xp=xp)
        if any(dst.datum_shift):
            X, Y, Z = helmert_transform(X, Y, Z, dst.datum_shift,
                                        inverse=True, xp=xp)
        lon, lat, _ = geocentric_to_geodetic(X, Y, Z, dst.ellipsoid, xp=xp)
    elif not skip_datum and src.ellipsoid != dst.ellipsoid:
        X, Y, Z = geodetic_to_geocentric(lon, lat, 0.0, src.ellipsoid,
                                         xp=xp)
        lon, lat, _ = geocentric_to_geodetic(X, Y, Z, dst.ellipsoid, xp=xp)
    return project_forward(dst.proj, lon, lat, dst.ellipsoid, dst._params,
                           xp=xp)
