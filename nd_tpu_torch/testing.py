"""Seeded test cubes and assertion helpers.

Counterpart of the generators and assertions of ``nd_tpu/testing.py``:
the same ``np.random.RandomState`` draws in the same order, so one seed
gives the same cube (values, coordinates and geo metadata) in both
packages. The numeric arrays land on ``device`` (default ``cuda``, as
everywhere in the port). ``requires`` is a pytest skip marker for
optional dependencies, ``all_algorithms`` walks the package for
Algorithm classes, and the ``assert_*`` helpers compare tensors as
numpy arrays. ``create_mock_classes`` builds the two-class
cube of the classifier tests. ``random_polygon``,
``generate_test_polygons`` and ``generate_test_geodataframe`` draw the
same polygons (and, with pandas, the same table) from one seed as the
JAX package's. ``run_sampling_rss`` runs a process and
samples its resident set from outside (the out-of-core checks).
"""

from __future__ import annotations

import hashlib
import importlib
import inspect
import pkgutil

import numpy as np
import torch

from .algorithm import Algorithm
from .core import DataArray, Dataset
from .crs import CRS, Affine

__all__ = ['requires', 'generate_test_dataset', 'generate_test_dataarray',
           'create_mock_classes', 'equal_list_of_dicts',
           'assert_equal_dict', 'assert_all_true', 'assert_equal_data',
           'assert_equal_crs', 'all_algorithms', 'assert_equal_files',
           'random_polygon', 'generate_test_polygons',
           'generate_test_geodataframe', 'run_sampling_rss']


def requires(dep):
    """pytest skip marker for missing optional dependencies."""
    import pytest
    from .utils import check_requirements
    return pytest.mark.skipif(
        not check_requirements(dep),
        reason='This test requires {}.'.format(dep))


def _geo_attrs(extent, nx, ny, crs):
    crs = CRS.from_user_input(crs)
    lon_min, lat_min, lon_max, lat_max = extent
    resx = (lon_max - lon_min) / (nx - 1)
    resy = (lat_max - lat_min) / (ny - 1)
    transform = Affine(resx, 0, lon_min, 0, -resy, lat_max)
    return {
        'crs': crs.to_proj4(),
        'transform': tuple(transform)[:6],
        'res': (abs(resx), abs(resy)),
        'bounds': (lon_min, lat_min, lon_max, lat_max),
    }


def generate_test_dataset(dims={'y': 20, 'x': 20, 'time': 10},
                          var=['C11', 'C12__im', 'C12__re', 'C22'],
                          mean=0, sigma=1,
                          extent=(-10.0, 50.0, 0.0, 60.0),
                          random_seed=42, crs='epsg:4326', device=None):
    """Generate a seeded random datacube with full geo metadata.

    y/x coordinates span ``extent`` (lon_min, lat_min, lon_max, lat_max),
    time is daily from 2017-01-01, variables are float64 gaussian draws
    with the given mean/sigma (per-variable if lists), on ``device``.
    """
    rng = np.random.RandomState(random_seed)
    coords = {}
    ny = dims.get('y', 1)
    nx = dims.get('x', 1)
    lon_min, lat_min, lon_max, lat_max = extent
    for d, size in dims.items():
        if d == 'y':
            coords['y'] = np.linspace(lat_max, lat_min, size)
        elif d == 'x':
            coords['x'] = np.linspace(lon_min, lon_max, size)
        elif d == 'time':
            coords['time'] = np.arange(
                np.datetime64('2017-01-01'),
                np.datetime64('2017-01-01') + np.timedelta64(size, 'D'),
                np.timedelta64(1, 'D')).astype('datetime64[ns]')
        else:
            coords[d] = np.arange(size)

    if not isinstance(mean, (list, tuple, np.ndarray)):
        mean = [mean] * len(var)
    if not isinstance(sigma, (list, tuple, np.ndarray)):
        sigma = [sigma] * len(var)
    if len(mean) != len(var) or len(sigma) != len(var):
        raise ValueError(
            'mean/sigma lists must match var (%d entries), got %d/%d'
            % (len(var), len(mean), len(sigma)))

    shape = tuple(dims.values())
    dim_names = tuple(dims.keys())
    # geo metadata only applies to spatial cubes
    attrs = _geo_attrs(extent, nx, ny, crs) \
        if 'x' in dims and 'y' in dims and nx > 1 and ny > 1 else {}
    ds = Dataset(coords=coords, attrs=attrs, device=device)
    for v, m, s in zip(var, mean, sigma):
        ds._assign(v, (dim_names,
                       (rng.normal(m, s, shape)).astype(np.float64)),
                   device)
    return ds


def generate_test_dataarray(dims={'y': 20, 'x': 20, 'time': 10},
                            name='variable', mean=0, sigma=1,
                            extent=(-10.0, 50.0, 0.0, 60.0),
                            random_seed=42, crs='epsg:4326', device=None):
    """Generate a seeded random DataArray (one variable of
    :func:`generate_test_dataset`, with the dataset's attrs)."""
    ds = generate_test_dataset(dims=dims, var=[name], mean=[mean],
                               sigma=[sigma], extent=extent,
                               random_seed=random_seed, crs=crs,
                               device=device)
    da = ds[name]
    da.attrs.update(ds.attrs)
    return da


def create_mock_classes(dims={'y': 50, 'x': 50, 'time': 10},
                        device=None):
    """Two-class separable mock data for classification tests: the
    cube of :func:`generate_test_dataset` with 10 added to the top half
    of the rows, and its (y, x) labels (2 there, 1 elsewhere), both on
    ``device``."""
    ds = generate_test_dataset(dims=dims, device=device)
    ny = dims['y']
    data0 = ds[next(iter(ds.data_vars))].data
    labels_arr = torch.ones((dims['y'], dims['x']), dtype=torch.float64,
                            device=data0.device)
    labels_arr[:ny // 2, :] = 2
    labels = DataArray(labels_arr, dims=('y', 'x'),
                       coords={'y': ds._coords['y'], 'x': ds._coords['x']})
    upper = labels_arr == 2
    for v in ds.data_vars:
        data = ds[v].data.clone()
        data[upper] += 10
        ds[v] = (ds[v].dims, data)
    return ds, labels


def random_polygon(x=0, y=0, radius=1, irregularity=0.5, n=10,
                   random_seed=None):
    """A random simple polygon around (x, y)."""
    rng = np.random.RandomState(random_seed)
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = radius * (1 + irregularity * (rng.uniform(size=n) - 0.5))
    xs = x + radii * np.cos(angles)
    ys = y + radii * np.sin(angles)
    from .vector.geometry import Polygon
    return Polygon(zip(xs, ys))


def generate_test_polygons(n=10, extent=(-10.0, 50.0, 0.0, 60.0),
                           random_seed=None):
    """Random, pairwise non-overlapping polygons inside ``extent``: one
    in each of ``n`` cells of a jittered grid."""
    rng = np.random.RandomState(random_seed)
    lon_min, lat_min, lon_max, lat_max = extent
    grid = int(np.ceil(np.sqrt(n)))
    cw = (lon_max - lon_min) / grid
    ch = (lat_max - lat_min) / grid
    polys = []
    cells = [(i, j) for i in range(grid) for j in range(grid)]
    rng.shuffle(cells)
    for (i, j) in cells[:n]:
        cx = lon_min + (j + 0.5) * cw
        cy = lat_min + (i + 0.5) * ch
        polys.append(random_polygon(
            cx, cy, radius=0.35 * min(cw, ch), n=8,
            random_seed=rng.randint(2 ** 31)))
    return polys


def generate_test_geodataframe(n=10, extent=(-10.0, 50.0, 0.0, 60.0),
                               crs='epsg:4326', random_seed=None):
    """A random polygon table (pandas) with categorical/float/int/date
    columns and its CRS in ``df.attrs['crs']``."""
    import pandas as pd
    rng = np.random.RandomState(random_seed)
    polys = generate_test_polygons(n=n, extent=extent,
                                   random_seed=random_seed)
    df = pd.DataFrame({
        'category': rng.choice(['forest', 'water', 'urban'], n),
        'float': rng.uniform(0, 1, n),
        'integer': rng.randint(0, 100, n),
        'date': pd.to_datetime('2020-01-01')
        + pd.to_timedelta(rng.randint(0, 3, n), unit='D'),
    })
    df['geometry'] = polys
    df.attrs['crs'] = CRS.from_user_input(crs)
    return df


def equal_list_of_dicts(obj1, obj2, exclude=[]):
    """Compare two lists of dictionaries (order-insensitive)."""
    for key in exclude:
        for obj in obj1 + obj2:
            obj.pop(key, None)
    serial1 = sorted(repr(sorted(_.items())) for _ in obj1)
    serial2 = sorted(repr(sorted(_.items())) for _ in obj2)
    return serial1 == serial2


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def assert_equal_dict(d1, d2, exclude=[]):
    """Assert two dicts equal; arrays and tensors compare elementwise."""
    d1 = {k: v for k, v in d1.items() if k not in exclude}
    d2 = {k: v for k, v in d2.items() if k not in exclude}
    for k in set(d1) | set(d2):
        v1, v2 = _host(d1.get(k)), _host(d2.get(k))
        if isinstance(v1, np.ndarray) or isinstance(v2, np.ndarray):
            np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        else:
            assert v1 == v2, '%r: %r != %r' % (k, v1, v2)


def assert_all_true(ds):
    assert bool(np.all(np.concatenate(
        [np.asarray(ds[v].values).ravel() for v in ds.data_vars])))


def assert_equal_data(ds1, ds2, rtol=1e-7, atol=0):
    """Assert that two Datasets/DataArrays contain the same data."""
    if isinstance(ds1, DataArray):
        np.testing.assert_allclose(
            np.asarray(ds1.values),
            np.asarray(ds2.transpose(*ds1.dims).values
                       if isinstance(ds2, DataArray) else ds2),
            rtol=rtol, atol=atol)
        return
    assert set(ds1.data_vars) == set(ds2.data_vars)
    for v in ds1.data_vars:
        np.testing.assert_allclose(
            np.asarray(ds1[v].values),
            np.asarray(ds2[v].transpose(*ds1[v].dims).values),
            rtol=rtol, atol=atol, err_msg='variable %s differs' % v)


def assert_equal_crs(crs1, crs2):
    c1 = CRS.from_user_input(crs1)
    c2 = CRS.from_user_input(crs2)
    assert c1 == c2, '%r != %r' % (c1, c2)


def all_algorithms(parent=None):
    """Every concrete Algorithm subclass in ``parent`` (default: the
    package) and its submodules, sorted by class name; ``native`` (host
    C++) is not walked."""
    import nd_tpu_torch
    if parent is None:
        parent = nd_tpu_torch
    elif isinstance(parent, str):
        parent = importlib.import_module(parent)

    found = {}

    def _collect(module):
        for name, obj in inspect.getmembers(module, inspect.isclass):
            if issubclass(obj, Algorithm) and not inspect.isabstract(obj):
                found['%s.%s' % (obj.__module__, obj.__name__)] = obj

    _collect(parent)
    if hasattr(parent, '__path__'):
        for info in pkgutil.walk_packages(parent.__path__,
                                          parent.__name__ + '.'):
            if 'native' in info.name.split('.'):
                continue
            try:
                mod = importlib.import_module(info.name)
            except ImportError:
                continue
            _collect(mod)
    return sorted(set(found.values()), key=lambda c: c.__name__)


def assert_equal_files(f1, f2):
    """Assert two files are byte-identical (md5)."""
    def _md5(path):
        h = hashlib.md5()
        with open(path, 'rb') as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b''):
                h.update(chunk)
        return h.hexdigest()
    assert _md5(f1) == _md5(f2)


def _resident(pid):
    """Resident bytes of process ``pid`` (``/proc/<pid>/statm``)."""
    import os
    with open('/proc/%d/statm' % pid) as fh:
        return int(fh.read().split()[1]) * os.sysconf('SC_PAGE_SIZE')


def run_sampling_rss(args, marker='warm', timeout=900, env=None, cwd=None):
    """Run ``args`` and sample its resident set from this process about
    every millisecond. The child prints ``marker`` on a line of its own
    once it has its baseline (after its imports and a warm-up) and then
    waits for a line on its standard input; the baseline is the peak
    sampled until then. Sampling from outside needs neither ``VmHWM``
    (missing in some sandboxes' ``/proc``) nor ``ru_maxrss`` (which
    carries the parent's peak across fork and exec).

    Returns ``(returncode, stdout, stderr, baseline, peak)``, bytes.
    """
    import subprocess
    import threading
    import time
    proc = subprocess.Popen(args, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=cwd)
    lines, errors = [], []
    warm = threading.Event()

    def pump_out():
        for line in proc.stdout:
            lines.append(line)
            if line.strip() == marker:
                warm.set()

    readers = [threading.Thread(target=pump_out),
               threading.Thread(target=lambda: errors.append(
                   proc.stderr.read()))]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout
    base = peak = 0
    released = False
    try:
        while proc.poll() is None:
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(args, timeout)
            try:
                peak = max(peak, _resident(proc.pid))
            except (FileNotFoundError, ProcessLookupError):
                break                           # it has just exited
            if warm.is_set() and not released:
                base = peak                     # the child waits here
                proc.stdin.write('go\n')
                proc.stdin.flush()
                released = True
            time.sleep(0.001)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdin.close()
        for t in readers:
            t.join()
    return proc.returncode, ''.join(lines), ''.join(errors), base, peak
