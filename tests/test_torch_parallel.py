"""Host-level chunking in nd_tpu_torch: ``xr_split``/``xr_merge`` against
nd_tpu's on the same cube, ``parallel`` with each scheduler, ``njobs``
for every filter and for ``Reprojection``, and the kernel wrappers'
bookkeeping from many threads.

Tolerances: split and merge move no arithmetic, and a chunk's outputs
are computed exactly as in the whole call (the halo carries every input
a window reads), so every comparison here is exact (``torch.equal``),
except the parity of the split itself with nd_tpu, which compares
values (float64, exact too).
"""

import sys
import threading

import numpy as np
import pytest
import torch

from nd_tpu.testing import generate_test_dataset as jgen
from nd_tpu.utils import xr_merge as jmerge
from nd_tpu.utils import xr_split as jsplit
import nd_tpu_torch as ndt
from nd_tpu_torch import _build, utils
from nd_tpu_torch.core import DataArray, Dataset
from nd_tpu_torch.ops import change_scan_cuda
from nd_tpu_torch.testing import generate_test_dataset

from _pool_worker import affine_chunk

DIMS = {'y': 17, 'x': 13, 'time': 6}


def _cube():
    return generate_test_dataset(dims=DIMS, device='cpu')


def _equal(a, b):
    assert list(a.data_vars) == list(b.data_vars)
    for v in a.data_vars:
        assert a[v].dims == b[v].dims
        assert torch.equal(a[v].data, b[v].data), v
    for c in b.coords:
        got, ref = np.asarray(a[c].values), np.asarray(b[c].values)
        assert np.array_equal(got, ref, equal_nan=ref.dtype.kind == 'f'), c


@pytest.mark.parametrize('dim,chunks,buffer', [
    ('y', 3, 0), ('y', 4, 2), ('x', 5, 1), ('time', 4, 0), ('y', 40, 3),
    ('x', 2, 6)])
def test_split_matches_jax_and_merges_back(dim, chunks, buffer):
    t, j = _cube(), jgen(dims=DIMS)
    tparts = list(utils.xr_split(t, dim, chunks, buffer))
    jparts = list(jsplit(j, dim, chunks, buffer))
    assert len(tparts) == len(jparts)
    for tp, jp in zip(tparts, jparts):
        assert tp.sizes == jp.sizes
        for v in jp.data_vars:
            np.testing.assert_array_equal(tp[v].values,
                                          np.asarray(jp[v].values))
    merged = utils.xr_merge(tparts, dim, buffer)
    _equal(merged, t)
    assert merged.sizes == jmerge(jparts, dim, buffer).sizes


def test_merge_trims_interior_seams_only():
    da = DataArray(torch.arange(10.0), dims=('y',),
                   coords={'y': np.arange(10)}, device='cpu')
    parts = list(utils.xr_split(da, 'y', 3, buffer=2))
    assert [p.sizes['y'] for p in parts] == [6, 7, 5]
    assert torch.equal(utils.xr_merge(parts, 'y', 2).data, da.data)


@pytest.mark.parametrize('scheduler', ['threads', 'serial'])
def test_parallel_equals_the_whole_call(scheduler):
    ds = _cube()

    def running_sum(part):
        return part.rolling(y=3, center=True, min_periods=1).sum()

    whole = running_sum(ds)
    got = utils.parallel(running_sum, dim='y', chunks=4, buffer=1,
                         scheduler=scheduler)(ds)
    _equal(got, whole)
    parts = utils.parallel(running_sum, dim='y', chunks=4, buffer=1,
                           scheduler=scheduler, merge=False)(ds)
    assert len(parts) == 4


def test_parallel_processes_on_cpu_payloads():
    ds = _cube()
    got = utils.parallel(affine_chunk, dim='y', chunks=2,
                         scheduler='processes')(ds, 2.0, offset=1.0)
    _equal(got, ds * 2.0 + 1.0)


def test_parallel_processes_refuses_card_payloads():
    ds = Dataset({'a': (('y', 'x'), torch.zeros(4, 3, device='meta'))})
    with pytest.raises(ValueError, match='CUDA context'):
        utils.parallel(affine_chunk, dim='y', chunks=2,
                       scheduler='processes')(ds, 1.0)
    with pytest.raises(ValueError, match='scheduler'):
        utils.parallel(affine_chunk, scheduler='fork')


DISK = np.array([[1.0 if i * i + j * j <= 5 else 0.0 for j in range(-2, 3)]
                 for i in range(-2, 3)])
FILTERS = {
    'convolution_disk': lambda: ndt.ConvolutionFilter(dims=('y', 'x'),
                                                      kernel=DISK / 21),
    'convolution_3d': lambda: ndt.ConvolutionFilter(
        dims=('y', 'x', 'time'),
        kernel=np.random.RandomState(2).rand(3, 3, 3)),
    'boxcar': lambda: ndt.BoxcarFilter(dims=('y', 'x'), w=3),
    'boxcar_3d': lambda: ndt.BoxcarFilter(dims=('y', 'x', 'time'), w=3),
    'gaussian': lambda: ndt.GaussianFilter(dims=('y', 'x'), sigma=1.5),
    'gaussian_3d': lambda: ndt.GaussianFilter(dims=('y', 'x', 'time'),
                                              sigma=1),
    'nlmeans': lambda: ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1,
                                         sigma=2, h=3),
    'nlmeans_3d': lambda: ndt.NLMeansFilter(dims=('y', 'x', 'time'),
                                            r=(1, 1, 1), f=1, sigma=2, h=3),
    'reprojection': lambda: ndt.Reprojection(crs='epsg:3395'),
}


@pytest.mark.parametrize('njobs', [2, 3, -1])
@pytest.mark.parametrize('name', sorted(FILTERS))
def test_njobs_equals_one_job(name, njobs):
    ds = _cube()
    algo = FILTERS[name]()
    one = algo.apply(ds)
    dim = algo._parallel_dimension(ds)
    if name.endswith('_3d'):
        assert dim == 'y' and algo._buffer('y') >= 1
    elif name != 'reprojection':
        assert dim == 'time' and algo._buffer('time') == 0
    _equal(algo.apply(ds, njobs=njobs), one)


def test_bookkeeping_from_threads():
    """Counters and the table cache under a short switch interval: a lost
    update would leave the count short."""
    counters = {'launches': 0}
    tabs = [{'f2_coefs': [1.0, 2.0], 'f2_small': [0.5], 's_small': [0.1],
             'cg_tab': [0.0] * 3, 'sg_tab': [0.0] * 3} for _ in range(80)]
    errors = []

    def work(i):
        try:
            for _ in range(500):
                _build.bump(counters, 'launches')
            arrays = change_scan_cuda._table_arrays(tabs[i % len(tabs)])
            assert arrays[0].tolist() == [1.0, 2.0]
        except Exception as err:      # reported below
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert counters['launches'] == 32 * 500


def test_apply_from_threads_counts_each_route():
    da = DataArray(torch.rand(6, 5, 4, dtype=torch.float64),
                   dims=('y', 'x', 'time'))
    before = dict(utils.routes)
    results = [None] * 8

    def work(i):
        results[i] = utils.apply(da, lambda s: s - s.mean(),
                                 signature='(time)->(time)')

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert utils.routes['vmap'] - before['vmap'] == 8
    for r in results:
        assert torch.equal(r.data, results[0].data)


def test_small_helpers_match_jax():
    import nd_tpu.utils as J
    a = np.arange(60.0).reshape(3, 4, 5)
    assert list(utils.chunks(list(range(7)), 3)) == list(J.chunks(
        list(range(7)), 3))
    for axis in (0, 2):
        for got, ref in zip(utils.array_chunks(torch.from_numpy(a), 2, axis),
                            J.array_chunks(a, 2, axis)):
            np.testing.assert_array_equal(got.numpy(), ref)
    for arr in (a, torch.from_numpy(a)):
        blocks = utils.block_split(arr, (2, 3, 1))
        refs = J.block_split(a, (2, 3, 1))
        assert len(blocks) == len(refs)
        for got, ref in zip(blocks, refs):
            np.testing.assert_array_equal(np.asarray(got), ref)
        back = utils.block_merge(blocks, (2, 3, 1))
        np.testing.assert_array_equal(np.asarray(back), a)
    with pytest.raises(ValueError):
        utils.block_merge(utils.block_split(a, (2, 1, 1)), (3, 1, 1))
    d = {'a': [1, 2], 'b': ['x', 'y', 'z']}
    assert list(utils.dict_product(d)) == list(J.dict_product(d))
    objs = [1, 5, 8, 12]
    for kw in ({}, {'first': True}, {'unlist': False}):
        assert utils.select(objs, lambda v: v > 6, **kw) == \
            J.select(objs, lambda v: v > 6, **kw)
    assert utils.select({'a': 1, 'b': 9}, lambda v: v > 6) == \
        J.select({'a': 1, 'b': 9}, lambda v: v > 6)
    assert utils.squeeze(torch.tensor([4.5])) == J.squeeze(np.array([4.5]))
    assert utils.squeeze('text') == 'text'
    assert utils.ncpus() == J.ncpus()


@pytest.mark.parametrize('text,fmt,tz', [
    ('2017-01-31', None, False), ('2017-01-31T12:34:56', None, True),
    ('2017-01-31T12:34:56+02:00', None, False),
    ('2017-01-31T12:34:56Z', None, True), ('20170131', None, False),
    ('31/01/2017', '%d/%m/%Y', True)])
def test_str2date_matches_jax_without_pandas(text, fmt, tz, monkeypatch):
    import nd_tpu.utils as J
    ref = J.str2date(text, fmt, tz)
    monkeypatch.setitem(sys.modules, 'pandas', None)
    assert utils.str2date(text, fmt, tz) == ref


def test_requires_and_check_requirements():
    import nd_tpu.utils as J
    for dep in ('gsl', 'numpy', ('gdal', 'numpy'), 'no_such_module_here'):
        assert utils.check_requirements(dep) == J.check_requirements(dep)

    @utils.requires('no_such_module_here')
    def needs():
        return 1

    @utils.requires('numpy')
    class Fine:
        def __init__(self):
            self.ok = True

    with pytest.raises(ImportError):
        needs()
    assert Fine().ok and Fine._skip is False
