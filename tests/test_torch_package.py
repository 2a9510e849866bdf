"""Package-level contracts of nd_tpu_torch: it imports neither JAX nor
nd_tpu, the head's parameters load from nd_tpu's, CPU calls never
launch a kernel, and the data model round-trips nd_tpu's Dataset; its
``__all__`` holds nd_tpu's names, ``testing.all_algorithms`` finds the
counterpart of every Algorithm class of nd_tpu, and the ``testing``
helpers behave as nd_tpu's."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nd_tpu_torch as ndt
from nd_tpu_torch import _build
from nd_tpu_torch.core import Dataset, from_jax_dataset
from nd_tpu_torch.ops import change_cuda, conv_cuda, nlmeans_cuda
from torch_cubes import sar_cube

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTED = (conv_cuda, nlmeans_cuda, change_cuda)


def test_import_loads_no_jax():
    code = ('import sys; sys.path.insert(0, "examples_torch"); '
            'import nd_tpu_torch, nd_tpu_torch.ops.change_cuda, '
            'nd_tpu_torch.ops.change_scan_cuda, '
            'nd_tpu_torch.ops.conv_cuda, nd_tpu_torch.ops.nlmeans_cuda, '
            'nd_tpu_torch.warp, nd_tpu_torch.accessors, nd_tpu_torch.crs, '
            'nd_tpu_torch.ops.interp, nd_tpu_torch.ops.fft, '
            'nd_tpu_torch.testing, nd_tpu_torch.io.netcdf, '
            'nd_tpu_torch.io.geotiff, nd_tpu_torch.io.envi, '
            'nd_tpu_torch.io.zarr, nd_tpu_torch.io.beam_dimap, '
            'nd_tpu_torch.io.lazy, nd_tpu_torch.tiling, '
            'nd_tpu_torch.io.jp2, nd_tpu_torch.native, '
            'nd_tpu_torch.vector, nd_tpu_torch.ops.rasterize, '
            'nd_tpu_torch.parallel, nd_tpu_torch.parallel.distributed, '
            'nd_tpu_torch.tracing, nd_tpu_torch.visualize, '
            'nd_tpu_torch.visualize_map, continental_mosaic, '
            'geostationary_disk, out_of_core_mosaic, timeseries_gapfill; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "nd_tpu")); print(bad); '
            'sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_load_params_round_trips_init_params():
    from nd_tpu.models.pipeline import SARChangePipeline as JPipeline
    params = {k: np.asarray(v) for k, v in
              JPipeline().init_params(seed=3).items()}
    model = ndt.SARChangePipeline().load_params(params)
    again = ndt.SARChangePipeline().load_params(model.params())
    for k in params:
        np.testing.assert_array_equal(again.params()[k], params[k])


def test_cpu_calls_leave_launch_counters_at_zero():
    for mod in COUNTED:
        mod.reset_launches()
    cube = torch.from_numpy(sar_cube(12, 14, 12, seed=31, special=False))
    ndt.SARChangePipeline()(cube)
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(('C11', 'C12__re', 'C12__im',
                                         'C22'))})
    flt = ndt.NLMeansFilter(dims=('y', 'x'), r=1, f=1, sigma=2,
                            h=3).apply(ds)
    ndt.OmnibusTest(ml=3, alpha=0.01).apply(flt)
    assert [mod.launches for mod in COUNTED] == [0, 0, 0]


def test_from_jax_dataset_round_trip():
    from nd_tpu.core import Dataset as JDataset
    rng = np.random.RandomState(32)
    a = rng.rand(4, 5, 3).astype(np.float32)
    b = rng.rand(4, 5).astype(np.float64)
    jds = JDataset({'a': (('y', 'x', 'time'), a), 'b': (('y', 'x'), b)},
                   coords={'time': np.array(['2020-01-01', '2020-01-13',
                                             '2020-01-25'],
                                            dtype='datetime64[ns]'),
                           'x': np.arange(5.0)},
                   attrs={'crs': 'EPSG:32633'})
    ds = from_jax_dataset(jds, device='cpu')
    assert ds.sizes == {'time': 3, 'x': 5, 'y': 4} or \
        dict(sorted(ds.sizes.items())) == {'time': 3, 'x': 5, 'y': 4}
    assert ds.attrs == {'crs': 'EPSG:32633'}
    assert isinstance(ds['a'].data, torch.Tensor)
    assert ds['a'].dtype == torch.float32 and ds['b'].dtype == torch.float64
    np.testing.assert_array_equal(ds['a'].values, a)
    np.testing.assert_array_equal(ds['time'].values, jds['time'].values)
    arr = ds[['a']].to_array()
    assert arr.dims == ('variable', 'y', 'x', 'time')
    back = ndt.utils.expand_variables(arr)
    np.testing.assert_array_equal(back['a'].values, a)
    ds['c'] = (('y', 'x'), torch.zeros(4, 5))
    with pytest.raises(ValueError):
        ds['d'] = (('y', 'x'), torch.zeros(3, 5))
    assert ds.transpose('x', 'y')['a'].dims == ('x', 'y', 'time')


def test_wrappers_keep_their_signatures_and_docs():
    import inspect
    params = inspect.signature(ndt.nlmeans).parameters
    assert list(params)[:2] == ['ds', 'inplace'] and 'njobs' in params
    assert 'r' in params and 'sigma' in params
    assert 'Wrapper for' in ndt.nlmeans.__doc__


def test_missing_compiler_raises(tmp_path):
    # a build failure raises; nothing falls back to the plain version
    code = ('import os, nd_tpu_torch._build as b; '
            'b._BUILD_DIR = __import__("pathlib").Path(os.environ["D"]); '
            'b.library()')
    env = dict(os.environ, PYTHONPATH=REPO, D=str(tmp_path),
               ND_TPU_TORCH_NVCC=str(tmp_path / 'no-nvcc'))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'no-nvcc' in proc.stderr


def test_failed_build_leaves_nothing_behind(tmp_path):
    # one nvcc of the parallel build fails after the others wrote their
    # objects: the build raises and leaves no object or partial library
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\n'
                    'for a; do case "$a" in *.o) touch "$a";; esac; done\n'
                    'case "$*" in *nlmeans.cu*) echo broken; exit 1;; esac\n')
    fake.chmod(0o755)
    build = tmp_path / 'build'
    code = ('import os, nd_tpu_torch._build as b; '
            'b._BUILD_DIR = __import__("pathlib").Path(os.environ["D"]); '
            'b.library()')
    env = dict(os.environ, PYTHONPATH=REPO, D=str(build),
               ND_TPU_TORCH_NVCC=str(fake))
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert 'nvcc failed' in proc.stderr and 'broken' in proc.stderr
    assert list(build.iterdir()) == []


def test_cpu_long_stack_calls_leave_launch_counters_at_zero():
    from nd_tpu_torch.ops import change_scan_cuda
    from torch_cubes import long_stack_cube
    counted = COUNTED + (change_scan_cuda,)
    for mod in counted:
        mod.reset_launches()
    cube = torch.from_numpy(long_stack_cube(8, 9, 56, seed=34))
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(('C11', 'C12__re', 'C12__im',
                                         'C22'))})
    flt = ndt.NLMeansFilter(dims=('y', 'x', 'time'), r=(1, 1, 1), f=1,
                            sigma=2, h=3).apply(ds)
    ndt.OmnibusTest(ml=3, alpha=0.99).apply(flt)
    ndt.GaussianFilter(dims=('y', 'x', 'time'), sigma=1).apply(ds['C11'])
    assert [mod.launches for mod in counted] == [0, 0, 0, 0]
    assert conv_cuda.launches3 == 0 and nlmeans_cuda.launches_3d == 0


def test_build_hashes_shared_headers(tmp_path, monkeypatch):
    # a change to a shared header (csrc/*.cuh) must rebuild the library
    for src in _build._CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, '_CSRC', tmp_path)
    before = _build._digest(_build._sources())
    header = tmp_path / 'mlog.cuh'
    header.write_text(header.read_text() + '// edited\n')
    assert _build._digest(_build._sources()) != before


def test_build_flags():
    assert '-fmad=false' in _build.NVCC_FLAGS
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    assert not any('fast_math' in f for f in _build.NVCC_FLAGS)


def test_all_names_of_nd_tpu_are_exported():
    import nd_tpu
    assert set(nd_tpu.__all__) <= set(ndt.__all__)
    for name in ndt.__all__:
        assert hasattr(ndt, name), name
    # the port's tracer adds its counters to nd_tpu's names
    assert ndt.tracing.__all__ == nd_tpu.tracing.__all__ + ['count',
                                                            'counters']


def test_all_algorithms_names_every_class_of_nd_tpu():
    from nd_tpu.testing import all_algorithms as jall
    from nd_tpu_torch.testing import Algorithm, all_algorithms
    got = all_algorithms()
    assert [c.__name__ for c in got] == [c.__name__ for c in jall()]
    assert all(issubclass(c, Algorithm) and
               c.__module__.startswith('nd_tpu_torch.') for c in got)
    assert [c.__name__ for c in all_algorithms('nd_tpu_torch.filters')] \
        == [c.__name__ for c in jall('nd_tpu.filters')]


def test_testing_helpers_match_nd_tpu(tmp_path):
    from nd_tpu import testing as jt
    from nd_tpu_torch import testing as tt
    a = [{'a': 1, 'b': 2}, {'a': 3, 'c': 'x'}]
    b = [{'a': 3, 'c': 'x', 'z': 0}, {'b': 2, 'a': 1, 'z': 1}]
    for mod in (jt, tt):
        assert mod.equal_list_of_dicts([dict(d) for d in a],
                                       [dict(d) for d in b], exclude=['z'])
        assert not mod.equal_list_of_dicts([dict(d) for d in a],
                                           [dict(d) for d in b])
    tt.assert_equal_dict({'x': torch.arange(3), 'y': 'v', 'k': 1},
                         {'x': np.arange(3), 'y': 'v', 'k': 2},
                         exclude=['k'])
    with pytest.raises(AssertionError):
        tt.assert_equal_dict({'x': torch.arange(3)}, {'x': np.arange(1, 4)})
    with pytest.raises(AssertionError):
        tt.assert_equal_dict({'y': 'v'}, {'y': 'w'})
    ds = tt.generate_test_dataset(dims={'y': 3, 'x': 4, 'time': 2},
                                  device='cpu')
    tt.assert_all_true(ds > -100)
    with pytest.raises(AssertionError):
        tt.assert_all_true(ds > 0)
    (tmp_path / 'a').write_bytes(b'abc' * 1000)
    (tmp_path / 'b').write_bytes(b'abc' * 1000)
    (tmp_path / 'c').write_bytes(b'abd' * 1000)
    tt.assert_equal_files(str(tmp_path / 'a'), str(tmp_path / 'b'))
    with pytest.raises(AssertionError):
        tt.assert_equal_files(str(tmp_path / 'a'), str(tmp_path / 'c'))
    for dep, skip in (('numpy', False), ('no_such_module_here', True)):
        mark = tt.requires(dep)
        ref = jt.requires(dep)
        assert mark.name == ref.name == 'skipif'
        assert mark.args == ref.args == (skip,)
        assert mark.kwargs == ref.kwargs
