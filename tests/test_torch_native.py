"""The port's host C++ oracles (``nd_tpu_torch.native``:
``nlmeans_native``, ``change_detection_native``) against the JAX
package's (``nd_tpu._native``) on the CPU.

Both build the same sources with the same flags (``-O3 -march=native
-fopenmp``) on the same host, so their outputs are held bit for bit, in
float32 and float64, and the error cases raise the same messages. On
``bench.py``'s ``cpu_baseline`` configuration (the 128 x 128 cut of the
bench cube, alpha 0.99, 9 looks) the oracle's change map has 0
mismatches against nd_tpu's exact decisions (the float64 'mixed' scan)
and against the port's exact mode, measured on the CPU; its NLMeans
(r=(1, 1, 0), f=(1, 1, 0), sigma 2, h 3) is within rtol 1e-5, atol 1e-6
of the port's plain NLMeans (largest difference 7.2e-7 measured).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from nd_tpu import _native as jn
from nd_tpu.ops.change import change_detection as jchange
from nd_tpu_torch import native
from nd_tpu_torch.ops import nlmeans_cuda
from nd_tpu_torch.ops.change import change_detection_exact
from torch_cubes import sar_cube

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def cut():
    """bench.py's cpu_baseline input: the 128 x 128 cut of the bench
    cube (chip_smoke.make_cube, bench.py's _make_cube)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    return np.ascontiguousarray(chip_smoke.make_cube(1024, 1024, 12)
                                [:128, :128])


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('r,f,n_eff', [
    ((1, 1, 0), (1, 1, 0), -1.0), ((2, 2, 0), (1, 1, 0), -1.0),
    ((2, 1, 1), (1, 1, 1), -1.0), ((1, 2, 0), (2, 1, 0), 4.0)])
def test_nlmeans_bit_equal(dtype, r, f, n_eff):
    a = np.random.RandomState(3).rand(13, 17, 5, 4).astype(dtype) * 3
    got = native.nlmeans_native(a, r, f, 1.5, 0.7, n_eff, nthreads=2)
    ref = jn.nlmeans_native(a, r, f, 1.5, 0.7, n_eff, nthreads=2)
    assert got.dtype == ref.dtype == dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('k,alpha,n', [(12, 0.99, 9), (12, 0.01, 1),
                                       (40, 0.5, 4), (7, 1e-6, 9)])
def test_change_bit_equal(dtype, k, alpha, n):
    v = sar_cube(11, 13, k, seed=k + n).astype(dtype)
    got = native.change_detection_native(v, alpha, n=n, nthreads=2)
    ref = jn.change_detection_native(v, alpha, n=n, nthreads=2)
    assert got.dtype == np.bool_ and got.shape == (11, 13, k)
    np.testing.assert_array_equal(got, ref)


def test_error_cases_match_jax():
    a = np.zeros((4, 20, 3, 2), np.float32)
    for mod in (native, jn):
        with pytest.raises(ValueError,
                           match=re.escape('r + f (4) must be smaller than '
                                           'dim 0 size (4)')):
            mod.nlmeans_native(a, (2, 1, 0), (2, 1, 0), 1.0, 1.0)
        with pytest.raises(ValueError, match=re.escape(
                'expected (y, x, time, 4) dual-pol covariance channels, '
                'got shape (4, 20, 3, 2)')):
            mod.change_detection_native(a, 0.5)


def test_cpu_baseline_cut(cut):
    """bench.py's cpu_baseline: the oracles against nd_tpu's and the
    port's exact decisions and the port's plain NLMeans."""
    got = native.change_detection_native(cut, 0.99, n=9, nthreads=1)
    np.testing.assert_array_equal(
        got, jn.change_detection_native(cut, 0.99, n=9, nthreads=1))
    ref = np.asarray(jchange(cut, 0.99, n=9, stat_dtype='mixed'))
    assert int((got != ref).sum()) == 0 and int(got.sum()) > 0
    port = change_detection_exact(torch.from_numpy(cut), 0.99, n=9).numpy()
    assert int((got != port).sum()) == 0
    nl = native.nlmeans_native(cut, (1, 1, 0), (1, 1, 0), 2.0, 3.0, -1.0,
                               nthreads=1)
    np.testing.assert_array_equal(
        nl, jn.nlmeans_native(cut, (1, 1, 0), (1, 1, 0), 2.0, 3.0, -1.0,
                              nthreads=1))
    plain = nlmeans_cuda.nlmeans_spatial_plain(
        torch.from_numpy(cut), (1, 1), (1, 1), 2.0, 3.0).numpy()
    np.testing.assert_allclose(plain, nl, rtol=1e-5, atol=1e-6)


def test_oracles_build_into_the_package():
    info = native.oracle_info()
    path = info['path']
    assert os.path.dirname(path).endswith(os.path.join('nd_tpu_torch',
                                                       '.build'))
    assert os.path.basename(path).startswith('libnd_oracles_')
    assert native.ORACLE_FLAGS == ('-O3', '-march=native', '-fopenmp',
                                   '-shared', '-fPIC', '-std=c++17')
    assert native.available()


def test_failed_oracle_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, '_oracles', None)
    monkeypatch.setattr(native, '_BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, 'CXX', 'false')       # exits 1
    with pytest.raises(RuntimeError, match='host build of nlmeans.cpp '
                                           'change.cpp failed'):
        native.nlmeans_native(np.zeros((4, 4, 1, 1)), (1, 1, 0),
                              (1, 1, 0), 1.0, 1.0)
    assert not native.available()
    assert not [f for f in os.listdir(tmp_path / 'build')
                if not f.startswith('.')], 'a failed build left a file'
    monkeypatch.setattr(native, 'CXX', 'no-such-compiler-on-path')
    with pytest.raises(RuntimeError, match='not found'):
        native.change_detection_native(np.zeros((2, 2, 3, 4)), 0.5)


def test_no_path_calls_the_oracles():
    """They are oracles and the CPU yardstick: no module of the port
    outside ``native`` calls them, so nothing falls back to them."""
    root = os.path.join(REPO, 'nd_tpu_torch')
    hits = []
    for base, _, files in os.walk(root):
        if os.path.basename(base) == 'native':
            continue
        for name in files:
            if name.endswith('.py'):
                with open(os.path.join(base, name)) as fh:
                    text = fh.read()
                if re.search(r'nlmeans_native|change_detection_native|'
                             r'oracles\(', text):
                    hits.append(os.path.join(base, name))
    assert hits == []
