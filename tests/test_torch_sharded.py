"""nd_tpu_torch.parallel against nd_tpu.parallel on the CPU: the mesh, the
halo exchange, the sharded engine and the sharded training step.

The JAX side runs on the suite's eight forced host devices
(``tests/conftest.py``); the port's counterpart is a mesh that names the
CPU eight times, ``get_mesh(devices=[cpu] * 8)``, which factorizes to
the same (2, 4). Both packages take the same seeded numpy inputs, and
each sharded result is held to its own package's serial apply and to
the other package's sharded result.

Tolerances: sharded equals serial bit for bit in the port (``torch.equal``
on every variable; each kernel's plain version computes an output from
its window alone, in the same order, wherever the block lies). Against
nd_tpu, at ROADMAP's contracts: convolutions rtol 1e-13 in float64 and
1e-6 in float32 (with the stencil tests' atol of rtol * sum|k| * max|x|,
for outputs near 0), NLMeans rtol 1e-5 / atol 1e-6, change maps equal,
reprojection rtol 1e-12 in float64; the sharded training step within
``tests/test_models.py``'s tolerances of the one-device step (loss rtol
1e-6, parameters rtol 1e-5 / atol 1e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nd_tpu import filters as jfilters
from nd_tpu.ops.conv import convolve as jconvolve
from nd_tpu.parallel import apply_sharded as japply_sharded
from nd_tpu.parallel import get_mesh as jget_mesh
from nd_tpu.parallel import shard_apply as jshard_apply
from nd_tpu.parallel import sharded_change_detection as jsharded_change
from nd_tpu.testing import generate_test_dataset as jgen
import nd_tpu_torch as ndt
from nd_tpu_torch import filters as tfilters
from nd_tpu_torch.core import DataArray
from nd_tpu_torch.ops.conv import convolve
from nd_tpu_torch.parallel import (apply_sharded, get_mesh, halo,
                                   shard_apply, shard_dataset,
                                   sharded_change_detection,
                                   sharded_reproject)
from nd_tpu_torch.parallel.halo import ShardedArray
from nd_tpu_torch.testing import generate_test_dataset

CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def jmesh():
    return jget_mesh()           # 8 forced host devices -> (2, 4)


@pytest.fixture(scope='module')
def mesh():
    return get_mesh(devices=[CPU] * 8)


@pytest.fixture(scope='module')
def mesh22():
    return get_mesh((2, 2), devices=[CPU] * 4)


def _pair(dims, f32=False, **kw):
    """The same seeded cube in both packages (float64 unless f32)."""
    j = jgen(dims=dims, **kw)
    t = generate_test_dataset(dims=dims, device='cpu', **kw)
    if f32:
        for v in list(j.data_vars):
            j[v] = (j[v].dims, np.asarray(j[v].values).astype(np.float32))
            t[v] = (t[v].dims, t[v].data.to(torch.float32))
    return j, t


def _bit_equal(got, ref):
    """Port against port: every variable bit for bit."""
    if isinstance(ref, DataArray):
        assert got.dims == ref.dims
        assert torch.equal(got.data, ref.data)
        return
    assert sorted(got.data_vars) == sorted(ref.data_vars)
    for v in ref.data_vars:
        assert got[v].dims == ref[v].dims, v
        assert got[v].data.device == ref[v].data.device, v
        assert torch.equal(got[v].data, ref[v].data), v


def _close(got, jref, rtol, atol=0.0):
    """Port against nd_tpu at the contract's tolerance."""
    if not hasattr(jref, 'data_vars'):
        np.testing.assert_allclose(got.values, np.asarray(jref.values),
                                   rtol=rtol, atol=atol)
        return
    assert sorted(got.data_vars) == sorted(jref.data_vars)
    for v in jref.data_vars:
        np.testing.assert_allclose(got[v].values, np.asarray(jref[v].values),
                                   rtol=rtol, atol=atol, err_msg=v)


def _conv_tol(ds, algo):
    """rtol 1e-6 (float32) or 1e-13 (float64), with the stencil tests'
    atol of rtol * sum|k| * max|x| (the packages sum taps in other
    orders)."""
    rtol = 1e-6 if ds[next(iter(ds.data_vars))].data.dtype == torch.float32 \
        else 1e-13
    ksum = float(np.abs(getattr(algo, 'kernel', np.ones(1))).sum())
    xmax = max(float(ds[v].data.abs().max()) for v in ds.data_vars)
    return dict(rtol=rtol, atol=rtol * ksum * xmax)


# ---- the mesh ---------------------------------------------------------------

def test_mesh_shape(mesh, jmesh):
    assert len(jax.devices()) == 8
    assert dict(mesh.shape) == dict(jmesh.shape) == {'y': 2, 'x': 4}
    assert mesh.devices.shape == (2, 4)
    assert all(d == CPU for d in mesh.devices.reshape(-1))


def test_get_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        get_mesh()
    with pytest.raises(ValueError, match='does not match'):
        get_mesh((3, 3), devices=[CPU] * 8)


@pytest.mark.parametrize('n', [1, 2, 6, 7, 8, 12])
def test_factorize2d_matches_jax(n):
    from nd_tpu.parallel import factorize2d as jfactorize2d
    from nd_tpu_torch.parallel import factorize2d
    assert factorize2d(n) == jfactorize2d(n)


# ---- shard_apply ------------------------------------------------------------

def _stencil(x, mode='reflect'):
    return convolve(x, np.ones((3, 3)) / 9, axes=(0, 1), mode=mode)


def _jstencil(x, mode='reflect'):
    return jconvolve(x, jnp.ones((3, 3)) / 9, axes=(0, 1), mode=mode)


def test_shard_apply_identity(mesh):
    arr = torch.arange(64.).reshape(8, 8)
    out = shard_apply(lambda x: x, arr, mesh, {'y': (0, 0), 'x': (1, 0)})
    assert torch.equal(out, arr)


@pytest.mark.parametrize('shape', [(32, 40), (17, 23)])
def test_shard_apply_halo_stencil(mesh, jmesh, shape):
    """A 3 x 3 mean sharded over the mesh equals the unsharded one; the
    non-divisible shape is padded and trimmed."""
    arr = np.random.RandomState(0 if shape == (32, 40) else 1).rand(*shape)
    axes = {'y': (0, 1), 'x': (1, 1)}
    out = shard_apply(_stencil, torch.from_numpy(arr), mesh, axes)
    assert torch.equal(out, _stencil(torch.from_numpy(arr)))
    jout = jshard_apply(_jstencil, jnp.asarray(arr), jmesh, axes,
                        mode='symmetric')
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-13)


@pytest.mark.parametrize('mode,scipy_mode,cval', [
    ('symmetric', 'reflect', 0.0), ('reflect', 'mirror', 0.0),
    ('edge', 'nearest', 0.0), ('constant', 'constant', 2.5),
    ('wrap', 'wrap', 0.0)])
@pytest.mark.parametrize('kind', ['separable', 'stencil'])
def test_shard_apply_modes_on_a_2x2_mesh(mesh22, mode, scipy_mode, cval,
                                         kind):
    """Every boundary mode on a 2 x 2 mesh, with a 2-D window that reads
    the corner blocks: the separable 5 x 5 boxcar (sepconv) and a random
    3 x 5 kernel (the stencil); JAX's shard_apply on a (2, 2) mesh of its
    host devices agrees."""
    rng = np.random.RandomState(7)
    shape = (16, 20) if mode == 'wrap' else (15, 21)
    arr = rng.rand(*shape).astype(np.float32)
    kernel = np.full((5, 5), 1 / 25.) if kind == 'separable' \
        else rng.rand(3, 5)
    halos = {'y': (0, kernel.shape[0] // 2), 'x': (1, kernel.shape[1] // 2)}

    def fn(x):
        return convolve(x, kernel, axes=(0, 1), mode=scipy_mode, cval=cval)
    out = shard_apply(fn, torch.from_numpy(arr), mesh22, halos, mode=mode,
                      cval=cval)
    assert torch.equal(out, fn(torch.from_numpy(arr)))
    jm = jget_mesh((2, 2), devices=jax.devices()[:4])
    jout = jshard_apply(
        lambda x: jconvolve(x, jnp.asarray(kernel), axes=(0, 1),
                            mode=scipy_mode, cval=cval),
        jnp.asarray(arr), jm, halos, mode=mode, cval=cval)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-7)


def test_shard_apply_corners_hold_the_diagonal_neighbour(mesh22):
    """The padded blocks' corners: the second axis's slabs are cut from
    blocks padded along the first, so block (1, 1)'s top-left corner is
    block (0, 0)'s bottom-right data."""
    arr = torch.arange(8 * 8, dtype=torch.float64).reshape(8, 8)
    seen = {}

    def grab(x):
        seen[len(seen)] = x.clone()
        return x
    shard_apply(grab, arr, mesh22, {'y': (0, 2), 'x': (1, 2)})
    corner = seen[3][:2, :2]                   # block (1, 1), padded
    assert torch.equal(corner, arr[2:4, 2:4])


def test_halo_larger_than_a_shard_raises_as_nd_tpu(mesh, jmesh):
    arr = np.random.RandomState(0).rand(8, 8)
    axes = {'y': (0, 1), 'x': (1, 3)}          # x blocks of 2 rows
    with pytest.raises(ValueError) as got:
        shard_apply(lambda x: x, torch.from_numpy(arr), mesh, axes)
    with pytest.raises(ValueError) as ref:
        jshard_apply(lambda x: x, jnp.asarray(arr), jmesh, axes)
    assert str(got.value) == str(ref.value)
    assert 'halo (3) exceeds' in str(got.value)


def test_wrap_on_a_non_divisible_axis_raises_as_nd_tpu(mesh, jmesh):
    arr = np.random.RandomState(0).rand(10, 11)
    axes = {'y': (0, 1), 'x': (1, 1)}
    with pytest.raises(ValueError) as got:
        shard_apply(_stencil, torch.from_numpy(arr), mesh, axes,
                    mode='wrap')
    with pytest.raises(ValueError) as ref:
        jshard_apply(_jstencil, jnp.asarray(arr), jmesh, axes, mode='wrap')
    assert str(got.value) == str(ref.value)


def test_shard_apply_wrap_divisible(mesh, jmesh):
    arr = np.random.RandomState(1).rand(16, 16)
    axes = {'y': (0, 1), 'x': (1, 1)}

    def fn(x):
        return _stencil(x, 'wrap')
    out = shard_apply(fn, torch.from_numpy(arr), mesh, axes, mode='wrap')
    assert torch.equal(out, fn(torch.from_numpy(arr)))
    jout = jshard_apply(lambda x: _jstencil(x, 'wrap'), jnp.asarray(arr),
                        jmesh, axes, mode='wrap')
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-13)


def test_halo_bytes_count_the_neighbour_slabs(mesh22):
    """(2, 2) blocks of 8 x 8 float64 with halo 1: y exchanges two 1 x 8
    slabs a column of blocks, x two 10 x 1 slabs (already padded along y)
    a row."""
    halo.reset_halo_bytes()
    shard_apply(lambda x: x, torch.zeros(16, 16, dtype=torch.float64),
                mesh22, {'y': (0, 1), 'x': (1, 1)})
    assert halo.halo_bytes == (2 * 2 * 8 + 2 * 2 * 10) * 8


# ---- apply_sharded ----------------------------------------------------------

FILTERS = {
    'boxcar': lambda m: m.BoxcarFilter(w=3),
    'convolution': lambda m: m.ConvolutionFilter(
        kernel=np.random.RandomState(0).rand(3, 3)),
    'gaussian': lambda m: m.GaussianFilter(sigma=1.5),
    'nlmeans': lambda m: m.NLMeansFilter(r=1, f=1, sigma=1, h=1),
}


def _check_filter(name, ds_pair, mesh, jmesh, make=None):
    jds, tds = ds_pair
    make = make or FILTERS[name]
    talgo, jalgo = make(tfilters), make(jfilters)
    sharded = apply_sharded(talgo, tds, mesh=mesh)
    _bit_equal(sharded, talgo.apply(tds))
    jsharded = japply_sharded(jalgo, jds, mesh=jmesh)
    if isinstance(talgo, tfilters.NLMeansFilter):
        _close(sharded, jsharded, rtol=1e-5, atol=1e-6)
    else:
        _close(sharded, jsharded, **_conv_tol(tds, talgo))


@pytest.mark.parametrize('name', sorted(FILTERS))
def test_sharded_filter_equals_serial(mesh, jmesh, name):
    _check_filter(name, _pair({'y': 24, 'x': 32, 'time': 3}), mesh, jmesh)


def test_sharded_filter_non_divisible(mesh, jmesh):
    _check_filter('boxcar', _pair({'y': 21, 'x': 19, 'time': 2}), mesh,
                  jmesh, lambda m: m.BoxcarFilter(w=5))


@pytest.mark.parametrize('name', sorted(FILTERS))
def test_sharded_filter_on_a_2x2_mesh_non_divisible(mesh22, name):
    """The 2 x 2 mesh on a grid that divides neither axis: every block
    reads its corners."""
    jds, tds = _pair({'y': 23, 'x': 17, 'time': 2})
    algo = FILTERS[name](tfilters)
    _bit_equal(apply_sharded(algo, tds, mesh=mesh22), algo.apply(tds))


def test_one_dim_mesh(jmesh):
    m1 = get_mesh(shape=(8,), axis_names=('y',), devices=[CPU] * 8)
    jm1 = jget_mesh(shape=(8,), axis_names=('y',))
    _check_filter('boxcar', _pair({'y': 32, 'x': 16, 'time': 2}), m1, jm1)


def test_sharded_wrap_non_divisible_falls_back(mesh, jmesh):
    """Periodic halos cannot ride divisibility padding: wrap-mode filters
    on awkward sizes keep those axes whole and still equal serial."""
    _check_filter('boxcar', _pair({'y': 10, 'x': 11, 'time': 2}), mesh,
                  jmesh, lambda m: m.BoxcarFilter(w=3, mode='wrap'))


def test_sharded_constant_cval_forwarded(mesh, jmesh):
    _check_filter('boxcar', _pair({'y': 24, 'x': 32, 'time': 2}), mesh,
                  jmesh, lambda m: m.BoxcarFilter(w=3, mode='constant',
                                                  cval=2.5))


def test_apply_sharded_big_halo_small_axis(mesh, jmesh):
    """A filter whose halo (12) exceeds the y axis (10) runs sharded over
    x only, like serial."""
    _check_filter('gaussian', _pair({'y': 10, 'x': 64, 'time': 2}), mesh,
                  jmesh, lambda m: m.GaussianFilter(sigma=3.0))


def test_apply_sharded_dataarray_joint_filter(mesh, jmesh):
    from nd_tpu.core import DataArray as JDataArray
    rng = np.random.RandomState(0)
    for shape, dims in (((16, 24, 3), ('y', 'x', 'time')),
                        ((16, 24), ('y', 'x'))):
        vals = rng.rand(*shape)
        jda = JDataArray(vals, dims=dims, name='v')
        tda = DataArray(torch.from_numpy(vals.copy()), dims=dims, name='v',
                        device='cpu')
        talgo = tfilters.NLMeansFilter(dims=('y', 'x'), r=1, f=1,
                                       sigma=0.5, h=0.3)
        jalgo = jfilters.NLMeansFilter(dims=('y', 'x'), r=1, f=1,
                                       sigma=0.5, h=0.3)
        sharded = apply_sharded(talgo, tda, mesh=mesh)
        _bit_equal(sharded, talgo.apply(tda))
        _close(sharded, japply_sharded(jalgo, jda, mesh=jmesh), rtol=1e-5,
               atol=1e-6)


def test_apply_sharded_complex_input(mesh, jmesh):
    """A complex variable: the boxcar filters it as it is (re and im), the
    NLMeans filter disassembles it first, as Filter.apply does."""
    jds, tds = _pair({'y': 20, 'x': 24, 'time': 3})
    jds = jds.nd.as_complex()
    tds = tds.nd.as_complex()
    assert tds['C12'].data.is_complex()
    for name in ('boxcar', 'nlmeans'):
        talgo, jalgo = FILTERS[name](tfilters), FILTERS[name](jfilters)
        sharded = apply_sharded(talgo, tds, mesh=mesh)
        _bit_equal(sharded, talgo.apply(tds))
        tol = dict(rtol=1e-5, atol=1e-6) if name == 'nlmeans' \
            else dict(rtol=1e-13)
        _close(sharded, japply_sharded(jalgo, jds, mesh=jmesh), **tol)


@pytest.mark.parametrize('make', [
    lambda m: m.NLMeansFilter(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1,
                              sigma=2, h=3),
    lambda m: m.BoxcarFilter(dims=('y', 'x', 'time'), w=3),
], ids=['nlmeans_3d', 'boxcar_3d'])
def test_sharded_spatiotemporal_filters(mesh22, jmesh, make):
    """Three-axis windows (the long stack's 3-D NLMeans and the fused
    three-axis boxcar) in float32: y and x sharded with halos, time
    whole in each block."""
    jds, tds = _pair({'y': 24, 'x': 32, 'time': 6}, f32=True)
    _check_filter(None, (jds, tds), mesh22, jmesh, make)


# ---- the Pallas families of test_pallas_shard.py, through plain versions ----

@pytest.fixture
def seen_shapes(monkeypatch):
    """Records the array shapes each filter's kernel call saw (under the
    halo engine those are the padded blocks)."""
    seen = []
    for cls in (tfilters.ConvolutionFilter, tfilters.GaussianFilter,
                tfilters.NLMeansFilter):
        orig = cls._filter

        def record(self, arr, axes, _orig=orig):
            seen.append(tuple(arr.shape))
            return _orig(self, arr, axes)
        monkeypatch.setattr(cls, '_filter', record)
    return seen


def test_rowfused_conv_inside_shard_apply(mesh):
    """The 5 x 5 boxcar taps (the fused separable pass) run on each
    padded block and equal the unsharded convolution."""
    arr = np.random.RandomState(0).rand(32, 64).astype(np.float32)
    k = np.full((5, 5), 0.04, np.float32)

    def fn(x):
        return convolve(x, k, mode='reflect')
    out = shard_apply(fn, torch.from_numpy(arr), mesh,
                      {'y': (0, 2), 'x': (1, 2)}, mode='symmetric')
    assert torch.equal(out, fn(torch.from_numpy(arr)))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jconvolve(jnp.asarray(arr), jnp.asarray(k),
                                          mode='reflect')),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('dims,make', [
    ({'y': 24, 'x': 32, 'time': 3}, lambda m: m.BoxcarFilter(w=5)),
    ({'y': 40, 'x': 48, 'time': 2}, lambda m: m.GaussianFilter(sigma=1.5)),
    ({'y': 24, 'x': 32, 'time': 6},
     lambda m: m.BoxcarFilter(dims=('y', 'x', 'time'), w=3)),
    ({'y': 24, 'x': 32, 'time': 2},
     lambda m: m.NLMeansFilter(r=1, f=1, sigma=1.0, h=1.5)),
], ids=['boxcar', 'gaussian', 'spatiotemporal_boxcar', 'nlmeans'])
def test_sharded_kernel_families_float32(mesh, jmesh, seen_shapes, dims,
                                         make):
    jds, tds = _pair(dims, f32=True)
    talgo = make(tfilters)
    sharded = apply_sharded(talgo, tds, mesh=mesh)
    shapes = list(seen_shapes)
    assert shapes, 'the filter never ran under the halo engine'
    # the kernel saw padded BLOCKS, not the global (4 variables) array
    whole = 4 * int(np.prod(list(dims.values())))
    assert all(int(np.prod(s)) < whole for s in shapes), shapes
    seen_shapes.clear()
    _bit_equal(sharded, talgo.apply(tds))
    jsharded = japply_sharded(make(jfilters), jds, mesh=jmesh)
    if isinstance(talgo, tfilters.NLMeansFilter):
        _close(sharded, jsharded, rtol=1e-5, atol=1e-6)
    else:
        _close(sharded, jsharded, rtol=1e-6, atol=1e-7)


# ---- shard_dataset, change detection, reprojection --------------------------

def test_shard_dataset_blocks(mesh):
    _, tds = _pair({'y': 16, 'x': 16, 'time': 4})
    sharded = shard_dataset(tds, mesh)
    assert dict(sharded.mesh.shape) == {'y': 2, 'x': 4}
    assert len(sharded.blocks) == 8
    for pos, block in sharded.blocks.items():
        assert block.sizes == {'y': 8, 'x': 4, 'time': 4}
        index = sharded.index(pos)
        assert torch.equal(block['C11'].data,
                           tds['C11'].data[index['y'], index['x']])
    _bit_equal(sharded.stitch(sharded.blocks), tds)
    # a mesh axis that does not divide its dim shrinks to a divisor
    _, odd = _pair({'y': 9, 'x': 6, 'time': 2})
    assert dict(shard_dataset(odd, mesh).mesh.shape) == {'y': 1, 'x': 3}


def _sar_pair(dims):
    """tests/test_parallel.py's cube, with the backscatter tripled in the
    right half of the grid from the fourth date on (so that the maps hold
    changes)."""
    j, t = _pair(dims, mean=[1, 0, 0, 1], sigma=0.1)
    step = np.ones((dims['y'], dims['x'], dims['time']))
    step[:, dims['x'] // 2:, 3:] = 3.0
    for v in ('C11', 'C22'):
        vals = (np.abs(np.asarray(j[v].values)) + 0.5) * step
        j[v] = (j[v].dims, vals)
        t[v] = (t[v].dims, torch.from_numpy(vals.copy()))
    return j, t


@pytest.mark.parametrize('dims,kwargs', [
    ({'y': 16, 'x': 16, 'time': 6}, dict(alpha=0.9, n=9)),
    ({'y': 24, 'x': 24, 'time': 6}, dict(alpha=0.9, ml=3)),
], ids=['looks', 'multilook'])
def test_sharded_change_detection(mesh, jmesh, dims, kwargs):
    from nd_tpu.change import OmnibusTest as JOmnibusTest
    jds, tds = _sar_pair(dims)
    serial = ndt.OmnibusTest(**kwargs).apply(tds)
    sharded = sharded_change_detection(tds, mesh=mesh, **kwargs)
    _bit_equal(sharded, serial)
    assert int(sharded.data.sum()) > 0
    np.testing.assert_array_equal(
        sharded.values,
        np.asarray(jsharded_change(jds, mesh=jmesh, **kwargs).values))
    np.testing.assert_array_equal(
        sharded.values, np.asarray(JOmnibusTest(**kwargs).apply(jds).values))


def test_sharded_change_detection_non_divisible(mesh, mesh22):
    from nd_tpu.change import _omnibus_change_detection as jomnibus
    from nd_tpu_torch.change import _omnibus_change_detection
    jds, tds = _pair({'y': 13, 'x': 10, 'time': 5})
    serial = _omnibus_change_detection(tds, alpha=0.5)
    for m in (mesh, mesh22):
        sharded = sharded_change_detection(tds, alpha=0.5, mesh=m)
        assert sharded.shape == serial.shape
        _bit_equal(sharded, serial)
        for c in ('y', 'x', 'time'):
            np.testing.assert_array_equal(sharded[c].values,
                                          serial[c].values)
    np.testing.assert_array_equal(
        serial.values, np.asarray(jomnibus(jds, alpha=0.5).values))


def test_sharded_reproject_equals_serial(mesh):
    from nd_tpu.warp import reproject as jreproject
    # time=6 on 8 positions: the largest divisor (6)
    jds, tds = _pair({'y': 24, 'x': 30, 'time': 6})
    serial = ndt.reproject(tds, crs='epsg:3857')
    sharded = sharded_reproject(tds, mesh=mesh, crs='epsg:3857')
    assert dict(sharded.sizes) == dict(serial.sizes)
    for v in serial.data_vars:
        assert torch.equal(torch.nan_to_num(sharded[v].data, 7.0),
                           torch.nan_to_num(serial[v].data, 7.0)), v
    np.testing.assert_array_equal(sharded['time'].values,
                                  serial['time'].values)
    _close(sharded, jreproject(jds, crs='epsg:3857'), rtol=1e-12,
           atol=1e-12)


def test_engine_refuses_a_mesh_across_processes():
    from nd_tpu_torch.parallel.mesh import Mesh
    spanning = Mesh(np.array([[CPU], [CPU]], dtype=object), ('y', 'x'),
                    ranks=[[0], [1]])
    _, tds = _pair({'y': 8, 'x': 8, 'time': 2})
    with pytest.raises(ValueError, match='one process'):
        apply_sharded(tfilters.BoxcarFilter(w=3), tds, mesh=spanning)


# ---- the distributed helpers in one process ---------------------------------

def test_distributed_helpers_single_process(mesh, monkeypatch):
    from nd_tpu_torch.parallel import distributed as dist
    monkeypatch.setattr(dist, '_local_devices', [CPU] * 8)
    idx, count, _ = dist.process_info()
    assert idx == 0 and count == 1
    gmesh = dist.global_mesh()
    assert dict(gmesh.shape) == {'y': 1, 'x': 8}
    sl = dist.host_local_slices(gmesh, (32, 16), dims=('y', 'x'))
    assert sl == {'y': slice(0, 32), 'x': slice(0, 16)}
    local = np.random.RandomState(0).rand(32, 16).astype(np.float32)
    cube = dist.cube_from_process_tiles(local, gmesh, (32, 16))
    assert isinstance(cube, ShardedArray) and len(cube.blocks) == 8
    np.testing.assert_array_equal(cube.gather().numpy(), local)
    out = shard_apply(_stencil, cube, gmesh, {'y': (0, 1), 'x': (1, 1)})
    ref = _stencil(torch.from_numpy(local))
    for shard in out.addressable_shards:
        assert torch.equal(shard.data, ref[shard.index])


def test_host_local_slices_rejects_a_non_contiguous_layout():
    """Positions of process 0 on a diagonal: their bounding box would
    take rows and columns of process 1."""
    from nd_tpu_torch.parallel import distributed as dist
    from nd_tpu_torch.parallel.mesh import Mesh
    devices = np.empty((2, 2), dtype=object)
    devices[:] = [[CPU, CPU], [CPU, CPU]]
    diagonal = Mesh(devices, ('y', 'x'), ranks=[[0, 1], [1, 0]])
    with pytest.raises(ValueError, match='not contiguous'):
        dist.host_local_slices(diagonal, (8, 8))
    rows = Mesh(devices, ('y', 'x'), ranks=[[0, 0], [1, 1]])
    assert dist.host_local_slices(rows, (8, 6)) == {'y': slice(0, 4),
                                                    'x': slice(0, 6)}


def test_initialize_is_idempotent_and_warns(monkeypatch):
    import torch.distributed as tdist
    from nd_tpu_torch.parallel import distributed as dist
    calls = []
    monkeypatch.setattr(tdist, 'is_initialized', lambda: bool(calls))
    monkeypatch.setattr(tdist, 'init_process_group',
                        lambda *a, **k: calls.append((a, k)))
    dist.initialize('127.0.0.1:1234', num_processes=2, process_id=0)
    assert calls == [(('gloo',), dict(init_method='tcp://127.0.0.1:1234',
                                      world_size=2, rank=0))]
    dist.initialize()                      # silent, no second group
    with pytest.warns(RuntimeWarning, match='IGNORED'):
        dist.initialize('127.0.0.1:999', num_processes=2, process_id=1)
    assert len(calls) == 1


# ---- the sharded training step ----------------------------------------------

def _cube(ny=16, nx=32, k=6, seed=0):
    """tests/test_models.py's cube: a 3x backscatter step half-way."""
    rng = np.random.RandomState(seed)
    cube = np.abs(rng.normal(1.0, 0.2, size=(ny, nx, k, 4))) \
        .astype(np.float32)
    cube[..., 1] *= 0.05
    cube[..., 2] *= 0.05
    cube[:, :, k // 2:, 0] += 2.0
    cube[:, :, k // 2:, 3] += 2.0
    return cube


def _step_pair(alpha=0.9):
    from nd_tpu.models import SARChangePipeline as JPipeline
    jp = JPipeline(ml=3, alpha=alpha)
    tp = ndt.SARChangePipeline(ml=3, alpha=alpha)
    jparams = jp.init_params(0)
    return jp, tp, jparams, tp.params_from_jax(jparams, device='cpu')


def _same_step(got, ref):
    (p1, l1), (p2, l2) = got, ref
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for k in ('w', 'b'):
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(p2[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('labels', ['zeros', 'checker_masked'])
def test_sharded_step_matches_single_device(mesh, mesh22, jmesh, labels):
    jp, tp, jparams, tparams = _step_pair()
    cube = _cube()
    lab = np.zeros((16, 32), np.int32)
    if labels == 'checker_masked':
        lab = ((np.arange(16)[:, None] + np.arange(32)) % 2).astype(np.int32)
        lab[:2] = -1
        lab[:, -3:] = -1
    one = tp.train_step(tparams, torch.from_numpy(cube),
                        torch.from_numpy(lab))
    for m in (mesh, mesh22):
        _same_step(tp.train_step(tparams, torch.from_numpy(cube),
                                 torch.from_numpy(lab), mesh=m), one)
        step, ds_shard, lb_shard = tp.make_sharded_step(m)
        _same_step(step(tparams, ds_shard.place(cube),
                        lb_shard.place(lab)), one)
    # nd_tpu's sharded step, jitted over its mesh
    jstep, jds, jlb = jp.make_sharded_step(jmesh)
    jparams2, jloss = jstep(jparams, jax.device_put(jnp.asarray(cube), jds),
                            jax.device_put(jnp.asarray(lab), jlb))
    np.testing.assert_allclose(float(one[1]), float(jloss), rtol=1e-5)
    for k in ('w', 'b'):
        np.testing.assert_allclose(one[0][k].numpy(),
                                   np.asarray(jparams2[k]), rtol=1e-4,
                                   atol=1e-6)


def test_make_sharded_step_non_divisible_grid(mesh):
    """make_sharded_step(shape=...) fits the mesh to divisor counts so a
    17 x 19 grid is placed instead of refused; train_step(mesh=) on the
    global tensors pads instead."""
    _, tp, _, tparams = _step_pair(alpha=0.99)
    rng = np.random.RandomState(0)
    cube = np.abs(rng.rand(17, 19, 6, 4)).astype(np.float32) + 0.1
    labels = rng.randint(0, 2, size=(17, 19))
    step, ds_shard, lb_shard = tp.make_sharded_step(mesh,
                                                    shape=cube.shape[:2])
    assert dict(ds_shard.mesh.shape) == {'y': 1, 'x': 1}
    with pytest.raises(ValueError, match='does not divide'):
        tp.make_sharded_step(mesh)[1].place(cube)
    ref = tp.train_step(tparams, torch.from_numpy(cube),
                        torch.from_numpy(labels))
    _same_step(step(tparams, ds_shard.place(cube), lb_shard.place(labels)),
               ref)
    _same_step(tp.train_step(tparams, torch.from_numpy(cube),
                             torch.from_numpy(labels), mesh=mesh), ref)
    # a grid that divides one axis: 18 x 19 on 2 x 4 -> (2, 1)
    step2, ds2, lb2 = tp.make_sharded_step(mesh, shape=(18, 19))
    assert dict(ds2.mesh.shape) == {'y': 2, 'x': 1}
    cube2 = np.abs(rng.rand(18, 19, 6, 4)).astype(np.float32) + 0.1
    labels2 = rng.randint(-1, 2, size=(18, 19))
    _same_step(step2(tparams, ds2.place(cube2), lb2.place(labels2)),
               tp.train_step(tparams, torch.from_numpy(cube2),
                             torch.from_numpy(labels2)))


def test_sharded_multilook_equals_multilook(mesh):
    """The block kernel is multilook itself: the stitched blocks equal
    the one-device multilook bit for bit."""
    tp = ndt.SARChangePipeline(ml=3)
    cube = torch.from_numpy(_cube(17, 23))
    looked = tp._sharded_multilook(cube, mesh)
    assert len(looked.blocks) == 8
    assert torch.equal(looked.gather(), ndt.multilook(cube, 3))


def test_limits_of_a_mesh_across_processes():
    """What the port refuses where the JAX package pads or replicates: a
    cube split across processes must divide the mesh, and such a mesh
    replicates no axis (ROADMAP section 3)."""
    from nd_tpu_torch.parallel import distributed as dist
    from nd_tpu_torch.parallel.halo import place
    from nd_tpu_torch.parallel.mesh import Mesh
    devices = np.empty((2, 2), dtype=object)
    devices[:] = [[CPU, CPU], [CPU, CPU]]
    rows = Mesh(devices, ('y', 'x'), ranks=[[0, 0], [1, 1]])
    with pytest.raises(ValueError, match='does not divide'):
        dist.cube_from_process_tiles(np.zeros((5, 6)), rows, (9, 6))
    with pytest.raises(ValueError, match='replicates no axis'):
        place(torch.zeros(8, 6), rows, ('y', None), (4, 6))
    cube = dist.cube_from_process_tiles(np.zeros((4, 6)), rows, (8, 6))
    with pytest.raises(ValueError, match='split over'):
        shard_apply(lambda x: x, cube, rows, {'y': (0, 1)})
