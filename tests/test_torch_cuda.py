"""nd_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor nd_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: sepconv (two and three axes) max abs diff <= 1e-6 max|x|
(1e-13 in float64), and 0 for the tiled kernel against its plain version
(the same operations in the same order), long taps included; NLMeans
(spatial and 3-D windows, the ring and the wide-window kernel) rtol
1e-5, atol 1e-6 (float64:
rtol 1e-12; float16 in and out: rtol 1e-3, atol 1e-3, one float16
rounding of results that agree in float32); the round kernel's flags
and margins exactly equal to its plain version (margins compared as
int32; the same f32 operations in the same order), and a flag mismatch
rate <= 1e-5 in the older uncapped checks; the long-series scan's flags
and margins exactly equal to its plain version; exact and pipeline
change maps exactly equal, against the plain float64 'mixed' scan
(``change_detection_plain``); the rescan kernels' packed flags exactly
equal to their plain versions for 'mixed' and 'float64' statistics, a
mismatch rate <= 1e-5 for 'float32'; the streaming probe exactly x + 1;
the georeferencing layer against the same port functions on the CPU:
gathers and matmuls rtol 1e-5, atol 1e-6 (the matmul also within 1e-5
of the float64 product with TF32 switched on by the caller), nearest
exact, the footprint median rtol 1e-6, coregistration shifts equal;
the training path against the CPU: change probabilities atol 2e-5
(float32: z rounds in float32 with the card's log and fused
multiply-adds; 5.7e-6 measured) and 1e-9 (float64: the card's
incomplete gamma function differs from the CPU's by about 4e-10),
chi-square CDFs atol 5e-6 and 1e-9, features rtol 1e-5 /
atol 1e-5, losses rtol 1e-5, head and classifier parameters rtol 1e-4 /
atol 1e-6, predictions equal, checkpoints bit for bit; the stencil
kernel (non-separable convolution) max abs diff 0 to its plain version,
and the card's non-separable ``convolve`` equal to the CPU's; ``njobs=4``
equal to ``njobs=1``; the grouped reductions and gap filling on the card
within rtol 1e-6, atol 1e-6 of the CPU's; ``apply``'s vmap route within
rtol 1e-12 of the CPU's; the I/O's reads onto the card bit-equal to what
was written and to the same read onto the CPU, and the quick start from
a file: NLMeans rtol 1e-5, atol 1e-6 of the CPU's, the change map equal
to the CPU's omnibus of the card's filtered values; the device mesh (a
(2, 2) mesh naming the card four times): sharded convolutions equal to
the unsharded apply, NLMeans rtol 1e-5, atol 1e-6, change maps equal,
the sharded training step's loss rtol 1e-6 and parameters rtol 1e-5 /
atol 1e-7 of the one-device step.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

import nd_tpu_torch as ndt
from nd_tpu_torch import _build, warp as twarp
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.core import Dataset, from_jax_dataset
from nd_tpu_torch.ops import change_cuda, change_mixed_cuda, \
    change_scan_cuda, conv_cuda, nlmeans_cuda, stream_cuda
from nd_tpu_torch.ops import fft as tfft, interp as tinterp
from nd_tpu_torch.ops.conv import gaussian_kernel1d
from nd_tpu_torch.testing import generate_test_dataset
from torch_cubes import cuda, long_stack_cube, sar_cube  # noqa: F401

pytestmark = pytest.mark.cuda

MODES = ['reflect', 'mirror', 'nearest', 'constant', 'wrap']


def _data(shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(*shape))


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_sepconv_kernel_matches_plain(cuda, mode, dtype):
    a = _data((3, 33, 70, 5), seed=10).to(cuda, dtype)
    t0 = np.array([0.2, 0.5, 0.3])
    t1 = np.ones(5) / 5
    before = conv_cuda.launches
    got = conv_cuda.sepconv2(a, t0, t1, mode=mode, cval=0.5)
    assert conv_cuda.launches == before + 1
    ref = conv_cuda.sepconv2_plain(a, t0, t1, mode=mode, cval=0.5)
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    assert float((got - ref).abs().max()) <= tol * float(a.abs().max())


@pytest.mark.parametrize('nv', [1, 4, 6])
@pytest.mark.parametrize('rf', [(1, 1), (2, 2), (2, 1)])
@pytest.mark.parametrize('n_eff', [-1.0, 4.0])
def test_nlmeans_kernel_matches_plain(cuda, nv, rf, n_eff):
    r, f = rf
    a = _data((21, 37, 3, nv), seed=7).to(cuda, torch.float32)
    before = nlmeans_cuda.launches
    got = nlmeans_cuda.nlmeans_spatial(a, (r, r), (f, f), 2.0, 3.0, n_eff)
    assert nlmeans_cuda.launches == before + 1
    ref = nlmeans_cuda.nlmeans_spatial_plain(a, (r, r), (f, f), 2.0, 3.0,
                                             n_eff)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, equal_nan=True, rtol=1e-5,
                               atol=1e-6)


def test_nlmeans_kernel_float64(cuda):
    a = _data((17, 19, 2, 4), seed=8).to(cuda)
    got = nlmeans_cuda.nlmeans_spatial(a, (2, 1), (1, 1), 0.3, 0.4)
    ref = nlmeans_cuda.nlmeans_spatial_plain(a, (2, 1), (1, 1), 0.3, 0.4)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize('k', [12, 40])
@pytest.mark.parametrize('with_margin', [False, True])
def test_omnibus_kernel_matches_plain(cuda, k, with_margin):
    cube = torch.from_numpy(sar_cube(37, 53, k, seed=5)).to(cuda)
    cap = change_cuda._round_cap(k) if with_margin else None
    before = change_cuda.launches
    got = change_cuda.change_detection_fast(
        cube, 0.99, n=9, return_margin=with_margin, return_packed=True,
        max_rounds=cap)
    assert change_cuda.launches == before + 1
    c_tab, s_tab = change_cuda.omnibus_tables(k, 9, 0.99)
    rounds = cap if with_margin else k - 1
    ref = change_cuda.omnibus_plain(cube, c_tab, s_tab, 9.0, rounds,
                                    with_margin)
    torch.cuda.synchronize()
    gp = got[0] if with_margin else got
    mismatch = change_cuda.unpack_flags(gp, k) \
        != change_cuda.unpack_flags(ref[0], k)
    assert float(mismatch.float().mean()) <= 1e-5
    if with_margin:
        gm, rm = got[1].cpu().numpy(), ref[1].cpu().numpy()
        np.testing.assert_array_equal(np.isneginf(gm), np.isneginf(rm))
        fin = np.isfinite(rm) & np.isfinite(gm)
        assert np.all(np.abs(gm[fin] - rm[fin])
                      <= 1e-4 * np.maximum(1.0, np.abs(rm[fin])))


def test_exact_on_the_card_equals_plain_mixed(cuda):
    cube = torch.from_numpy(sar_cube(64, 96, 12, seed=16)).to(cuda)
    change_mixed_cuda.reset_launches()
    got, count = tchange.change_detection_exact(cube, 0.99, n=9,
                                                return_count=True)
    assert count > 0 and change_mixed_cuda.launches == 1   # the rescan
    ref = tchange.change_detection_plain(cube, 0.99, n=9)
    assert got.device.type == 'cuda'
    assert bool((got == ref).all())
    # change_detection on the card is the rescan kernel over every pixel
    assert bool((tchange.change_detection(cube, 0.99, n=9) == ref).all())
    assert change_mixed_cuda.launches == 2


def test_pipeline_on_the_card_matches_cpu(cuda):
    cube = torch.from_numpy(sar_cube(40, 64, 12, seed=26, special=False))
    model = ndt.SARChangePipeline(ml=3, n=1, alpha=0.5)
    got = model(cube.to(cuda))
    assert got.device.type == 'cuda'
    assert bool((got.cpu() == model(cube)).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    t = np.ones(3)
    with pytest.raises(ValueError, match='contiguous'):
        conv_cuda.sepconv2(torch.zeros(1, 4, 6, 2, device=cuda)
                           .transpose(1, 2), t, t)
    with pytest.raises(TypeError):
        nlmeans_cuda.nlmeans_spatial(
            torch.zeros(5, 5, 1, 1, device=cuda, dtype=torch.int32),
            (1, 1), (1, 1), 1.0, 1.0)
    with pytest.raises(ValueError):
        change_cuda.change_detection_fast(
            torch.zeros(4, 4, 300, 4, device=cuda), 0.9)


def test_kernels_build_and_count_on_the_card(cuda):
    info = _build.build_info()
    assert os.path.exists(info['path'])
    for mod in (conv_cuda, nlmeans_cuda, change_cuda):
        mod.reset_launches()
    cube = torch.from_numpy(sar_cube(32, 40, 12, seed=33)).to(cuda)
    ndt.SARChangePipeline()(cube)
    nlmeans_cuda.nlmeans_spatial(cube, (1, 1), (1, 1), 2.0, 3.0)
    assert conv_cuda.launches > 0 and nlmeans_cuda.launches > 0 \
        and change_cuda.launches > 0


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', [(13, 17, 9, 2), (37, 21, 45, 1)])
def test_sepconv3_kernel_matches_plain(cuda, mode, dtype, shape):
    # the second shape spans several output tiles and row chunks, with
    # Gaussian taps up to 17 wide
    a = _data(shape, seed=11).to(cuda, dtype)
    if shape[2] < 10:
        t0 = np.array([0.2, 0.5, 0.3])
        t1 = np.ones(5) / 5
        t2 = np.array([0.1, 0.2, 0.4, 0.2, 0.1, 0.05, 0.05])
    else:
        t0, t1, t2 = (gaussian_kernel1d(s) for s in (2.0, 1.0, 1.5))
    before = conv_cuda.launches3
    got = conv_cuda.sepconv3(a, t0, t1, t2, mode=mode, cval=0.5)
    assert conv_cuda.launches3 == before + 1
    ref = conv_cuda.sepconv3_plain(a, t0, t1, t2, mode=mode, cval=0.5)
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    assert float((got - ref).abs().max()) <= tol * float(a.abs().max())


@pytest.mark.parametrize('nv', [1, 4, 6])
@pytest.mark.parametrize('r,f', [((2, 2, 1), (1, 1, 1)),
                                 ((0, 0, 2), (1, 1, 0)),
                                 ((1, 0, 1), (0, 1, 1)),
                                 ((1, 1, 1), (3, 8, 3)),    # the ring's
                                 ((2, 3, 2), (3, 2, 3))])   # largest f
def test_nlmeans_3d_kernel_matches_plain(cuda, nv, r, f):
    a = _data((15, 19, 6, nv), seed=12).to(cuda, torch.float32)
    before = nlmeans_cuda.launches_3d
    got = nlmeans_cuda.nlmeans_3d(a, r, f, 2.0, 3.0)
    assert nlmeans_cuda.launches_3d == before + 1
    ref = nlmeans_cuda.nlmeans_3d_plain(a, r, f, 2.0, 3.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_nlmeans_3d_kernel_float64_and_n_eff(cuda):
    a = _data((11, 13, 5, 4), seed=13).to(cuda)
    got = nlmeans_cuda.nlmeans_3d(a, (1, 2, 1), (1, 1, 1), 0.3, 0.4, 4.0)
    ref = nlmeans_cuda.nlmeans_3d_plain(a, (1, 2, 1), (1, 1, 1), 0.3, 0.4,
                                        4.0)
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-13,
                               equal_nan=True)


SCAN_KS = [3, 4, 16, 31, 32, 33, 48, 49, 56, 64, 65, 128, 200, 255, 256]


def _scan_cube(ny, nx, k, seed):
    """A scan input with the bursty column, zero determinants (pixel
    (3, 4), every third step up to 12), negative ones (pixel (4, 5), every
    other step), the NaN and constant pixels of ``sar_cube`` (on cubes
    large enough to hold them)."""
    big = ny * nx > 40
    cube = sar_cube(ny, nx, k, seed=seed, special=big)
    if nx > 1:
        cube[:, 0] = long_stack_cube(ny, 1, k, seed=seed)[:, 0]
    if big:
        cube[3, 4, 0:12:3] = (1.0, 1.0, 0.0, 1.0)
        cube[4, 5, 1::2, 1] = 3.0
    return np.ascontiguousarray(cube)


def _scan_tables(k):
    """scan_tables(k, 9, 0.99); for the short series whose polynomial
    fit is infeasible, k=16's fit with its global tables cut to k (the
    kernel and its plain version take the same tables either way)."""
    tabs = change_scan_cuda.scan_tables(k, 9, 0.99)
    if tabs is None:
        base = change_scan_cuda.scan_tables(16, 9, 0.99)
        tabs = dict(base, cg_tab=base['cg_tab'][:k + 1],
                    sg_tab=base['sg_tab'][:k + 1])
    return tabs


def _assert_scan_equal(got, ref):
    (gp, gm), (rp, rm) = got, ref
    assert bool((gp == rp).all())
    # margins bit for bit, NaN where NaN
    assert bool((gm.view(torch.int32) == rm.view(torch.int32)).all())


@pytest.mark.parametrize('k', SCAN_KS)
@pytest.mark.parametrize('shape', [(37, 53), (1, 1)])
def test_scan_kernel_matches_plain(cuda, k, shape):
    cube = torch.from_numpy(_scan_cube(*shape, k, seed=14 + k)).to(cuda)
    tabs = _scan_tables(k)
    before = change_scan_cuda.launches
    got = change_scan_cuda.scan_kernel(cube, tabs, 9.0)
    assert change_scan_cuda.launches == before + 1
    ref = change_scan_cuda.scan_plain(cube, tabs, 9.0)
    torch.cuda.synchronize()
    _assert_scan_equal(got, ref)
    if shape != (1, 1):
        assert float(torch.isfinite(ref[1]).float().mean()) > 0.5
    if change_scan_cuda.scan_tables(k, 9, 0.99) is not None:
        packed, margin = change_scan_cuda.change_detection_scan(
            cube, 0.99, n=9, return_packed=True)
        _assert_scan_equal((packed, margin), ref)


@pytest.mark.parametrize('k', [16, 56, 200])
def test_every_scan_plan_is_bit_equal(cuda, k):
    cube = torch.from_numpy(_scan_cube(37, 53, k, seed=60 + k)).to(cuda)
    tabs = _scan_tables(k)
    ref = change_scan_cuda.scan_plain(cube, tabs, 9.0)
    plans = change_scan_cuda.plan_candidates(k, 37 * 53)
    assert len(plans) >= 20
    for plan in plans:
        got = change_scan_cuda.scan_kernel(cube, tabs, 9.0, plan)
        torch.cuda.synchronize()
        _assert_scan_equal(got, ref)


def test_scan_plan_shared_memory_matches_the_kernel(cuda):
    lib = _build.library()
    fn = lib.nd_omnibus_scan_smem
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 4
    for k in (3, 56, 200, 256):
        for plan in change_scan_cuda.plan_candidates(k, 1 << 20):
            assert fn(k, plan['threads'], plan['T'],
                      plan['nbuf']) == plan['smem']


def test_exact_long_series_on_the_card_equals_plain_mixed(cuda):
    cube = torch.from_numpy(long_stack_cube(24, 40, 56, seed=15)).to(cuda)
    change_scan_cuda.reset_launches()
    got, count = tchange.change_detection_exact(cube, 0.99, n=9,
                                                return_count=True)
    assert change_scan_cuda.launches == 1
    ref = tchange.change_detection_plain(cube, 0.99, n=9)
    assert got.device.type == 'cuda' and bool((got == ref).all())
    assert bool(ref.any()) and 0 <= count < 24 * 40


@pytest.mark.parametrize('k,alpha', [(300, 0.99), (56, 1e-12)])
def test_exact_without_a_kernel_route_on_the_card(cuda, k, alpha):
    cube = torch.from_numpy(long_stack_cube(4, 6, k, seed=16)).to(cuda)
    for mod in (change_cuda, change_scan_cuda, change_mixed_cuda):
        mod.reset_launches()
    got = tchange.change_detection_exact(cube, alpha, n=9)
    assert change_cuda.launches == 0 and change_scan_cuda.launches == 0
    assert change_mixed_cuda.launches == 1        # the full-grid scan
    ref = tchange.change_detection_plain(cube, alpha, n=9)
    assert bool((got == ref).all())


def test_long_stack_filters_launch_their_kernels(cuda):
    cube = torch.from_numpy(long_stack_cube(16, 20, 56, seed=17)).to(cuda)
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(('C11', 'C12__re', 'C12__im',
                                         'C22'))})
    for mod in (conv_cuda, nlmeans_cuda, change_cuda, change_scan_cuda):
        mod.reset_launches()
    flt = ndt.NLMeansFilter(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1,
                            sigma=2, h=3).apply(ds)
    change = ndt.OmnibusTest(ml=3, alpha=0.99).apply(flt)
    smooth = ndt.GaussianFilter(dims=('y', 'x', 'time'), sigma=1).apply(
        ds['C11'])
    box = ndt.BoxcarFilter(dims=('y', 'x', 'time'), w=3).apply(ds['C11'])
    assert nlmeans_cuda.launches_3d == 1 and nlmeans_cuda.launches == 0
    assert change_scan_cuda.launches == 1 and change_cuda.launches == 0
    assert conv_cuda.launches3 == 2 and conv_cuda.launches == 1
    assert change.data.device.type == 'cuda' and bool(change.data.any())
    for out in (smooth, box):
        assert out.dims == ('y', 'x', 'time')
        assert bool(torch.isfinite(out.data).all())


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    t = np.ones(3)
    with pytest.raises(ValueError, match='too long'):
        change_scan_cuda.change_detection_scan(
            torch.zeros(4, 4, 257, 4, device=cuda), 0.9)
    with pytest.raises(ValueError, match='contiguous'):
        conv_cuda.sepconv3(torch.zeros(4, 5, 6, 2, device=cuda)
                           .transpose(0, 1), t, t, t)
    with pytest.raises(ValueError, match='contiguous'):
        nlmeans_cuda.nlmeans_3d(torch.zeros(6, 7, 5, 2, device=cuda)
                                .transpose(0, 1), (1, 1, 1), (1, 1, 1),
                                1.0, 1.0)
    with pytest.raises(TypeError):
        nlmeans_cuda.nlmeans_3d(
            torch.zeros(5, 5, 5, 1, device=cuda, dtype=torch.int32),
            (1, 1, 1), (1, 1, 1), 1.0, 1.0)


# ---- the ring NLMeans and the tiled sepconv kernels -----------------------

# the windows of the ring kernel's builds: spatial r=2/f=1, r=1/f=1,
# r=2/f=2 (float32, nv = 4: radii fixed at compile time), (y, x, t), and
# the generic build's (time,) and (x, time) windows
RING_WINDOWS = {'spatial': ((2, 2, 0), (1, 1, 0)),
                'spatial_r1': ((1, 1, 0), (1, 1, 0)),
                'spatial_f2': ((2, 2, 0), (2, 2, 0)),
                '3d': ((2, 2, 1), (1, 1, 1)),
                'time': ((0, 0, 2), (0, 0, 1)),
                'x_time': ((0, 2, 1), (0, 1, 1))}


@pytest.mark.parametrize('nv', [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('window', list(RING_WINDOWS))
def test_tiled_nlmeans_matches_plain(cuda, nv, dtype, window):
    # ragged tiles: 37 x 53 fits no tile shape
    a = _data((37, 53, 5, nv), seed=20 + nv).to(cuda, dtype)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=1e-12, atol=1e-13)
    r, f = RING_WINDOWS[window]
    assert nlmeans_cuda._tile_plan(a.shape, r, f, a.element_size())[
        'route'] == 'ring'
    for n_eff in (-1.0, 4.0):
        if r[2] == f[2] == 0:
            got = nlmeans_cuda.nlmeans_spatial(a, r[:2], f[:2], 0.3, 0.4,
                                               n_eff)
            ref = nlmeans_cuda.nlmeans_spatial_plain(a, r[:2], f[:2], 0.3,
                                                     0.4, n_eff)
        else:
            got = nlmeans_cuda.nlmeans_3d(a, r, f, 0.3, 0.4, n_eff)
            ref = nlmeans_cuda.nlmeans_3d_plain(a, r, f, 0.3, 0.4, n_eff)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, equal_nan=True, **tol)


RING_COUNT_CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from nd_tpu_torch import tracing
from nd_tpu_torch.ops import nlmeans_cuda
shape, r, f = json.loads(sys.argv[2])
a = torch.rand(shape, device='cuda')
run = nlmeans_cuda.nlmeans_spatial if len(r) == 2 else nlmeans_cuda.nlmeans_3d
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    out = run(a, r, f, 2.0, 3.0)
    torch.cuda.synchronize()
    counts = tracing.counters()
print(json.dumps(dict(counts, finite=bool(torch.isfinite(out).all()))))
"""


@pytest.mark.parametrize('shape,r,f', [((4096, 4096, 12, 4), (2, 2), (1, 1)),
                                       ((1024, 1024, 56, 4), (2, 2, 1),
                                        (1, 1, 1))])
def test_nlmeans_chain_shapes_take_the_ring_route(cuda, shape, r, f):
    # the two chains' tiles: every output on the ring route, counted while
    # a profiler records (in a process of its own: earlier profiler
    # windows of a process can lose later kernel events)
    import json
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', RING_COUNT_CHILD, root,
                           json.dumps([shape, r, f])],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    counts = json.loads(proc.stdout.strip().splitlines()[-1])
    assert counts['nlmeans.outputs'] == shape[0] * shape[1] * shape[2]
    assert counts['nlmeans.outputs_ring'] == counts['nlmeans.outputs']
    assert counts['finite']


@pytest.mark.parametrize('r,f', [((2, 2, 1), (1, 1, 1)),
                                 ((1, 2, 0), (2, 1, 0)),
                                 ((0, 1, 2), (1, 0, 1))])
def test_tiled_nlmeans_dims_of_exactly_r_plus_f_plus_one(cuda, r, f):
    shape = tuple(ri + fi + 1 for ri, fi in zip(r, f)) + (4,)
    a = _data(shape, seed=27).to(cuda, torch.float32)
    got = nlmeans_cuda.nlmeans_3d(a, r, f, 0.5, 0.7)
    ref = nlmeans_cuda.nlmeans_3d_plain(a, r, f, 0.5, 0.7)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def _sep_cases():
    g = gaussian_kernel1d(1.0)
    w64 = np.linspace(0.1, 1.0, 64)
    return {
        'one-axis': (np.array([0.2, 0.5, 0.3]), np.ones(1), None),
        'two-axis': (np.ones(3) / 9, np.ones(3), None),
        'gaussian': (g, g, None),
        '64 taps': (w64, w64[::-1].copy(), None),
        'three-axis': (g, np.ones(3) / 3, np.array([0.25, 0.5, 0.25])),
        'three-axis 64 taps': (np.ones(3), w64, w64),
        'one tap': (np.ones(1) * 0.5, np.ones(1), np.ones(1) * 2.0),
    }


@pytest.mark.parametrize('case', sorted(_sep_cases()))
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_tiled_sepconv_is_bit_equal_to_plain(cuda, case, mode, dtype):
    t0, t1, t2 = _sep_cases()[case]
    if t2 is None:
        # the two-axis entry point, outer > 1 (the stacked layout)
        a = _data((4, 37, 53, 7), seed=30).to(cuda, dtype)
        before = conv_cuda.launches
        got = conv_cuda.sepconv2(a, t0, t1, mode=mode, cval=0.5)
        assert conv_cuda.launches == before + 1
        ref = conv_cuda.sepconv2_plain(a, t0, t1, mode=mode, cval=0.5)
    else:
        a = _data((37, 53, 9, 2), seed=31).to(cuda, dtype)
        before = conv_cuda.launches3
        got = conv_cuda.sepconv3(a, t0, t1, t2, mode=mode, cval=0.5)
        assert conv_cuda.launches3 == before + 1
        ref = conv_cuda.sepconv3_plain(a, t0, t1, t2, mode=mode, cval=0.5)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) == 0.0


def test_tiled_sepconv_unaligned_rows_and_pointers(cuda):
    # odd row lengths and a view that starts off a 16-byte boundary take
    # the element-wise copies
    base = _data((1 + 3 * 31 * 29 * 5,), seed=32).to(cuda, torch.float32)
    a = base[1:].reshape(3, 31, 29, 5)
    t = np.array([0.25, 0.5, 0.25])
    for mode in MODES:
        got = conv_cuda.sepconv2(a, t, t, mode=mode, cval=1.5)
        ref = conv_cuda.sepconv2_plain(a, t, t, mode=mode, cval=1.5)
        assert float((got - ref).abs().max()) == 0.0


class _DuckDataset:
    """The JAX package's Dataset surface, read by from_jax_dataset."""

    class _Var:
        def __init__(self, dims, values):
            self.dims, self.values, self.attrs = dims, values, {}

    def __init__(self, cube):
        self.attrs = {'source': 'test'}
        self._vars = {v: self._Var(('y', 'x', 'time'), cube[..., i])
                      for i, v in enumerate(('C11', 'C12__re', 'C12__im',
                                             'C22'))}
        self.data_vars = list(self._vars)
        self.coords = {'time': self._Var(('time',),
                                         np.arange(cube.shape[2]))}

    def __getitem__(self, key):
        return self._vars[key]


def test_numpy_input_lands_on_the_card_by_default(cuda):
    cube = sar_cube(16, 20, 12, seed=33, special=False)
    ds = Dataset({'C11': (('y', 'x', 'time'), cube[..., 0])})
    assert ds['C11'].data.device.type == 'cuda'
    jds = from_jax_dataset(_DuckDataset(cube))
    assert all(jds[v].data.device.type == 'cuda' for v in jds.data_vars)
    nlmeans_cuda.reset_launches()
    flt = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3).apply(
        jds)
    change = ndt.OmnibusTest(ml=3, alpha=0.01).apply(flt)
    assert nlmeans_cuda.launches == 1 and change.data.device.type == 'cuda'
    assert tchange.change_detection(cube, 0.99, n=9).device.type == 'cuda'
    assert from_jax_dataset(_DuckDataset(cube), device='cpu')['C11'] \
        .data.device.type == 'cpu'


# ---- the rescan kernel and the streaming probe ------------------------------

def _mixed_rows(k, seed, n=200):
    """Gathered series with the bursty column (every 20th row; its
    backscatter alternates every 3 steps, every k // 16 for long series,
    which keeps the plain scan's rounds few), exact zero, negative and
    NaN determinants and a constant series."""
    rows = sar_cube(10, 20, k, seed=seed, special=False)
    rows[:, 0] = long_stack_cube(10, 1, k, seed=seed)[:, 0]
    wave = np.where((np.arange(k) // max(3, k // 16)) % 2 == 0, 1.0, 5.0)
    rows[:, 0, :, 0] = wave
    rows[:, 0, :, 3] = wave
    rows = rows.reshape(-1, k, 4)[:n].copy()
    rows[1, 0:12:3] = (1.0, 1.0, 0.0, 1.0)
    rows[2, 1::2, 1] = 3.0
    rows[3, k // 2, 0] = np.nan
    rows[4] = rows[4, 0]
    return rows


def _check_mixed(rows, alpha, n, mode):
    before = change_mixed_cuda.launches
    got = change_mixed_cuda.mixed_scan(rows, alpha, n, mode)
    assert change_mixed_cuda.launches == before + 1
    ref = change_mixed_cuda.mixed_scan_plain(rows, alpha, n, mode)
    torch.cuda.synchronize()
    k = rows.shape[1]
    assert got.shape == ref.shape == ((k + 30) // 31, rows.shape[0])
    mism = change_cuda.unpack_flags(got, k) != change_cuda.unpack_flags(ref, k)
    if mode == 'float32':
        assert float(mism.float().mean()) <= 1e-5
    else:
        assert bool((got == ref).all())
    return ref


@pytest.mark.parametrize('k', [2, 12, 48, 56, 200, 300])
@pytest.mark.parametrize('dtype,mode', [(torch.float32, 'mixed'),
                                        (torch.float64, 'mixed'),
                                        (torch.float32, 'float64'),
                                        (torch.float32, 'float32')])
def test_mixed_scan_kernel_matches_plain(cuda, k, dtype, mode):
    rows = torch.from_numpy(_mixed_rows(k, seed=40 + k, n=197)).to(cuda,
                                                                   dtype)
    ref = _check_mixed(rows, 0.99, 9, mode)
    assert bool(ref.any())


@pytest.mark.parametrize('nrows', [1, 33, 200])
@pytest.mark.parametrize('alpha,n', [(0.99, 9), (1e-12, 9), (0.99, 0.5)])
def test_mixed_scan_kernel_far_tails_and_unfolded(cuda, nrows, alpha, n):
    rows = torch.from_numpy(_mixed_rows(56, seed=50)).to(cuda)
    _check_mixed(rows[:nrows], alpha, n, 'mixed')
    _check_mixed(rows[:nrows].double(), alpha, n, 'float64')


def test_mixed_scan_raises_on_what_it_does_not_take(cuda):
    rows = torch.zeros(5, 12, 4, device=cuda)
    with pytest.raises(ValueError, match='CUDA'):
        change_mixed_cuda.mixed_scan(rows.cpu(), 0.9, 9)
    with pytest.raises(TypeError):
        change_mixed_cuda.mixed_scan(rows.half(), 0.9, 9)
    with pytest.raises(ValueError, match='contiguous'):
        change_mixed_cuda.mixed_scan(
            torch.zeros(12, 5, 4, device=cuda).transpose(0, 1), 0.9, 9)
    with pytest.raises(ValueError, match='N, k, 4'):
        change_mixed_cuda.mixed_scan(torch.zeros(5, 12, 3, device=cuda),
                                     0.9, 9)
    empty = change_mixed_cuda.mixed_scan(rows[:0], 0.9, 9)
    assert empty.shape == (1, 0)


def test_float32_statistics_take_the_kernels_on_the_card(cuda):
    short = torch.from_numpy(sar_cube(24, 40, 12, seed=51)).to(cuda)
    for mod in (change_cuda, change_mixed_cuda):
        mod.reset_launches()
    got = tchange.change_detection(short, 0.99, n=9, stat_dtype='float32')
    assert change_cuda.launches == 1 and change_mixed_cuda.launches == 0
    assert bool((got == change_cuda.change_detection_fast(short, 0.99,
                                                          n=9)).all())
    long = torch.from_numpy(long_stack_cube(8, 12, 56, seed=52)).to(cuda)
    got = tchange.change_detection(long, 0.99, n=9, stat_dtype='float32')
    assert change_mixed_cuda.launches == 1
    ref = tchange.change_detection_plain(long, 0.99, n=9,
                                         stat_dtype='float32')
    assert float((got != ref).float().mean()) <= 1e-5


@pytest.mark.parametrize('m', [1, 7, 8, 9, 1000, 49152])
def test_stream_probe_matches_plain(cuda, m):
    x = _data((m, 1024), seed=53).to(cuda, torch.float32)
    before = stream_cuda.launches
    for _ in range(2):         # the second call takes the cached grid
        got = stream_cuda.stream_plus_one(x)
        torch.cuda.synchronize()
        assert bool((got == stream_cuda.stream_plus_one_plain(x)).all())
    assert stream_cuda.launches == before + 2
    unaligned = torch.zeros(m * 1024 + 1, device=cuda)[1:].reshape(m, 1024)
    with pytest.raises(ValueError, match='aligned'):
        stream_cuda.stream_plus_one(unaligned)


# ---- the redesigned round and rescan kernels, the repaired routes ----------

def _assert_round_equal(got, ref, with_margin):
    assert bool((got[0] == ref[0]).all())
    if with_margin:
        assert bool((got[1].view(torch.int32) == ref[1].view(torch.int32))
                    .all())


@pytest.mark.parametrize('k', range(2, 49))
def test_round_kernel_is_bit_equal_to_plain(cuda, k):
    # 37 x 53 pixels fill no block; the bursty column, zero, negative and
    # NaN determinants and a constant series
    cube = torch.from_numpy(_scan_cube(37, 53, k, seed=70 + k)).to(cuda)
    c_tab, s_tab = change_cuda.omnibus_tables(k, 9, 0.99)
    for with_margin, rounds in ((False, k - 1), (True, k - 1),
                                (True, change_cuda._round_cap(k))):
        before = change_cuda.launches
        got = change_cuda.change_detection_fast(
            cube, 0.99, n=9, return_margin=with_margin, return_packed=True,
            max_rounds=rounds)
        assert change_cuda.launches == before + 1
        ref = change_cuda.omnibus_plain(cube, c_tab, s_tab, 9.0, rounds,
                                        with_margin)
        torch.cuda.synchronize()
        _assert_round_equal(got if with_margin else (got, None), ref,
                            with_margin)


@pytest.mark.parametrize('k', [12, 40, 48, 56, 100, 256])
def test_every_round_plan_is_bit_equal(cuda, k):
    cube = torch.from_numpy(_scan_cube(37, 53, k, seed=80 + k)).to(cuda)
    c_tab, s_tab = change_cuda.omnibus_tables(k, 9, 0.99)
    cap = change_cuda._round_cap(k)
    ref = change_cuda.omnibus_plain(cube, c_tab, s_tab, 9.0, cap, True)
    plans = change_cuda.round_plan_candidates(k, 37 * 53)
    assert any(p['resident'] for p in plans) or k > 200
    assert any(not p['resident'] for p in plans)
    for plan in plans:
        got = change_cuda.change_detection_fast(
            cube, 0.99, n=9, return_margin=True, return_packed=True,
            max_rounds=cap, plan=plan)
        torch.cuda.synchronize()
        _assert_round_equal(got, ref, True)


def test_round_plan_shared_memory_matches_the_kernel(cuda):
    lib = _build.library()
    fn = lib.nd_omnibus_smem
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    assert lib.nd_omnibus_static_smem() == change_cuda.STATIC_SMEM
    for k in (2, 12, 48, 56, 256):
        for plan in change_cuda.round_plan_candidates(k, 1 << 20):
            assert fn(plan['threads'], plan['T'], plan['nbuf']) \
                == plan['smem']


def test_rescan_shared_memory_matches_the_kernel(cuda):
    lib = _build.library()
    fn = lib.nd_omnibus_mixed_smem
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 3
    f32, f64 = torch.float32, torch.float64
    for k in (1, 12, 56, 200, 256, 300, 1000, 1500, 3000):
        for sdtype, ldtype in ((f32, f64), (f64, f64), (f32, f32)):
            assert fn(k, int(sdtype == f64), int(ldtype == f64)) == \
                change_mixed_cuda.rescan_smem(k, sdtype, ldtype)


RESCAN_KS = [3, 4, 12, 31, 32, 33, 48, 49, 56, 64, 65, 128, 200, 255, 256]


@pytest.mark.parametrize('k', RESCAN_KS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_rescan_of_the_suspects_matches_plain(cuda, k, dtype):
    values = torch.from_numpy(_mixed_rows(k, seed=90 + k, n=197)).to(cuda,
                                                                     dtype)
    rng = np.random.RandomState(k)
    margin = torch.from_numpy(rng.uniform(-1, 1, 197).astype(np.float32))
    margin[::7] = float('nan')
    margin = margin.to(cuda)
    planes = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, ((k + 30) // 31,
                                                            197),
                                          dtype=np.int64).astype(np.int32))
    got_planes = planes.to(cuda)
    before = change_mixed_cuda.launches
    count = change_mixed_cuda.rescan(values, margin, got_planes, 0.99, 9,
                                     1e-4)
    assert change_mixed_cuda.launches == before + 1
    assert count.device.type == 'cuda'
    ref_planes = planes.to(cuda)
    ref_count = change_mixed_cuda.rescan_plain(values, margin, ref_planes,
                                               0.99, 9, 1e-4)
    torch.cuda.synchronize()
    assert int(count) == int(ref_count) == int((~(margin > 1e-4)).sum())
    assert bool((got_planes == ref_planes).all())
    # the suspects' planes are the full-grid scan's, the others untouched
    full = change_mixed_cuda.mixed_scan(values, 0.99, 9)
    suspect = ~(margin > 1e-4)
    assert bool((got_planes[:, suspect] == full[:, suspect]).all())
    assert bool((got_planes[:, ~suspect] == planes.to(cuda)[:, ~suspect])
                .all())


# series whose warp scratch is past the shared memory: the kernel keeps
# it in a device workspace (float64 sums from k = 1416, float32 from 2377)
LONG_SERIES = [(1500, torch.float64, 'mixed'), (1416, torch.float32,
                                               'float64'),
               (2400, torch.float32, 'mixed')]


@pytest.mark.parametrize('k,dtype,mode', LONG_SERIES)
def test_mixed_scan_of_series_past_the_shared_memory(cuda, k, dtype, mode):
    sdtype, ldtype = tchange.stat_types(mode, dtype)
    assert change_mixed_cuda.rescan_smem(k, sdtype, ldtype) \
        > change_mixed_cuda.SMEM_MAX
    rows = torch.from_numpy(_mixed_rows(k, seed=97, n=33)).to(cuda, dtype)
    ref = _check_mixed(rows, 0.99, 9, mode)
    assert bool(ref.any())


def test_rescan_of_series_past_the_shared_memory(cuda):
    k = 1500
    values = torch.from_numpy(_mixed_rows(k, seed=98, n=33)).to(cuda,
                                                                torch.float64)
    margin = torch.ones(33, device=cuda)
    margin[::3] = -1.0
    margin[1] = float('nan')
    planes = torch.full(((k + 30) // 31, 33), 5, dtype=torch.int32,
                        device=cuda)
    ref_planes = planes.clone()
    count = change_mixed_cuda.rescan(values, margin, planes, 0.99, 9, 1e-4)
    ref_count = change_mixed_cuda.rescan_plain(values, margin, ref_planes,
                                               0.99, 9, 1e-4)
    torch.cuda.synchronize()
    assert int(count) == int(ref_count) == 12
    assert bool((planes == ref_planes).all())


@pytest.mark.parametrize('margins', ['none', 'all'])
def test_rescan_with_no_suspect_or_every_pixel(cuda, margins):
    values = torch.from_numpy(_mixed_rows(40, seed=95)).to(cuda)
    fill = 1.0 if margins == 'none' else -1.0
    margin = torch.full((200,), fill, device=cuda)
    planes = torch.full((2, 200), 5, dtype=torch.int32, device=cuda)
    count = change_mixed_cuda.rescan(values, margin, planes, 0.99, 9, 1e-4)
    if margins == 'none':
        assert int(count) == 0 and bool((planes == 5).all())
    else:
        assert int(count) == 200
        assert bool((planes == change_mixed_cuda.mixed_scan_plain(
            values, 0.99, 9)).all())


def test_exact_mode_keeps_the_suspect_count_on_the_card(cuda):
    cube = torch.from_numpy(sar_cube(64, 96, 12, seed=96)).to(cuda)
    packed, count = tchange._exact_packed(cube, 0.99, 9, 1e-4)
    assert isinstance(count, torch.Tensor) and count.device.type == 'cuda'
    _, margin = change_cuda.change_detection_fast(
        cube, 0.99, n=9, return_margin=True, return_packed=True,
        max_rounds=change_cuda._round_cap(12))
    assert int(count) == int((~(margin > 1e-4)).sum()) > 0
    ref = tchange.change_detection_plain(cube, 0.99, n=9)
    assert bool((change_cuda.unpack_flags(packed, 12) == ref).all())


LONG_TAPS = {'65': np.linspace(0.5, 1.5, 65), '129 uniform': np.ones(129),
             'gaussian sigma 32': gaussian_kernel1d(32.0)}


@pytest.mark.parametrize('taps', sorted(LONG_TAPS))
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_long_tap_sepconv_is_bit_equal_to_plain(cuda, taps, mode, dtype):
    w = LONG_TAPS[taps]
    # a one-axis pass as ops/conv.py sends it: (1, outer, n, inner), the
    # long-tap kernel
    a = _data((1, 37, 53, 7), seed=97).to(cuda, dtype)
    conv_cuda.reset_launches()
    got = conv_cuda.sepconv2(a, np.ones(1), w, mode=mode, cval=0.5)
    assert conv_cuda.launches_long_axis == 1 and conv_cuda.launches == 0
    ref = conv_cuda.sepconv2_plain(a, np.ones(1), w, mode=mode, cval=0.5)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) == 0.0
    # a long axis beside short ones, both entry points: the tiled kernel
    b = _data((3, 21, 70, 5), seed=98).to(cuda, dtype)
    got = conv_cuda.sepconv2(b, np.array([0.25, 0.5, 0.25]), w, mode=mode)
    assert conv_cuda.launches == 1 and conv_cuda.launches_long == 1
    ref = conv_cuda.sepconv2_plain(b, np.array([0.25, 0.5, 0.25]), w,
                                   mode=mode)
    assert float((got - ref).abs().max()) == 0.0
    c = _data((21, 23, 19, 2), seed=99).to(cuda, dtype)
    t3 = np.array([0.25, 0.5, 0.25])
    got = conv_cuda.sepconv3(c, t3, t3, w, mode=mode)
    ref = conv_cuda.sepconv3_plain(c, t3, t3, w, mode=mode)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) == 0.0
    assert conv_cuda.launches_long_axis == 1


# the long-tap kernel's routes: the time pass's lines (outer >= 4096,
# n = 56 < k, inner = 1), short lines of several columns, n < k on both
# routes, rows of whole 16-byte chunks and ragged ones
LONG_VIEWS = [(1, 4096, 56, 1), (1, 300, 20, 3), (1, 9, 5, 1),
              (1, 2, 70, 300), (1, 3, 40, 50), (2, 5, 1, 37)]


@pytest.mark.parametrize('view', LONG_VIEWS)
@pytest.mark.parametrize('taps', sorted(LONG_TAPS))
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_long_tap_kernel_routes_are_bit_equal_to_plain(cuda, view, taps,
                                                       mode, dtype):
    w = LONG_TAPS[taps]
    a = _data(view, seed=103).to(cuda, dtype)
    conv_cuda.reset_launches()
    got = conv_cuda.sepconv2(a, np.ones(1), w, mode=mode, cval=-0.25)
    torch.cuda.synchronize()
    assert conv_cuda.launches_long_axis == 1 and conv_cuda.launches == 0
    ref = conv_cuda.sepconv2_plain(a, np.ones(1), w, mode=mode, cval=-0.25)
    assert float((got - ref).abs().max()) == 0.0
    # the tiled kernel's long-tap route (the parent's) agrees bit for bit
    tiled = conv_cuda.sepconv2_tiled(a, np.ones(1), w, mode=mode, cval=-0.25)
    assert conv_cuda.launches == 1
    assert float((tiled - ref).abs().max()) == 0.0


@pytest.mark.parametrize('sigma', [7.9, 16.0])
def test_long_gaussian_filter_on_the_card_matches_the_cpu(cuda, sigma):
    x = _data((40, 48, 20), seed=100).to(torch.float32)
    g = ndt.GaussianFilter(dims=('y', 'x', 'time'), sigma=sigma)
    da = Dataset({'C11': (('y', 'x', 'time'), x)}, device='cpu')['C11']
    ref = g.apply(da).data
    conv_cuda.reset_launches()
    got = g.apply(Dataset({'C11': (('y', 'x', 'time'), x.to(cuda))})['C11'])
    # one pass per axis, each on the long-tap kernel
    assert conv_cuda.launches_long_axis == 3 and conv_cuda.launches == 0
    assert float((got.data.cpu() - ref).abs().max()) == 0.0


# the wide-window kernel: the WIDE shapes of the reference's repairs, a
# ragged one (no side divides the tile), and r + f = n - 1 on one axis
WIDE = [((24, 26, 9, 4), (10, 10, 3), (3, 3, 3), torch.float32),
        ((12, 13, 12, 4), (5, 5, 5), (2, 2, 2), torch.float64),
        ((12, 13, 12, 8), (5, 5, 5), (2, 2, 2), torch.float32),
        ((13, 14, 10, 4), (4, 4, 4), (3, 3, 3), torch.float64),
        ((23, 27, 11, 4), (10, 10, 3), (3, 3, 3), torch.float32),
        ((22, 25, 6, 4), (10, 10, 2), (3, 3, 3), torch.float32)]


@pytest.mark.parametrize('shape,r,f,dtype', WIDE)
@pytest.mark.parametrize('n_eff', [-1.0, 4.0])
def test_wide_window_nlmeans_route_matches_plain(cuda, shape, r, f, dtype,
                                                 n_eff):
    a = _data(shape, seed=101).to(cuda, dtype)
    plan = nlmeans_cuda._tile_plan(shape, r, f, a.element_size())
    assert plan['route'] == 'wide'
    before = (nlmeans_cuda.launches_3d, nlmeans_cuda.launches_wide)
    got = nlmeans_cuda.nlmeans_3d(a, r, f, 0.3, 0.4, n_eff)
    assert (nlmeans_cuda.launches_3d, nlmeans_cuda.launches_wide) \
        == (before[0], before[1] + 1)
    ref = nlmeans_cuda.nlmeans_3d_plain(a, r, f, 0.3, 0.4, n_eff)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=1e-12, atol=1e-13)
    torch.testing.assert_close(got, ref, equal_nan=True, **tol)


# every build of the wide-window kernel through a given plan: the ring
# fused (float32 only) and not, patches past the unrolled width, any nv,
# and no ring (the partner from the padded cube)
WIDE_BUILDS = [((13, 14, 9, 4), (3, 3, 2), (1, 1, 1), (4, 8, 4), True, True),
               ((13, 14, 9, 4), (3, 3, 2), (1, 1, 1), (4, 8, 4), True, False),
               ((13, 14, 11, 4), (2, 2, 2), (1, 2, 3), (4, 4, 8), True, True),
               ((13, 14, 9, 4), (2, 2, 1), (4, 1, 1), (4, 4, 4), True, False),
               ((13, 14, 9, 3), (2, 2, 1), (1, 1, 1), (4, 4, 4), True, False),
               ((13, 14, 9, 3), (2, 2, 1), (4, 1, 1), (4, 4, 4), True, False),
               ((13, 14, 9, 4), (2, 3, 1), (1, 1, 1), (4, 4, 4), False, False),
               ((13, 14, 9, 5), (2, 3, 1), (1, 0, 1), (2, 8, 4), False, False),
               ((9, 8, 7, 4), (1, 2, 2), (0, 0, 0), (4, 4, 4), True, True),
               ((9, 8, 7, 4), (1, 2, 2), (0, 0, 0), (4, 4, 4), True, False),
               ((9, 8, 7, 4), (2, 2, 0), (1, 1, 0), (8, 8, 1), True, True)]


@pytest.mark.parametrize('shape,r,f,tile,ring,fused', WIDE_BUILDS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wide_window_builds_match_plain(cuda, shape, r, f, tile, ring, fused,
                                        dtype):
    a = _data(shape, seed=104).to(cuda, dtype)
    plan = nlmeans_cuda.wide_plan_of(shape, r, f, a.element_size(), tile,
                                     ring, fused and dtype == torch.float32)
    got = nlmeans_cuda._launch(a, r, f, 0.3, 0.4, -1.0, 'launches_3d', plan)
    ref = nlmeans_cuda.nlmeans_3d_plain(a, r, f, 0.3, 0.4)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=1e-12, atol=1e-13)
    torch.testing.assert_close(got, ref, equal_nan=True, **tol)


@pytest.mark.parametrize('dtype', [torch.float16, torch.bfloat16])
def test_low_precision_filters_on_the_card(cuda, dtype):
    a = _data((17, 19, 6, 4), seed=102).to(cuda, dtype)
    tol = dict(rtol=1e-3, atol=1e-3) if dtype == torch.float16 \
        else dict(rtol=8e-3, atol=8e-3)
    for got, ref in (
            (nlmeans_cuda.nlmeans_spatial(a, (2, 2), (1, 1), 0.3, 0.4),
             nlmeans_cuda.nlmeans_spatial_plain(a, (2, 2), (1, 1), 0.3,
                                                0.4)),
            (nlmeans_cuda.nlmeans_3d(a, (2, 2, 1), (1, 1, 1), 0.3, 0.4),
             nlmeans_cuda.nlmeans_3d_plain(a, (2, 2, 1), (1, 1, 1), 0.3,
                                           0.4)),
            (conv_cuda.sepconv3(a, *([np.array([0.25, 0.5, 0.25])] * 3)),
             conv_cuda.sepconv3_plain(a, *([np.array([0.25, 0.5,
                                                      0.25])] * 3)))):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref.float(), **tol)


# ---- the georeferencing layer: gathers, matmuls, footprints, caches ---------
#
# The card against the same port functions on the CPU. Gathers and matmuls
# in float32: rtol 1e-5, atol 1e-6; nearest and the order statistics
# exact; the footprint median rtol 1e-6; coregistration shifts equal.



def _edge_coords(H, W):
    """Coordinates at and past every edge: exact borders, a hair inside
    and outside, far outside, +-inf and NaN."""
    vals = [0.0, -1e-7, 1e-7, -0.5, -1.0, -3.0, -1e30, np.inf, -np.inf,
            np.nan]
    rows = vals + [H - 1, H - 1 + 1e-7, H - 0.5, H, H + 5, 1e30]
    cols = vals + [W - 1, W - 1 + 1e-7, W - 0.5, W, W + 5, 1e30]
    r, c = np.meshgrid(np.asarray(rows, np.float32),
                       np.asarray(cols, np.float32), indexing='ij')
    return torch.from_numpy(r), torch.from_numpy(c)


@pytest.mark.parametrize('method', ['nearest', 'bilinear', 'cubic',
                                    'cubic_spline', 'lanczos'])
def test_gather_at_and_past_every_edge(cuda, method):
    v = _data((3, 37, 53), seed=120).float()
    v[1, 0, 0] = np.nan
    rows, cols = _edge_coords(37, 53)
    ref = tinterp.map_coordinates(v, rows, cols, method=method)
    got = tinterp.map_coordinates(v.to(cuda), rows.to(cuda), cols.to(cuda),
                                  method=method)
    torch.cuda.synchronize()                 # a device assert shows here
    tol = dict(rtol=0, atol=0) if method == 'nearest' \
        else dict(rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.cpu(), ref, equal_nan=True, **tol)
    assert torch.isnan(ref).any() and torch.isfinite(ref).any()


def test_integer_gather_past_the_edges(cuda):
    v = torch.from_numpy(np.random.RandomState(121).randint(
        -9, 9, (2, 11, 13)).astype(np.int32))
    rows, cols = _edge_coords(11, 13)
    ref = tinterp.map_coordinates(v, rows, cols, method='nearest', cval=0)
    got = tinterp.map_coordinates(v.to(cuda), rows.to(cuda), cols.to(cuda),
                                  method='nearest', cval=0)
    assert torch.equal(got.cpu(), ref)


def test_matmul_resample_ignores_the_callers_tf32(cuda):
    """With TF32 switched on by the caller the separable product must
    still agree with the float64 product to 1e-5: the products run at
    full float32 precision (a TF32 product misses by about 1e-3)."""
    H = W = 512
    rr = np.linspace(0.25, H - 1.5, 400)
    cc = np.linspace(0.4, W - 1.2, 450)
    wy, wym, vy = tinterp.axis_weights(rr, H, 'bilinear')
    wx, wxm, vx = tinterp.axis_weights(cc, W, 'bilinear')
    plan = [torch.from_numpy(a) for a in (wy, wym, wx, wxm, vy, vx)]
    v = torch.from_numpy(np.random.RandomState(122).normal(
        5, 3, (4, H, W)).astype(np.float32))
    want = torch.matmul(plan[0].double(), torch.matmul(
        v.double(), plan[2].double().T))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tinterp.matmul_resample(v.to(cuda),
                                      *[p.to(cuda) for p in plan],
                                      np.nan, expected=4.0)
        torch.cuda.synchronize()
        assert torch.backends.cuda.matmul.allow_tf32      # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = ((got.cpu().double() - want).abs() / want.abs().clamp(min=1))
    assert float(err.max()) <= 1e-5


def test_footprint_median_past_two_to_the_24(cuda):
    """``torch.nanquantile`` refuses more than 2^24 elements; the
    footprint median sorts instead, on windows of 24M elements here."""
    H, W, step = 1024, 1024, 2.5
    ry = np.arange(0.6, H, step)
    cx = np.arange(0.6, W, step)
    plan = tinterp.footprint_axis(ry, H, step) \
        + tinterp.footprint_axis(cx, W, step)
    v = torch.from_numpy(np.random.RandomState(123).normal(
        0, 1, (16, H, W)).astype(np.float32))
    v[:, :40, :40] = np.nan
    span = plan[0].shape[1] * plan[3].shape[1]
    assert 16 * len(ry) * len(cx) * span > 2 ** 24
    ref = tinterp.footprint_resample(v, *[torch.from_numpy(a)
                                          for a in plan], 'med', np.nan)
    got = tinterp.footprint_resample(v.to(cuda),
                                     *[torch.from_numpy(a).to(cuda)
                                       for a in plan], 'med', np.nan)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-6, atol=0,
                               equal_nan=True)


def test_plan_caches_from_cpu_and_cuda_in_turn(cuda):
    """One geometry, warped on the CPU, the card and the CPU again: each
    result lies on its input's device (the caches are keyed by device),
    and the two devices agree."""
    for cache in (twarp._cached_plan, twarp._cached_grid,
                  twarp._cached_footprint_plan):
        cache.cache_clear()
    dims = {'y': 64, 'x': 80, 'time': 3}
    cpu_ds = generate_test_dataset(dims=dims, device='cpu').astype(
        'float32')
    card_ds = generate_test_dataset(dims=dims, device=cuda).astype(
        'float32')
    for algo, tol in ((ndt.Reprojection(crs='epsg:3395'), 1e-5),
                      (ndt.Reprojection(crs='epsg:3035', resampling='cubic'),
                       1e-5),
                      (ndt.Resample(res=0.3, resampling='med'), 1e-6)):
        outs = [algo.apply(ds) for ds in (cpu_ds, card_ds, cpu_ds)]
        for out, dev in zip(outs, ('cpu', 'cuda', 'cpu')):
            assert all(out[v].data.device.type == dev
                       for v in out.data_vars)
            assert out.coords['lat'].data.device.type == dev
        for v in outs[0].data_vars:
            torch.testing.assert_close(outs[1][v].data.cpu(),
                                       outs[0][v].data, rtol=tol,
                                       atol=1e-6, equal_nan=True)
            assert torch.equal(outs[2][v].data.isnan(),
                               outs[0][v].data.isnan())
    assert twarp._cached_plan.cache_info().hits >= 1
    assert twarp._cached_grid.cache_info().hits >= 1


def test_coregistration_on_the_card_matches_cpu(cuda):
    dims = {'y': 96, 'x': 128, 'time': 5}
    cpu_ds = generate_test_dataset(dims=dims, device='cpu').astype(
        'float32')
    card_ds = generate_test_dataset(dims=dims, device=cuda).astype(
        'float32')
    master = cpu_ds['C11'].transpose('time', 'y', 'x').data
    ref = tfft.phase_cross_correlation_batch(master, master[0], 10)
    got = tfft.phase_cross_correlation_batch(master.to(cuda),
                                             master[0].to(cuda), 10)
    assert torch.equal(got.cpu(), ref)
    want = ndt.Coregistration(reference=0).apply(cpu_ds)
    out = ndt.Coregistration(reference=0).apply(card_ds)
    for v in want.data_vars:
        assert out[v].data.device.type == 'cuda'
        torch.testing.assert_close(out[v].data.cpu(), want[v].data,
                                   rtol=1e-5, atol=1e-6)


# -- the training path, the classifiers and checkpoints -------------------------

def _train_cube(ny=48, nx=40, k=6, seed=61):
    cube = sar_cube(ny, nx, k, seed=seed, special=False)
    labels = ((np.arange(ny)[:, None] // 4 + np.arange(nx)[None, :] // 5)
              % 2).astype(np.int32)
    labels[:2] = -1
    return cube, labels


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_change_statistics_on_the_card_match_the_cpu(cuda, dtype):
    from nd_tpu_torch.ops.change import omnibus_probabilities
    from nd_tpu_torch.ops.stats import chi2_cdf
    cube = torch.from_numpy(sar_cube(33, 47, 12, seed=62,
                                     special=True)).to(dtype)
    f32 = dtype == torch.float32
    got = omnibus_probabilities(cube.to(cuda), n=9)
    ref = omnibus_probabilities(cube, n=9)
    assert got.device.type == 'cuda' and got.dtype == dtype
    torch.testing.assert_close(got.cpu(), ref, rtol=0,
                               atol=2e-5 if f32 else 1e-9, equal_nan=True)
    x = torch.linspace(-2, 120, 4001, dtype=dtype)
    x[7] = float('nan')
    for df in (4, 44, 48, 100):
        torch.testing.assert_close(chi2_cdf(x.to(cuda), df).cpu(),
                                   chi2_cdf(x, df), rtol=0,
                                   atol=5e-6 if f32 else 1e-9,
                                   equal_nan=True)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Five steps from the same initial parameters: losses rtol 1e-5,
    parameters rtol 1e-4 / atol 1e-6, first-step features rtol 1e-5 /
    atol 1e-5; one sepconv launch per step and no other kernel."""
    cube, labels = _train_cube()
    model = ndt.SARChangePipeline(ml=3, n=1, alpha=0.9, lr=0.05)
    p_card = model.init_params(seed=0)
    p_cpu = model.init_params(seed=0, device='cpu')
    assert p_card['w'].device.type == 'cuda'
    assert torch.equal(p_card['w'].cpu(), p_cpu['w'])
    feats = model.features(ndt.multilook(torch.from_numpy(cube).to(cuda), 3))
    torch.testing.assert_close(
        feats.cpu(), model.features(ndt.multilook(torch.from_numpy(cube),
                                                  3)), rtol=1e-5, atol=1e-5)
    counts = {m: m.launches for m in (conv_cuda, nlmeans_cuda, change_cuda,
                                      change_mixed_cuda, change_scan_cuda)}
    for _ in range(5):
        p_card, l_card = model.train_step(p_card, cube, labels)
        p_cpu, l_cpu = model.train_step(p_cpu, torch.from_numpy(cube),
                                        torch.from_numpy(labels))
        assert l_card.device.type == 'cuda' and bool(torch.isfinite(l_card))
        torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=0)
    assert conv_cuda.launches == counts[conv_cuda] + 5
    assert all(m.launches == n for m, n in counts.items() if m is not conv_cuda)
    for k in ('w', 'b'):
        assert p_card[k].device.type == 'cuda'
        torch.testing.assert_close(p_card[k].cpu(), p_cpu[k], rtol=1e-4,
                                   atol=1e-6)


def test_masked_labels_never_reach_one_hot(cuda, monkeypatch):
    import torch.nn.functional as F

    def refuse(*args, **kwargs):
        raise AssertionError('F.one_hot was called')
    monkeypatch.setattr(F, 'one_hot', refuse)
    monkeypatch.setattr(torch.nn.functional, 'one_hot', refuse)
    cube, labels = _train_cube(24, 24)
    labels[:, :5] = -1
    model = ndt.SARChangePipeline(n_classes=3)
    params, loss = model.train_step(model.init_params(), cube, labels)
    assert bool(torch.isfinite(loss))
    assert float(model.loss(params, ndt.multilook(
        torch.from_numpy(cube).to(cuda), 3),
        np.full(labels.shape, -1, np.int32))) == 0.0
    from nd_tpu_torch.testing import create_mock_classes
    ds, lab = create_mock_classes(dims={'y': 20, 'x': 20, 'time': 3})
    pred = ndt.TorchClassifier(epochs=3).fit_predict(ds, lab)
    assert pred.data.device.type == 'cuda'


def test_torch_classifier_on_the_card_matches_the_cpu(cuda):
    from nd_tpu_torch.testing import create_mock_classes
    dims = {'y': 40, 'x': 36, 'time': 4}
    results = []
    for dev in (cuda, 'cpu'):
        ds, labels = create_mock_classes(dims=dims, device=dev)
        c = ndt.TorchClassifier(hidden=(16,), epochs=10, lr=0.05)
        c.fit(ds, labels)
        pred = c.predict(ds)
        proba = c.predict(ds, func='predict_proba')
        assert pred.data.device.type == torch.device(dev).type
        assert all(a.device.type == torch.device(dev).type
                   for pair in c.params for a in pair)
        results.append((c.params, pred.values, proba.values))
    (p_card, pred_card, pr_card), (p_cpu, pred_cpu, pr_cpu) = results
    for (wc, bc), (wh, bh) in zip(p_card, p_cpu):
        torch.testing.assert_close(wc.cpu(), wh, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(bc.cpu(), bh, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(pred_card, pred_cpu)
    np.testing.assert_allclose(pr_card, pr_cpu, rtol=1e-4, atol=1e-6)


def test_data_model_results_stay_on_the_card(cuda):
    from nd_tpu_torch.classify import _build_X, class_mean
    from nd_tpu_torch.testing import create_mock_classes
    ds, labels = create_mock_classes(dims={'y': 10, 'x': 12, 'time': 3})
    da = ds['C11']
    cond = ds['C22'].mean('time') > 0
    outs = [da + 1, 2 - da, da / ds['C22'], da ** 2, da % 3, da > cond,
            (da > 0) & (da < 5), -da, abs(da), ~(da > 0), da.where(cond),
            da.where(cond, ds['C22']), da.isnull(), da.notnull(),
            da.mean(), da.std('time'), da.var(('y', 'x')), da.min('x'),
            da.max(), da.sum('time'), da.count(), da.expand_dims('band'),
            da.mean('time').expand_dims('time').squeeze()]
    outs += [ds[v] for d in (ds + 1, ds * da, ds.where(cond), ds.isnull(),
                             ds.mean('time'), ds.std(), ds.count(),
                             ds.expand_dims('band').squeeze(),
                             class_mean(ds, labels))
             for v in d.data_vars]
    assert all(o.data.device.type == 'cuda' for o in outs)
    assert _build_X(ds).device.type == 'cuda'
    assert labels.data.device.type == 'cuda'


def test_checkpoints_round_trip_onto_the_card(cuda, tmp_path):
    from nd_tpu_torch.models.checkpoint import (Checkpointer, load_params,
                                                save_params)
    model = ndt.SARChangePipeline(n_classes=3)
    params = model.init_params(seed=2)
    path = str(tmp_path / 'p.npz')
    save_params(params, path)
    got = load_params(path, like=model.init_params(seed=9))
    assert all(got[k].device.type == 'cuda' and torch.equal(got[k],
                                                            params[k])
               for k in params)
    pairs = [(torch.randn(4, 3, device=cuda), torch.zeros(3, device=cuda))]
    save_params(pairs, path)
    flat = load_params(path)
    assert [t.device.type for t in flat] == ['cuda', 'cuda']
    assert torch.equal(flat[0], pairs[0][0])
    ck = Checkpointer(str(tmp_path / 'ck'), max_to_keep=2)
    for step in range(3):
        ck.save(step, {'w': params['w'] + step, 'b': params['b']})
    assert ck.latest_step() == 2
    back = ck.restore(like=params)
    assert back['w'].device.type == 'cuda'
    assert torch.equal(back['w'], params['w'] + 2)
    assert sorted(os.listdir(str(tmp_path / 'ck'))) == ['step_1.npz',
                                                        'step_2.npz']
    ck.close()


# ---- the stencil kernel, njobs and the data model on the card ---------------

DISK = np.array([[1.0 if i * i + j * j <= 5 else 0.0 for j in range(-2, 3)]
                 for i in range(-2, 3)]) / 21.0
STENCIL_MODES = [('reflect', 0.0), ('mirror', 0.0), ('nearest', 0.0),
                 ('wrap', 0.0), ('constant', 0.0), ('constant', 1.5)]


def _disk(r):
    """The flipped (2r+1, 2r+1, 1) disk of radius**2 <= r*r + 1, zero taps
    included."""
    ax = np.arange(-r, r + 1)
    d = (ax[:, None] ** 2 + ax[None, :] ** 2 <= r * r + 1).astype(float)
    return (d / d.sum())[:, :, None]


def _stencil_kernel(kshape):
    if kshape in ('disk3', 'disk5', 'disk7'):
        return _disk(int(kshape[-1]) // 2)
    return np.random.RandomState(8).rand(*kshape) - 0.3


@pytest.mark.parametrize('mode,cval', STENCIL_MODES)
@pytest.mark.parametrize('shape,kshape,dtype', [
    ((1, 64, 80, 1, 12), (5, 5, 1), torch.float32),
    ((2, 33, 47, 9, 3), (3, 3, 3), torch.float32),
    ((1, 37, 53, 7, 1), (4, 3, 2), torch.float64),
    ((1, 24, 24, 1, 2), (181, 181, 1), torch.float32),      # direct route
    # the register run's edges: n0 not a multiple of the run, n0 < k0
    ((1, 19, 40, 1, 12), 'disk5', torch.float32),
    ((1, 3, 40, 1, 12), 'disk5', torch.float32),
    ((1, 40, 1, 1, 12), 'disk5', torch.float32),            # n1 = 1
    ((1, 40, 50, 1, 1), 'disk5', torch.float32),            # row 1
    ((4, 30, 40, 1, 11), 'disk5', torch.float32),           # outer 4, row 11
    ((1, 30, 40, 1, 48), 'disk5', torch.float32),           # row 48
    ((4, 30, 40, 1, 11), 'disk3', torch.float32),
    ((4, 30, 40, 1, 11), 'disk7', torch.float32),
    ((4, 30, 40, 1, 11), (4, 3, 2), torch.float32),
    ((1, 40, 30, 1, 12), (5, 1, 1), torch.float32),
    ((1, 40, 30, 1, 12), (1, 5, 1), torch.float32),
    ((1, 24, 20, 1, 6), (9, 9, 1), torch.float32),          # generic build
    ((1, 30, 28, 20, 1), (3, 3, 3), torch.float32),         # Laplacian view
    # the unrolled builds' limits: 7 rows x 9 row taps (63 by value), past
    # them the generic build (8 rows; 11 row taps)
    ((1, 30, 28, 1, 5), (7, 9, 1), torch.float32),
    ((1, 30, 28, 1, 5), (8, 2, 1), torch.float32),
    ((1, 30, 12, 20, 1), (2, 1, 11), torch.float32),
    # float64 through every build: unrolled, generic (7 x 7 = 49 taps and
    # 4 x 9 = 36 past the 32 passed by value)
    ((4, 30, 40, 1, 11), 'disk5', torch.float64),
    ((1, 30, 28, 20, 1), (3, 3, 3), torch.float64),
    ((4, 30, 40, 1, 11), 'disk3', torch.float64),
    ((4, 30, 40, 1, 11), 'disk7', torch.float64),
    ((1, 24, 20, 1, 6), (9, 9, 1), torch.float64),
    ((1, 30, 28, 1, 5), (4, 8, 1), torch.float64),
    ((1, 30, 28, 1, 5), (4, 9, 1), torch.float64),
])
def test_stencil_equals_its_plain_version(cuda, shape, kshape, dtype, mode,
                                          cval):
    """Max abs diff 0: the kernel does the plain version's products and
    adds in its order (-fmad=false)."""
    from nd_tpu_torch.ops import stencil_cuda
    x = _data(shape, seed=7).to(dtype).to(cuda)
    k = _stencil_kernel(kshape)
    before = stencil_cuda.launches
    got = stencil_cuda.stencil(x, k, mode, cval)
    assert stencil_cuda.launches == before + 1
    ref = stencil_cuda.stencil_plain(x, k, mode, cval)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)
    assert stencil_cuda.stencil_tiled(*shape[1:], *k.shape,
                                      x.element_size()) == (k.shape[0] < 100)


@pytest.mark.parametrize('kshape,dtype,route', [
    ((5, 5, 1), torch.float32, 'unrolled'),
    ((3, 3, 3), torch.float64, 'unrolled'),
    ((7, 9, 1), torch.float32, 'unrolled'),
    ((8, 8, 1), torch.float32, 'generic'),
    ((1, 11, 1), torch.float32, 'generic'),
    ((4, 8, 1), torch.float64, 'unrolled'),
    ((4, 9, 1), torch.float64, 'generic'),
    ((181, 181, 1), torch.float32, 'direct'),
])
def test_stencil_route_per_window(cuda, kshape, dtype, route):
    """Every window up to 7 rows x 9 row taps whose weights fit the launch
    parameters (64 float32, 32 float64) takes an unrolled build, others
    the generic one; the forced generic build (unrolled=False) and both
    runs give the same bits."""
    from nd_tpu_torch.ops import stencil_cuda
    shape = (1, 24, 20, 1, 6)
    item = torch.tensor([], dtype=dtype).element_size()
    assert stencil_cuda.stencil_route(*shape[1:], *kshape, item) == route
    if route != 'unrolled':
        return
    assert stencil_cuda.stencil_route(*shape[1:], *kshape, item,
                                      unrolled=False) == 'generic'
    x = _data(shape, seed=9).to(dtype).to(cuda)
    k = _stencil_kernel(kshape)
    ref = stencil_cuda.stencil_plain(x, k, 'reflect')
    try:
        for run, unrolled in ((0, True), (8, True), (16, True), (0, False)):
            stencil_cuda.RUN, stencil_cuda.UNROLLED = run, unrolled
            assert torch.equal(stencil_cuda.stencil(x, k, 'reflect'), ref)
    finally:
        stencil_cuda.RUN, stencil_cuda.UNROLLED = 0, True


@pytest.mark.parametrize('mode,cval', STENCIL_MODES)
def test_stencil_nan_under_a_zero_weight(cuda, mode, cval):
    """A NaN under a zero tap of the disk propagates (0 * NaN is NaN), as
    in the plain version and XLA's convolution; elsewhere bit-equal."""
    from nd_tpu_torch.ops import stencil_cuda
    x = _data((4, 30, 40, 1, 11), seed=11).float().to(cuda)
    x[1, 7, 9, 0, 3] = float('nan')          # under the disk's zero corners
    x[2, 0, 0, 0, 0] = float('nan')          # at the array's edge
    k = _disk(2)
    got = stencil_cuda.stencil(x, k, mode, cval)
    ref = stencil_cuda.stencil_plain(x, k, mode, cval)
    torch.cuda.synchronize()
    nan = ref.isnan()
    assert int(nan.sum()) > 21 and torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], ref[~nan])


@pytest.mark.parametrize('mode,cval', STENCIL_MODES)
def test_stencil_seam_cut_tile_equals_the_whole_call(cuda, mode, cval):
    """An njobs chunk (rows 13..28 of 50, a halo of 2 each side) cuts the
    whole call's tiles: its rows equal the whole call's bit for bit."""
    from nd_tpu_torch.ops import stencil_cuda
    x = _data((4, 50, 40, 1, 11), seed=12).float().to(cuda)
    k = _disk(2)
    whole = stencil_cuda.stencil(x, k, mode, cval)
    part = stencil_cuda.stencil(x[:, 11:31].contiguous(), k, mode, cval)
    torch.cuda.synchronize()
    assert torch.equal(part[:, 2:18], whole[:, 13:29])


def test_non_separable_convolve_on_the_card_equals_the_cpu(cuda):
    """Every route (two, three, four axes, non-adjacent axes, float16,
    complex) against the same call on the CPU: bit for bit."""
    from nd_tpu_torch.ops.conv import convolve
    x = _data((20, 18, 6, 4), seed=9).float()
    rng = np.random.RandomState(10)
    for k, axes in ((DISK, (0, 1)), (rng.rand(3, 3, 3), (0, 1, 2)),
                    (rng.rand(3, 2), (0, 2)),
                    (rng.rand(3, 2, 3, 2), (0, 1, 2, 3))):
        for a in (x, x.half(), x + 1j * x.flip(0)):
            got = convolve(a.to(cuda), k, axes=axes, mode='mirror')
            assert torch.equal(got.cpu(), convolve(a, k, axes=axes,
                                                   mode='mirror'))


@pytest.mark.parametrize('name', ['disk', 'laplace_3d', 'nlmeans', 'boxcar'])
def test_njobs_on_the_card_equals_one_job(cuda, name):
    from nd_tpu_torch.ops import stencil_cuda
    ds = generate_test_dataset(dims={'y': 64, 'x': 48, 'time': 8},
                               device=cuda)
    lap = -np.ones((3, 3, 3))
    lap[1, 1, 1] = 26.0
    algo = {'disk': lambda: ndt.ConvolutionFilter(kernel=DISK),
            'laplace_3d': lambda: ndt.ConvolutionFilter(
                dims=('y', 'x', 'time'), kernel=lap),
            'nlmeans': lambda: ndt.NLMeansFilter(r=2, f=1, sigma=2, h=3),
            'boxcar': lambda: ndt.BoxcarFilter(w=3)}[name]()
    one = algo.apply(ds)
    modules = (stencil_cuda, nlmeans_cuda, conv_cuda)
    for m in modules:
        m.reset_launches()
    four = algo.apply(ds, njobs=4)
    torch.cuda.synchronize()
    total = sum(m.launches for m in modules)
    assert total > 0 and total % 4 == 0
    for v in one.data_vars:
        assert four[v].data.device.type == 'cuda'
        assert torch.equal(one[v].data, four[v].data)


def test_launch_counters_count_exactly_under_threads(cuda):
    """njobs=4 on a 16-slice stack, 8 times over in threads: every launch
    counted once."""
    import threading
    from nd_tpu_torch.ops import stencil_cuda
    ds = generate_test_dataset(dims={'y': 32, 'x': 32, 'time': 16},
                               device=cuda)
    algo = ndt.ConvolutionFilter(kernel=DISK)
    stencil_cuda.reset_launches()
    threads = [threading.Thread(target=lambda: algo.apply(ds, njobs=4))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert stencil_cuda.launches == 8 * 4


def test_grouped_reductions_on_the_card_match_the_cpu(cuda):
    """rtol 1e-6, atol 1e-6 (sums in another order); the data stays on
    the card."""
    from nd_tpu_torch.core import DataArray
    rng = np.random.RandomState(12)
    vals = rng.rand(16, 12, 56).astype(np.float32)
    vals[rng.rand(*vals.shape) < 0.05] = np.nan
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(56) * np.timedelta64(6, 'D')
    on = DataArray(vals, dims=('y', 'x', 'time'), coords={'time': times},
                   device=cuda)
    off = DataArray(vals, dims=('y', 'x', 'time'), coords={'time': times},
                    device='cpu')
    for fn in (lambda d: d.quantile(0.9, dim='time'),
               lambda d: d.median('time'),
               lambda d: d.rolling(time=3, center=True).median(),
               lambda d: d.coarsen(time=4).mean(),
               lambda d: d.groupby('time.month').mean(),
               lambda d: d.resample(time='1MS').mean(),
               lambda d: d.interpolate_na(dim='time'),
               lambda d: d.ffill('time', limit=2)):
        got, ref = fn(on), fn(off)
        assert got.data.device.type == 'cuda' and got.dims == ref.dims
        np.testing.assert_allclose(got.values, ref.values, rtol=1e-6,
                                   atol=1e-6, equal_nan=True)


def test_apply_takes_the_vmap_route_on_the_card(cuda):
    from nd_tpu_torch import utils
    ds = generate_test_dataset(dims={'y': 16, 'x': 12, 'time': 6},
                               device=cuda)
    before = dict(utils.routes)

    def span(x):
        s = x[:, 0] + x[:, 3]
        return s / s.mean(0)

    got = ds.nd.apply(span, signature='(time,var)->(time)')
    assert utils.routes['vmap'] == before['vmap'] + 1
    assert got.data.device.type == 'cuda'
    ref = utils.apply(ndt.core.Dataset(
        {v: (ds[v].dims, ds[v].data.cpu()) for v in ds.data_vars}), span,
        signature='(time,var)->(time)')
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-12)


# ---- the I/O layer on the card ----------------------------------------------

def _on(cube, times, device):
    """A (y, x, time, 4) C2 cube as the quick start's file holds it: C11,
    C12 (complex), C22, UTM coordinates, a time coordinate."""
    cube = cube.to(device)
    ny, nx = cube.shape[:2]
    return Dataset({'C11': (('y', 'x', 'time'), cube[..., 0]),
                    'C12': (('y', 'x', 'time'),
                            torch.complex(cube[..., 1], cube[..., 2])),
                    'C22': (('y', 'x', 'time'), cube[..., 3])},
                   coords={'y': 4e6 - 10 * np.arange(float(ny)),
                           'x': 5e5 + 10 * np.arange(float(nx)),
                           'time': times},
                   attrs={'crs': 'epsg:32633'}, device=device)


def _bit_equal(got, ref):
    assert set(got.data_vars) == set(ref.data_vars)
    for v in ref.data_vars:
        assert got[v].dims == ref[v].dims
        assert torch.equal(got[v].data.cpu(), ref[v].data.cpu()), v
    for c in ref.coords:
        np.testing.assert_array_equal(got[c].values, ref[c].values)


@pytest.mark.parametrize('reader', ['netcdf', 'zarr', 'geotiff'])
def test_readers_put_the_data_on_the_card(cuda, tmp_path, reader):
    ds = _on(torch.from_numpy(sar_cube(24, 20, 12, seed=71,
                                       special=False)),
             np.datetime64('2023-01-03', 'ns')
             + np.arange(12) * np.timedelta64(12, 'D'), cuda)
    if reader == 'netcdf':
        p = str(tmp_path / 'a.nc')
        ndt.to_netcdf(ds, p)
        got = ndt.open_dataset(p, as_complex=True)
        host = ndt.open_dataset(p, as_complex=True, device='cpu')
    elif reader == 'zarr':
        p = str(tmp_path / 'a.zarr')
        ndt.io.to_zarr(ds, p)
        got, host = ndt.io.open_zarr(p), ndt.io.open_zarr(p, device='cpu')
    else:
        p = str(tmp_path / 'a.tif')
        one = ndt.io.disassemble_complex(ds)
        ndt.io.to_geotiff(one, p, compress='deflate', tiled=True,
                          tile_size=16)
        da = ndt.io.open_rasterio(p)
        assert da.data.device.type == 'cuda'
        assert torch.equal(da.data.cpu(),
                           ndt.io.open_rasterio(p, device='cpu').data)
        return
    for v in got.data_vars:
        assert got[v].data.device.type == 'cuda', v
    _bit_equal(got, ds)
    _bit_equal(host, ds)


def test_netcdf_classic_route_on_the_card(cuda, tmp_path, monkeypatch):
    from nd_tpu_torch.io import netcdf
    monkeypatch.setattr(netcdf, '_h5py', lambda: None)
    assert netcdf.writer() == 'netCDF classic (CDF-2)'
    ds = _on(torch.from_numpy(sar_cube(24, 20, 12, seed=72,
                                       special=False)),
             np.datetime64('2023-01-03', 'ns')
             + np.arange(12) * np.timedelta64(12, 'D'), cuda)
    p = str(tmp_path / 'c.nc')
    ndt.to_netcdf(ds, p)
    with open(p, 'rb') as fh:
        assert fh.read(4) == b'CDF\x02'
    got = ndt.open_dataset(p, as_complex=True)
    assert all(got[v].data.device.type == 'cuda' for v in got.data_vars)
    _bit_equal(got, ds)


def test_quick_start_from_a_file_on_the_card_equals_the_cpu(cuda, tmp_path):
    """The quick start read from a file onto the card: NLMeans within its
    tolerance of the CPU's from the same file, and the change map equal
    to the CPU's OmnibusTest of the card's filtered values."""
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(12) * np.timedelta64(12, 'D')
    cube = torch.from_numpy(sar_cube(40, 36, 12, seed=73, special=False))
    p = str(tmp_path / 'stack.nc')
    ndt.to_netcdf(_on(cube, times, 'cpu'), p)
    nlm = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3)
    omn = ndt.OmnibusTest(ml=3, alpha=0.01)
    flt = {dev: nlm.apply(ndt.open_dataset(p, device=dev).nd.as_complex())
           for dev in ('cuda', 'cpu')}
    change = omn.apply(flt['cuda'])
    assert change.data.device.type == 'cuda'
    for v in flt['cpu'].data_vars:
        np.testing.assert_allclose(flt['cuda'][v].values,
                                   flt['cpu'][v].values, rtol=1e-5,
                                   atol=1e-6)
    moved = Dataset({v: (flt['cuda'][v].dims, flt['cuda'][v].data.cpu())
                     for v in flt['cuda'].data_vars})
    assert torch.equal(change.data.cpu(), omn.apply(moved).data)


def _lazy_cube_file(tmp_path, classic, monkeypatch):
    from nd_tpu_torch.io import netcdf
    if classic:
        monkeypatch.setattr(netcdf, '_h5py', lambda: None)
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(12) * np.timedelta64(12, 'D')
    ds = _on(torch.from_numpy(sar_cube(40, 36, 12, seed=74,
                                       special=False)), times, 'cpu')
    p = str(tmp_path / 'lazy.nc')
    ndt.to_netcdf(ds, p)
    return p, ds


@pytest.mark.parametrize('classic', [False, True])
def test_lazy_slab_lands_on_the_card(cuda, tmp_path, monkeypatch, classic):
    if not classic:
        pytest.importorskip('h5py')
    p, ds = _lazy_cube_file(tmp_path, classic, monkeypatch)
    lz = ndt.open_dataset(p, chunks={})
    sub = lz.isel(y=slice(5, 29, 2), x=3, time=slice(1, 9))
    assert sub._variables['C11'].is_lazy
    got = sub['C11'].data
    assert got.device.type == 'cuda'
    assert not sub._variables['C11'].is_lazy
    want = ds['C11'].data[5:29:2, 3, 1:9]
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize('classic', [False, True])
def test_to_netcdf_of_a_lazy_variable_never_touches_the_card(
        cuda, tmp_path, monkeypatch, classic):
    if not classic:
        pytest.importorskip('h5py')
    p, ds = _lazy_cube_file(tmp_path, classic, monkeypatch)
    lz = ndt.open_dataset(p, chunks={}).isel(y=slice(0, 20))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    q = str(tmp_path / 'copy.nc')
    ndt.to_netcdf(lz, q)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert all(v.is_lazy for v in lz._variables.values())
    back = ndt.open_dataset(q, device='cpu')
    ds = ndt.io.disassemble_complex(ds)
    assert set(back.data_vars) == set(ds.data_vars)
    for v in ds.data_vars:
        assert torch.equal(back[v].data, ds[v].data[:20]), v


def test_map_over_tiles_workers_give_the_same_bytes(cuda, tmp_path):
    from nd_tpu_torch.tiling import map_over_tiles, tile
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(12) * np.timedelta64(12, 'D')
    ds = _on(torch.from_numpy(sar_cube(48, 40, 12, seed=75,
                                       special=False)), times, cuda)
    ds = ndt.io.disassemble_complex(ds)
    tile(ds, str(tmp_path / 'tiles'), chunks={'y': 16, 'x': 16}, buffer=4)

    def chain(d):
        flt = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2,
                                h=3).apply(d)
        flt['change'] = ndt.OmnibusTest(ml=3, alpha=0.01).apply(flt)
        return flt
    out = {}
    for workers in (1, 4):
        out[workers] = map_over_tiles(
            str(tmp_path / 'tiles' / '*.nc'), chain,
            path=str(tmp_path / ('out%d' % workers)), max_workers=workers)
    assert out[1]['C11'].data.device.type == 'cuda'
    _bit_equal(out[4], out[1])
    names = sorted(os.listdir(tmp_path / 'out1'))
    assert names == sorted(os.listdir(tmp_path / 'out4')) and len(names) == 9
    for name in names:
        _bit_equal(*(ndt.open_dataset(str(tmp_path / d / name), device='cpu')
                     for d in ('out4', 'out1')))


# ---- the granule and the vector layer ----------------------------------------

def _fixture_grid():
    from torch_s2_fixture import grid
    return grid(10)


def test_polygon_masks_on_the_card_equal_the_cpu(cuda):
    """Seeded polygons, one with a hole, a multipolygon and one with its
    vertices on pixel centres, over a descending-y UTM grid: the card's
    masks bit-equal to the CPU's, on the card."""
    from nd_tpu_torch.ops.rasterize import polygon_mask
    from nd_tpu_torch.testing import generate_test_polygons
    from nd_tpu_torch.vector.geometry import MultiPolygon, Polygon
    xs, ys = _fixture_grid()
    xs, ys = xs[:400], ys[:300]
    extent = (xs[0], ys[-1], xs[-1], ys[0])
    polys = generate_test_polygons(30, extent=extent, random_seed=11)
    a, b = polys[0], polys[1]
    polys.append(Polygon(a.exterior.coords,
                         [[(x * 0.5 + 0.5 * a.centroid.x,
                            y * 0.5 + 0.5 * a.centroid.y)
                           for x, y in a.exterior.coords[::-1]]]))
    polys.append(MultiPolygon([a, b]))
    polys.append(Polygon([(xs[10], ys[10]), (xs[90], ys[10]),
                          (xs[50], ys[80])]))
    for geom in polys:
        got = polygon_mask(geom, xs, ys, device=cuda)
        assert got.device.type == 'cuda' and got.dtype == torch.bool
        want = polygon_mask(geom, xs, ys, device='cpu')
        assert torch.equal(got.cpu(), want)
        assert torch.equal(polygon_mask(geom, torch.as_tensor(xs,
                                        device=cuda), ys).cpu(), want)


def test_rasterize_values_on_the_card_equals_the_cpu(cuda):
    """The committed parcels' classes burned on the fixture's 10 m grid:
    the card's raster bit-equal to the CPU's; vector.rasterize of the
    shapefile onto a granule opened on the card likewise."""
    from torch_s2_fixture import GRANULE, OUT
    from nd_tpu_torch.io import open_sentinel2_granule
    from nd_tpu_torch.ops.rasterize import rasterize_values
    from nd_tpu_torch.vector import read_shapefile
    geoms, records, _ = read_shapefile(os.path.join(OUT, 'parcels.shp'))
    pairs = [(g, r['class']) for g, r in zip(geoms, records)]
    xs, ys = _fixture_grid()
    got = rasterize_values(pairs, xs, ys, fill=0, device=cuda)
    want = rasterize_values(pairs, xs, ys, fill=0, device='cpu')
    assert got.device.type == 'cuda' and got.dtype == want.dtype
    assert torch.equal(got.cpu(), want) and int(want.max()) == 4
    got_f = rasterize_values(pairs, xs, ys, fill=np.nan, device=cuda)
    want_f = rasterize_values(pairs, xs, ys, fill=np.nan, device='cpu')
    assert torch.equal(got_f.cpu().isnan(), want_f.isnan())
    assert torch.equal(torch.nan_to_num(got_f.cpu()),
                       torch.nan_to_num(want_f))
    g = open_sentinel2_granule(os.path.join(OUT, GRANULE), bands=['B04'])
    assert g['B04'].data.device.type == 'cuda'
    try:
        import pandas  # noqa: F401
    except ImportError:
        return                    # vector.rasterize builds a DataFrame
    from nd_tpu_torch.vector import rasterize
    layer = rasterize(os.path.join(OUT, 'parcels.shp'), g,
                      columns=['class'])
    assert layer['class'].data.device.type == 'cuda'
    on_cpu = rasterize(os.path.join(OUT, 'parcels.shp'),
                       open_sentinel2_granule(os.path.join(OUT, GRANULE),
                                              bands=['B04'], device='cpu'),
                       columns=['class'])
    assert torch.equal(layer['class'].data.cpu(), on_cpu['class'].data)


# ---- the device mesh on the card (chip_smoke.py P1-P4 at small sizes) ----

def _mesh22(cuda):
    from nd_tpu_torch.parallel import get_mesh
    return get_mesh((2, 2), devices=[cuda] * 4)


def _mesh_ds(cuda, ny=130, nx=98, k=6, seed=71):
    cube = torch.from_numpy(sar_cube(ny, nx, k, seed=seed,
                                     special=False)).to(cuda)
    names = ('C11', 'C12__re', 'C12__im', 'C22')
    return cube, Dataset({v: (('y', 'x', 'time'), cube[..., i])
                          for i, v in enumerate(names)})


_MESH_FILTERS = {
    'boxcar': lambda: ndt.BoxcarFilter(w=3),
    'gaussian': lambda: ndt.GaussianFilter(sigma=1.5),
    'convolution': lambda: ndt.ConvolutionFilter(
        kernel=np.random.RandomState(0).rand(3, 3)),
    'nlmeans': lambda: ndt.NLMeansFilter(r=2, f=1, sigma=2, h=3),
    'mirror': lambda: ndt.BoxcarFilter(w=3, mode='mirror'),
    'nearest': lambda: ndt.BoxcarFilter(w=3, mode='nearest'),
    'constant': lambda: ndt.BoxcarFilter(w=3, mode='constant', cval=1.5),
    'wrap': lambda: ndt.BoxcarFilter(w=5, mode='wrap'),
}


@pytest.mark.parametrize('name', sorted(_MESH_FILTERS))
def test_apply_sharded_on_the_card_equals_unsharded(cuda, name):
    """A (2, 2) mesh naming the card four times, on a grid that divides
    one axis (wrap) or neither: bit-equal to the unsharded apply, with
    four times the unsharded call's launches (one a block)."""
    from nd_tpu_torch.parallel import apply_sharded
    from nd_tpu_torch.ops import stencil_cuda
    mods = (conv_cuda, nlmeans_cuda, stencil_cuda)
    _, ds = _mesh_ds(cuda, nx=98 if name == 'wrap' else 97)
    algo = _MESH_FILTERS[name]()
    before = [m.launches for m in mods]
    ref = algo.apply(ds)
    mid = [m.launches for m in mods]
    got = apply_sharded(algo, ds, _mesh22(cuda))
    torch.cuda.synchronize()
    after = [m.launches for m in mods]
    serial = [b - a for a, b in zip(before, mid)]
    sharded = [b - a for a, b in zip(mid, after)]
    assert sum(serial) > 0 and sharded == [4 * n for n in serial]
    for v in ref.data_vars:
        assert got[v].data.device == ref[v].data.device
        assert torch.equal(got[v].data, ref[v].data), v


def test_shard_apply_multilook_and_3d_nlmeans_on_the_card(cuda):
    from nd_tpu_torch.parallel import apply_sharded, shard_apply
    cube, ds = _mesh_ds(cuda, ny=66, nx=50, k=14)
    mesh = _mesh22(cuda)
    got = shard_apply(lambda x: ndt.multilook(x, 3), cube, mesh,
                      {'y': (0, 1), 'x': (1, 1)})
    assert torch.equal(got, ndt.multilook(cube, 3))
    nlm3 = ndt.NLMeansFilter(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1,
                             sigma=2, h=3)
    before = nlmeans_cuda.launches_3d
    got = apply_sharded(nlm3, ds, mesh)
    assert nlmeans_cuda.launches_3d == before + 4
    ref = nlm3.apply(ds)
    for v in ref.data_vars:
        assert torch.equal(got[v].data, ref[v].data), v


def test_sharded_change_detection_on_the_card(cuda):
    """The README chain sharded over the (2, 2) mesh and over get_mesh()
    (every card): change maps equal to the serial OmnibusTest's."""
    from nd_tpu_torch.parallel import (apply_sharded, get_mesh,
                                       sharded_change_detection)
    _, ds = _mesh_ds(cuda, ny=61, nx=70, k=8)
    flt = apply_sharded(ndt.NLMeansFilter(r=2, f=1, sigma=2, h=3), ds,
                        _mesh22(cuda))
    serial = ndt.OmnibusTest(ml=3, alpha=0.01).apply(flt)
    assert int(serial.data.sum()) > 0
    for mesh in (_mesh22(cuda), get_mesh()):
        got = sharded_change_detection(flt, alpha=0.01, ml=3, mesh=mesh)
        assert got.data.device == serial.data.device
        assert torch.equal(got.data, serial.data)


def test_sharded_train_step_on_the_card(cuda):
    """train_step(mesh=) and make_sharded_step against the one-device
    step: loss rtol 1e-6, parameters rtol 1e-5 / atol 1e-7; one sepconv
    launch a block."""
    cube, labels = _train_cube(48, 40)
    cube = torch.from_numpy(cube).to(cuda)
    labels = torch.from_numpy(labels).to(cuda)
    model = ndt.SARChangePipeline(ml=3, n=1, alpha=0.9, lr=0.05)
    p0 = model.init_params(seed=0)
    ref_p, ref_l = model.train_step(p0, cube, labels)
    mesh = _mesh22(cuda)
    before = conv_cuda.launches
    got = [model.train_step(p0, cube, labels, mesh=mesh)]
    step, data_sh, label_sh = model.make_sharded_step(mesh, shape=(48, 40))
    got.append(step(p0, data_sh.place(cube), label_sh.place(labels)))
    assert conv_cuda.launches == before + 8
    for p, loss in got:
        assert loss.device.type == 'cuda'
        torch.testing.assert_close(loss, ref_l, rtol=1e-6, atol=0)
        for k in ('w', 'b'):
            torch.testing.assert_close(p[k], ref_p[k], rtol=1e-5, atol=1e-7)


# ---- tracing, rendering, the host oracles, the last entry points ------------

def _chip_smoke():
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return root, chip_smoke


def test_traced_chain_holds_the_readme_kernels(cuda, tmp_path):
    """chip_smoke's V1 child on a 96 x 80 x 12 cube (a process of its own:
    earlier profiler windows of a process can lose later kernel events):
    the readme_chain range of the Chrome trace holds every NLMeans,
    sepconv, round and rescan kernel event, as many as the counters rose;
    the change map equals the chain's in this process."""
    import json
    import subprocess
    import sys
    root, cs = _chip_smoke()
    cube = sar_cube(96, 80, 12, seed=41, special=False)
    np.save(str(tmp_path / 'cube.npy'), cube)
    code = ('import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; '
            'sys.exit(chip_smoke.v1_child(sys.argv[2]))')
    proc = subprocess.run([sys.executable, '-c', code, root, str(tmp_path)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    _, span, busy, inside, total = cs.trace_kernels(str(tmp_path / 'trace'),
                                                    'readme_chain')
    for fam in cs.V_FAMILIES:
        assert inside[fam] == total[fam] == res['launches'][fam] > 0, fam
    assert 0 < busy <= span
    assert {k: v['count'] for k, v in res['spans'].items()} == dict(
        README_SPANS, **{'NLMeansFilter.apply': 1, 'BoxcarFilter.apply': 1})
    t = torch.from_numpy(cube).to(cuda)
    names = ('C11', 'C12__re', 'C12__im', 'C22')
    ds = Dataset({v: (('y', 'x', 'time'), t[..., i])
                  for i, v in enumerate(names)})
    ref = ndt.OmnibusTest(ml=3, alpha=0.01).apply(
        ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3).apply(ds))
    np.testing.assert_array_equal(np.load(str(tmp_path / 'change.npy')),
                                  ref.data.cpu().numpy())


# the README chain's spans beside its Algorithm.apply spans: its data
# model's copies (data.*) and the omnibus test's steps (omnibus.*)
README_SPANS = {'OmnibusTest.apply': 1, 'data.filter_to_array': 1,
                'data.nlmeans_contiguous': 1, 'data.filter_stack': 1,
                'data.omnibus_in': 1, 'omnibus.kernel': 1,
                'omnibus.rescan': 1, 'omnibus.unpack': 1, 'omnibus.result': 1}
COPY_KERNELS = ('CatArrayBatchedCopy', 'direct_copy')


def test_every_copy_of_the_chain_is_launched_in_a_data_span(cuda, tmp_path):
    """The README chain on a 96 x 80 x 12 cube under a profiler: each
    kernel joined to its launch by correlation id; every copy kernel
    (``CatArrayBatchedCopy``, ``direct_copy``) was launched inside a
    ``data.*`` range and every kernel launched inside one is a copy;
    ``report()`` has the device time of each ``data.*`` span and of
    ``omnibus.unpack``, and the rescan's count and NLMeans's outputs (all
    on the ring route) in the counters."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from nd_tpu_torch import tracing
    cube = torch.from_numpy(sar_cube(96, 80, 12, seed=41,
                                     special=False)).to(cuda)
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i]) for i, v in
                  enumerate(('C11', 'C12__re', 'C12__im', 'C22'))})
    nlm = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3)
    omn = ndt.OmnibusTest(ml=3, alpha=0.01)
    want = omn.apply(nlm.apply(ds)).data
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = omn.apply(nlm.apply(ds)).data
        torch.cuda.synchronize()
    assert torch.equal(got, want)
    prof.export_chrome_trace(str(tmp_path / 'trace.json'))
    with open(str(tmp_path / 'trace.json')) as fh:
        events = [e for e in json.load(fh)['traceEvents']
                  if e.get('ph') == 'X']
    data = [(e['ts'], e['ts'] + e['dur']) for e in events
            if e.get('cat') == 'user_annotation'
            and e['name'].startswith('data.')]
    launch = {e['args']['correlation']: e['ts'] for e in events
              if e.get('cat') in ('cuda_runtime', 'cuda_driver')
              and 'correlation' in e.get('args', {})}
    kernels = [(e['name'], launch.get(e['args']['correlation']))
               for e in events if e.get('cat') == 'kernel']
    assert kernels and all(t is not None for _, t in kernels)
    copies = [n for n, _ in kernels if any(c in n for c in COPY_KERNELS)]
    in_data = [any(a <= t <= b for a, b in data) for _, t in kernels]
    assert len(data) == 4 and len(copies) >= 4
    assert [n for (n, _), inside in zip(kernels, in_data) if inside] \
        == copies
    rep = tracing.report()
    assert {k: v['count'] for k, v in rep.items()} == dict(
        README_SPANS, **{'NLMeansFilter.apply': 1, 'BoxcarFilter.apply': 1})
    for name in [k for k in README_SPANS if k.startswith('data.')] + [
            'omnibus.unpack']:
        assert rep[name]['device'] > 0, name
    assert rep['OmnibusTest.apply']['device'] > rep['omnibus.unpack'][
        'device']
    looked = ndt.BoxcarFilter(w=3).apply(nlm.apply(ds))   # the test's input
    _, suspects = tchange.change_detection_exact(
        torch.stack([looked[v].data for v in
                     ('C11', 'C12__re', 'C12__im', 'C22')], -1),
        0.01, n=9, return_count=True)
    assert tracing.counters() == {'omnibus.pixels': 96 * 80,
                                  'omnibus.rescanned': suspects,
                                  'nlmeans.outputs': 96 * 80 * 12,
                                  'nlmeans.outputs_ring': 96 * 80 * 12}


@pytest.mark.parametrize('case', ['percentiles', 'limits', 'count', 'nan'])
def test_to_rgb_device_part_equals_the_cpu(cuda, case):
    """to_rgb's stretch on the card equals the CPU's bit for bit (float64
    division by a device 0-dim divisor, numpy's lerp) and stays there."""
    from nd_tpu_torch import visualize
    g = torch.Generator().manual_seed(3)
    chans = [torch.rand(300, 257, generator=g, dtype=torch.float32) * 5
             for _ in range(2)]
    kw = {}
    if case == 'limits':
        kw = dict(vmin=[0.3, 1, 0.1], vmax=[4.7, 2, 3.3])
    elif case == 'count':
        chans = [torch.randint(0, 13, (300, 257), generator=g)]
    elif case == 'nan':
        chans[0][chans[0] < 0.4] = float('nan')
    def image(cs):
        return visualize._bgr(cs + [cs[0] / cs[1]] if len(cs) == 2 else cs,
                              **kw)
    got = image([c.to(cuda) for c in chans])
    assert got.device.type == 'cuda' and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), image(chans))


@pytest.mark.parametrize('k', [12, 40, 60])
def test_hybrid_numpy_delivery_on_the_card(cuda, k):
    from nd_tpu_torch.ops.change import change_detection_hybrid
    cube = sar_cube(41, 37, k, seed=k) if k <= 48 \
        else long_stack_cube(41, 37, k, seed=k)
    got = change_detection_hybrid(cube, 0.99, n=9)          # lands on cuda
    assert isinstance(got, np.ndarray) and got.dtype == np.bool_
    ref = tchange.change_detection_exact(torch.from_numpy(cube).to(cuda),
                                         0.99, n=9)
    np.testing.assert_array_equal(got, ref.cpu().numpy())
    dev = change_detection_hybrid(torch.from_numpy(cube).to(cuda), 0.99,
                                  n=9, return_device=True)
    assert dev.device.type == 'cuda' and torch.equal(dev, ref)


def test_classifier_train_step_on_the_card_equals_the_cpu(cuda):
    """Three train_steps with torch Adam: loss rtol 1e-5, parameters
    within 1e-4 of each tensor's largest magnitude (plus 1e-6)."""
    g = torch.Generator().manual_seed(5)
    X = torch.randn(5000, 7, generator=g)
    y = (X[:, 0] - X[:, 3] > 0.2).long()
    clf = ndt.TorchClassifier(hidden=(16,), lr=0.05)
    start = clf._init_params(7, 2, 'cpu')
    out = []
    for where in (cuda, torch.device('cpu')):
        leaves = [a.to(where).clone().requires_grad_(True)
                  for pair in start for a in pair]
        opt = torch.optim.Adam(leaves, lr=0.05)
        params, state = [tuple(a.to(where) for a in pair)
                         for pair in start], None
        losses = []
        for _ in range(3):
            params, state, loss = clf.train_step(params, state, X.to(where),
                                                 y.to(where), opt)
            losses.append(loss)
        out.append((params, losses))
    (gp, gl), (rp, rl) = out
    assert gl[0].device.type == 'cuda'
    for a, b in zip(gl, rl):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=0)
    for gpair, rpair in zip(gp, rp):
        for g_, r_ in zip(gpair, rpair):
            assert g_.device.type == 'cuda'
            assert float((g_.cpu() - r_).abs().max()) \
                <= 1e-4 * float(r_.abs().max()) + 1e-6


def test_host_oracles_against_the_card(cuda):
    """native.nlmeans_native and native.change_detection_native (host
    C++) against the NLMeans kernel (rtol 1e-5, atol 1e-6) and the exact
    mode on the card (0 mismatches)."""
    from nd_tpu_torch import native
    cube = sar_cube(64, 70, 12, seed=13, special=False)
    t = torch.from_numpy(cube).to(cuda)
    nl = nlmeans_cuda.nlmeans_spatial(t, (1, 1), (1, 1), 2.0, 3.0)
    ref = native.nlmeans_native(cube, (1, 1, 0), (1, 1, 0), 2.0, 3.0)
    torch.testing.assert_close(nl.cpu(), torch.from_numpy(ref), rtol=1e-5,
                               atol=1e-6)
    got = tchange.change_detection_exact(t, 0.99, n=9).cpu().numpy()
    np.testing.assert_array_equal(
        got, native.change_detection_native(cube, 0.99, n=9))


# -- F10, F11, F13b: the repaired payload faults on the card ------------------

def _complex_series(dtype=torch.complex128, shape=(33, 41, 12), seed=21):
    rng = np.random.RandomState(seed)
    re = rng.randint(-3, 4, shape).astype(np.float64)
    im = rng.randint(-3, 4, shape).astype(np.float64)
    re[rng.rand(*shape) < 0.05] = np.nan
    im[rng.rand(*shape) < 0.05] = np.nan
    re[2, 3], im[2, 3] = np.nan, np.nan            # an all-NaN series
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(
        dtype)


def _same_on_both(got, ref, exact):
    """The card's result against the CPU's: bit for bit (NaN where NaN)
    or, where the two sum in another order, within rtol 1e-5, atol 1e-6
    (float32 parts) or rtol 1e-12 (float64)."""
    assert got.device.type == 'cuda' and got.dtype == ref.dtype
    got = got.cpu()
    if not (ref.is_floating_point() or ref.is_complex()):
        assert torch.equal(got, ref)
        return
    parts = (lambda t: (t.real, t.imag)) if ref.is_complex() \
        else (lambda t: (t,))
    for g, r in zip(parts(got), parts(ref)):
        tol = dict(rtol=0.0, atol=0.0) if exact else \
            dict(rtol=1e-5, atol=1e-6) if r.dtype == torch.float32 else \
            dict(rtol=1e-12, atol=0.0)
        torch.testing.assert_close(g, r, equal_nan=True, **tol)


COMPLEX_CALLS = {
    'mean': (lambda o: o.mean('time'), False),
    'std': (lambda o: o.std('time'), False),
    'sum': (lambda o: o.sum('time'), False),
    'prod': (lambda o: o.prod('time'), False),
    'cumsum': (lambda o: o.cumsum('time'), False),
    'median': (lambda o: o.median('time'), True),
    'max': (lambda o: o.max('time'), True),
    'min': (lambda o: o.min(('y', 'x')), True),
    'argmax': (lambda o: o.argmax('time'), True),
    'argmin': (lambda o: o.argmin('x'), True),
    'diff': (lambda o: o.diff('time'), True),
    'sub': (lambda o: o - o.isel(time=0), True),
    'clip': (lambda o: o.clip(-1 + 1j, 2), True),
    'round': (lambda o: (o / 3).round(2), True),
    'lt': (lambda o: o < (1 + 1j), True),
}


@pytest.mark.parametrize('dtype', [torch.complex64, torch.complex128])
@pytest.mark.parametrize('name', sorted(COMPLEX_CALLS))
def test_complex_payload_on_the_card_equals_the_cpu(cuda, name, dtype):
    from nd_tpu_torch.core import DataArray
    call, exact = COMPLEX_CALLS[name]
    data = _complex_series(dtype)
    got = call(DataArray(data.to(cuda), dims=('y', 'x', 'time')))
    ref = call(DataArray(data, dims=('y', 'x', 'time')))
    assert got.dims == ref.dims
    _same_on_both(got.data, ref.data, exact)


INT_CALLS = {
    'int32 round': (torch.int32, lambda o: o.round(), torch.int32),
    'int32 round(-1)': (torch.int32, lambda o: o.round(-1), torch.int32),
    'uint8 round': (torch.uint8, lambda o: o.round(), torch.uint8),
    'bool round': (torch.bool, lambda o: o.round(), torch.float16),
    'bool argmax': (torch.bool, lambda o: o.argmax('time'), torch.int64),
    'bool argmin': (torch.bool, lambda o: o.argmin('x'), torch.int64),
    'int32 clip': (torch.int32, lambda o: o.clip(2, 7.5), torch.float64),
    'int32 + 1.5': (torch.int32, lambda o: o + 1.5, torch.float64),
    'int32 ** 0.5': (torch.int32, lambda o: o ** 0.5, torch.float64),
    'int32 ** 2': (torch.int32, lambda o: o ** 2, torch.int32),
    'uint16 * 1e-4': (torch.uint16, lambda o: o * 1e-4, torch.float64),
    'uint16 + 1000': (torch.uint16, lambda o: o + 1000, torch.uint16),
    'int32 + float32': (torch.int32, lambda o: o + o.astype('float32'),
                        torch.float64),
    'int8 + float32': (torch.int8, lambda o: o + o.astype('float32'),
                       torch.float32),
    'bool + float32': (torch.bool, lambda o: o + o.astype('float32'),
                       torch.float32),
    'int32 / int32': (torch.int32, lambda o: o / (o + 1), torch.float64),
}


@pytest.mark.parametrize('name', sorted(INT_CALLS))
def test_integer_and_bool_payload_on_the_card_equals_the_cpu(cuda, name):
    from nd_tpu_torch.core import DataArray
    dtype, call, expect = INT_CALLS[name]
    vals = np.random.RandomState(22).randint(0, 9, (17, 23, 6))
    data = torch.from_numpy(vals > 4) if dtype == torch.bool \
        else torch.from_numpy(vals).to(dtype)
    got = call(DataArray(data.to(cuda), dims=('y', 'x', 'time')))
    ref = call(DataArray(data, dims=('y', 'x', 'time')))
    assert got.dtype == ref.dtype == expect
    # the card's float64 pow rounds otherwise than the CPU's
    _same_on_both(got.data, ref.data, name != 'int32 ** 0.5')
