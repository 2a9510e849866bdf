"""nd_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither JAX nor nd_tpu, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: sepconv max abs diff <= 1e-6 max|x| (1e-13 in float64);
NLMeans rtol 1e-5, atol 1e-6; omnibus flag mismatch rate <= 1e-5 and
margins within 1e-4 relative; exact and pipeline change maps exactly
equal.
"""

import os

import numpy as np
import pytest
import torch

import nd_tpu_torch as ndt
from nd_tpu_torch import _build
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_cuda, conv_cuda, nlmeans_cuda
from torch_cubes import cuda, sar_cube  # noqa: F401

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
    got = tchange.change_detection_exact(cube, 0.99, n=9)
    ref = tchange.change_detection(cube, 0.99, n=9)
    assert got.device.type == 'cuda'
    assert bool((got == ref).all())


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
            torch.zeros(5, 5, 1, 1, device=cuda, dtype=torch.float16),
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
