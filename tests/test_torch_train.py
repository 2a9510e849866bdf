"""The flagship model's training step: nd_tpu_torch against nd_tpu.

``omnibus_probabilities``, ``change_features``, ``loss``, the head's
gradient and ``train_step`` run on the same seeded inputs through both
packages; the port starts from JAX's ``init_params()`` carried across by
``params_from_jax``. Tolerances: float64 probabilities atol 1e-9
(``torch.special.gammainc`` in float64 errs by about 4e-10); float32
probabilities atol 2e-5 to nd_tpu and 1.5e-5 to nd_tpu's float64
result of the same input (both packages round the statistic z, a
difference of terms of some hundreds at 9 looks, in float32: each lands
4-9e-6 from the float64 value, and up to 1.2e-5 apart); features rtol
1e-5, atol 2e-5 (the probability column as above); loss rtol 1e-5;
gradient and parameters after 15 steps rtol 1e-4, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nd_tpu.models import SARChangePipeline as JPipeline
from nd_tpu.models import change_features as jchange_features
from nd_tpu.ops.change import omnibus_probabilities as jprob
import nd_tpu_torch as ndt
from nd_tpu_torch.models import change_features
from nd_tpu_torch.ops.change import omnibus_probabilities
from torch_cubes import sar_cube


def _cube(ny=32, nx=32, k=6, seed=0):
    """tests/test_models.py's cube: a 3x backscatter step half-way."""
    rng = np.random.RandomState(seed)
    cube = np.abs(rng.normal(1.0, 0.2, size=(ny, nx, k, 4))) \
        .astype(np.float32)
    cube[..., 1] *= 0.05
    cube[..., 2] *= 0.05
    cube[:, :, k // 2:, 0] += 2.0
    cube[:, :, k // 2:, 3] += 2.0
    return cube


def _labels(ny=32, nx=32, masked=True):
    labels = ((np.arange(ny)[:, None] + np.arange(nx)[None, :]) % 2) \
        .astype(np.int32)
    if masked:
        labels[:2] = -1
        labels[:, -3:] = -1
    return labels


def _pair(n_classes=2, lr=0.1, seed=0):
    jp = JPipeline(ml=3, alpha=0.9, n_classes=n_classes, lr=lr)
    tp = ndt.SARChangePipeline(ml=3, alpha=0.9, n_classes=n_classes, lr=lr)
    jparams = jp.init_params(seed)
    tparams = tp.params_from_jax(jparams, device='cpu')
    return jp, tp, jparams, tparams


@pytest.mark.parametrize('k', [6, 12])
@pytest.mark.parametrize('seed', [1, 2])
def test_omnibus_probabilities_float64(k, seed):
    cube = sar_cube(24, 31, k, seed=seed, special=False).astype(np.float64)
    got = omnibus_probabilities(torch.from_numpy(cube), n=9)
    ref = np.asarray(jprob(jnp.asarray(cube), n=9))
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize('k', [6, 12])
@pytest.mark.parametrize('seed', [1, 2])
def test_omnibus_probabilities_float32(k, seed):
    cube = sar_cube(24, 31, k, seed=seed, special=False)
    got = omnibus_probabilities(torch.from_numpy(cube), n=9)
    assert got.dtype == torch.float32
    ref = np.asarray(jprob(jnp.asarray(cube), n=9))
    ref64 = np.asarray(jprob(jnp.asarray(cube.astype(np.float64)), n=9))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref64, rtol=0, atol=1.5e-5)


@pytest.mark.parametrize('n', [1, 9, 4.5])
def test_omnibus_probabilities_degenerate_pixels(n):
    """Negative and zero determinants, a NaN and a constant series: NaN
    exactly where nd_tpu gives NaN."""
    cube = sar_cube(6, 7, 12, seed=3, special=True).astype(np.float64)
    cube[3, 3] = (1.0, 2.0, 0.0, 1.0)        # det of the sum < 0
    cube[4, 4, :, 1:3] = 0.0
    cube[4, 4, :, 3] = 0.0                   # every det 0
    got = omnibus_probabilities(torch.from_numpy(cube), n=n).numpy()
    ref = np.asarray(jprob(jnp.asarray(cube), n=n))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref).sum() >= 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_change_features(dtype):
    cube = _cube().astype(dtype)
    got = change_features(torch.from_numpy(cube), n=9)
    ref = np.asarray(jchange_features(jnp.asarray(cube), n=9))
    assert got.shape == ref.shape == (32, 32, 7)
    assert got.dtype == torch.from_numpy(cube).dtype
    assert torch.isfinite(got).all()
    tol = dict(rtol=1e-5, atol=2e-5) if dtype == np.float32 \
        else dict(rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.numpy(), ref, **tol)


def test_change_features_std_is_ddof_0_and_nan_probability_is_0():
    cube = sar_cube(5, 6, 8, seed=4, special=True)
    cube = np.nan_to_num(cube, nan=1.0)
    feats = change_features(torch.from_numpy(cube), n=9).numpy()
    np.testing.assert_allclose(feats[..., 1], cube[..., 0].std(-1),
                               rtol=1e-5)
    ref = np.asarray(jchange_features(jnp.asarray(cube), n=9))
    assert feats[0, 0, 6] == ref[0, 0, 6] == 0.0      # negative det
    np.testing.assert_allclose(feats, ref, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('n_classes', [2, 3])
def test_loss_and_gradient(masked, n_classes):
    jp, tp, jparams, tparams = _pair(n_classes=n_classes)
    looked = np.asarray(ndt.multilook(torch.from_numpy(_cube()), 3))
    labels = _labels(masked=masked)
    jloss, jgrad = jax.value_and_grad(jp.loss)(jparams, jnp.asarray(looked),
                                               jnp.asarray(labels))
    tloss = tp.loss(tparams, torch.from_numpy(looked),
                    torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    feats = tp.features(torch.from_numpy(looked))
    grads = torch.autograd.grad(tp.head_loss(leaves, feats,
                                             torch.from_numpy(labels)),
                                [leaves['w'], leaves['b']])
    for g, k in zip(grads, ('w', 'b')):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-4, atol=1e-6)


def test_fifteen_train_steps_match_and_the_loss_falls():
    jp, tp, jparams, tparams = _pair(lr=0.1)
    cube = _cube()
    labels = _labels(masked=False)
    step = jax.jit(jp.train_step)
    jlosses, tlosses = [], []
    for _ in range(15):
        jparams, jl = step(jparams, jnp.asarray(cube), jnp.asarray(labels))
        tparams, tl = tp.train_step(tparams, torch.from_numpy(cube),
                                    torch.from_numpy(labels))
        jlosses.append(float(jl))
        tlosses.append(float(tl))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for k in ('w', 'b'):
        assert tparams[k].dtype == torch.float32
        np.testing.assert_allclose(tparams[k].numpy(),
                                   np.asarray(jparams[k]), rtol=1e-4,
                                   atol=1e-6)
    # tests/test_models.py's assertions, on the port
    assert tlosses[-1] < tlosses[0]
    assert np.isfinite(tlosses).all()


def test_masked_labels_train_and_all_masked_gives_zero_loss():
    jp, tp, jparams, tparams = _pair()
    cube = _cube(16, 16)
    labels = _labels(16, 16)
    jnew, jl = jp.train_step(jparams, jnp.asarray(cube), jnp.asarray(labels))
    tnew, tl = tp.train_step(tparams, torch.from_numpy(cube),
                             torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ('w', 'b'):
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=1e-4, atol=1e-6)
    none = np.full((16, 16), -1, np.int32)
    _, tl = tp.train_step(tparams, torch.from_numpy(cube),
                          torch.from_numpy(none))
    assert float(tl) == 0.0


def test_init_params_is_seeded_on_the_cpu():
    tp = ndt.SARChangePipeline(n_classes=3)
    a = tp.init_params(seed=5, device='cpu')
    b = tp.init_params(seed=5, device='cpu')
    c = tp.init_params(seed=6, device='cpu')
    assert a['w'].shape == (7, 3) and a['b'].shape == (3,)
    assert a['w'].dtype == a['b'].dtype == torch.float32
    assert torch.equal(a['w'], b['w']) and not torch.equal(a['w'], c['w'])
    assert float(a['b'].abs().sum()) == 0.0
    assert 0.02 < float(a['w'].std()) < 0.3


def test_params_from_jax_checks_shapes():
    jp, tp, jparams, _ = _pair(n_classes=3)
    got = tp.params_from_jax(jparams, device='cpu')
    for k in ('w', 'b'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jparams[k]))
    with pytest.raises(ValueError):
        ndt.SARChangePipeline(n_classes=2).params_from_jax(jparams,
                                                           device='cpu')
