"""``classify``: nd_tpu_torch against nd_tpu.

Counterparts of tests/test_classify.py on the port (the sklearn bridge
``Classifier`` and ``TorchClassifier`` in place of ``JaxClassifier``),
then parity on the same mock cube: ``_build_X``, ``_broadcast_labels``
and ``class_mean`` equal to nd_tpu's (class means rtol 1e-12: the same
float64 sums in another order); ``Classifier(LogisticRegression)``
predictions equal; ``TorchClassifier`` from ``JaxClassifier``'s initial
parameters within rtol 1e-4, atol 1e-6 of its parameters after 20 Adam
epochs (the JAX package keeps ``w`` in float64, the port in float32),
with equal predictions; ``TorchClassifier.train_step`` (torch Adam)
against ``JaxClassifier.train_step`` (optax Adam) from the same
parameters, losses rtol 1e-5, parameters rtol 1e-4, atol 1e-6; and the
``ds.nd.classify`` accessor.
"""

import numpy as np
import pytest
import torch

from nd_tpu.classify import Classifier as JClassifier
from nd_tpu.classify import JaxClassifier
from nd_tpu.classify import _broadcast_labels as j_broadcast_labels
from nd_tpu.classify import _build_X as j_build_X
from nd_tpu.classify import class_mean as jclass_mean
from nd_tpu.core import DataArray as JDataArray
from nd_tpu.testing import create_mock_classes as jmock
from nd_tpu.testing import generate_test_dataset as jgen
from nd_tpu_torch.classify import (Classifier, TorchClassifier,
                                   _broadcast_labels, _build_X, class_mean)
from nd_tpu_torch.core import DataArray
from nd_tpu_torch.testing import create_mock_classes, generate_test_dataset

DIMS = {'y': 30, 'x': 30, 'time': 4}


@pytest.fixture
def mock():
    return create_mock_classes(dims=DIMS, device='cpu')


def _truth(labels, ds):
    return _broadcast_labels(labels, ds).values


# -- tests/test_classify.py on the port ---------------------------------------

def test_build_X_shape():
    ds = generate_test_dataset(dims={'y': 10, 'x': 12, 'time': 3},
                               device='cpu')
    X = _build_X(ds)
    assert tuple(X.shape) == (10 * 12 * 3, 4)
    X2 = _build_X(ds, feature_dims=['time'])
    assert tuple(X2.shape) == (10 * 12, 4 * 3)


def test_broadcast_labels():
    ds = generate_test_dataset(dims={'y': 10, 'x': 12, 'time': 3},
                               device='cpu')
    labels = DataArray(np.ones((10, 12)), dims=('y', 'x'),
                       coords={'y': ds['y'].values, 'x': ds['x'].values},
                       device='cpu')
    b = _broadcast_labels(labels, ds)
    assert set(b.dims) == {'y', 'x', 'time'}


def test_supervised_classification(mock):
    from sklearn.linear_model import LogisticRegression
    ds, labels = mock
    c = Classifier(LogisticRegression(max_iter=200))
    c.fit(ds, labels)
    pred = c.predict(ds)
    assert set(pred.dims) == {'y', 'x', 'time'}
    assert (pred.values == _truth(labels, ds)).mean() > 0.95


def test_predict_proba(mock):
    from sklearn.linear_model import LogisticRegression
    ds, labels = mock
    c = Classifier(LogisticRegression(max_iter=200))
    c.fit(ds, labels)
    proba = c.predict(ds, func='predict_proba')
    assert 'label' in proba.dims
    sums = proba.values.sum(axis=proba.dims.index('label'))
    np.testing.assert_allclose(sums, 1.0, atol=1e-6)


def test_unsupervised_clustering(mock):
    from sklearn.cluster import KMeans
    ds, labels = mock
    c = Classifier(KMeans(n_clusters=2, n_init=5, random_state=0))
    p = c.fit_predict(ds).values
    truth = _truth(labels, ds)
    # clusters must align with classes up to permutation
    acc = max(((p == 0) == (truth == 1)).mean(),
              ((p == 1) == (truth == 1)).mean())
    assert acc > 0.95


def test_nan_handling(mock):
    from sklearn.linear_model import LogisticRegression
    ds, labels = mock
    dsn = ds.copy()
    for v in dsn.data_vars:
        data = dsn[v].data.clone()
        data[:3, :3, :] = float('nan')
        dsn[v] = (dsn[v].dims, data)
    c = Classifier(LogisticRegression(max_iter=200))
    c.fit(dsn, labels)
    pred = c.predict(dsn)
    assert np.isnan(pred.values[:3, :3, :]).all()


def test_scaling(mock):
    from sklearn.linear_model import LogisticRegression
    ds, labels = mock
    c = Classifier(LogisticRegression(max_iter=200), scale=True)
    c.fit(ds, labels)
    assert c._scaler is not None
    assert (c.predict(ds).values == _truth(labels, ds)).mean() > 0.95


def test_score(mock):
    from sklearn.linear_model import LogisticRegression
    ds, labels = mock
    c = Classifier(LogisticRegression(max_iter=200))
    c.fit(ds, labels)
    assert c.score(ds, labels) > 0.95
    with pytest.raises(ValueError):
        c.score(ds, labels, method='no such scorer')


def test_feature_dims(mock):
    from sklearn.linear_model import LogisticRegression
    ds, labels = mock
    c = Classifier(LogisticRegression(max_iter=200), feature_dims=['time'])
    c.fit(ds, labels)
    assert set(c.predict(ds).dims) == {'y', 'x'}


def test_class_mean(mock):
    ds, labels = mock
    means = class_mean(ds, labels)
    v = list(ds.data_vars)[0]
    m1 = means[v].values[labels.values == 1]
    assert np.allclose(m1, m1.ravel()[0])


def test_torch_classifier(mock):
    ds, labels = mock
    pred = TorchClassifier(epochs=200, lr=0.05).fit_predict(ds, labels)
    assert (pred.values == _truth(labels, ds)).mean() > 0.95


def test_torch_classifier_proba(mock):
    ds, labels = mock
    c = TorchClassifier(epochs=100, lr=0.05)
    c.fit(ds, labels)
    proba = c.predict(ds, func='predict_proba')
    assert 'label' in proba.dims
    np.testing.assert_allclose(proba.values.sum(-1), 1.0, atol=1e-6)


def test_torch_classifier_wide_n_classes():
    """Explicit n_classes wider than the observed labels: surplus
    (untrained) output columns must never win predictions."""
    ds, labels = create_mock_classes(device='cpu')
    c = TorchClassifier(n_classes=5, epochs=20)
    c.fit(ds, labels)
    vals = c.predict(ds).values
    observed = set(np.unique(labels.values))
    assert set(np.unique(vals[~np.isnan(vals)])).issubset(observed)


def test_torch_classifier_too_many_classes_raises():
    ds, labels = create_mock_classes(device='cpu')
    with pytest.raises(ValueError):
        TorchClassifier(n_classes=1, epochs=1).fit(ds, labels)


def test_torch_classifier_unknown_func_raises():
    ds, labels = create_mock_classes(device='cpu')
    c = TorchClassifier(epochs=5)
    with pytest.raises(RuntimeError):
        c.predict(ds)
    c.fit(ds, labels)
    with pytest.raises(AttributeError):
        c.predict(ds, func='predict_probab')


# -- against nd_tpu -----------------------------------------------------------

@pytest.fixture
def both():
    jds, jlabels = jmock(dims=DIMS)
    ds, labels = create_mock_classes(dims=DIMS, device='cpu')
    return jds, jlabels, ds, labels


def test_mock_classes_match(both):
    jds, jlabels, ds, labels = both
    assert list(ds.data_vars) == list(jds.data_vars)
    for v in ds.data_vars:
        assert ds[v].dims == jds[v].dims
        np.testing.assert_array_equal(ds[v].values, np.asarray(jds[v].values))
    np.testing.assert_array_equal(labels.values, np.asarray(jlabels.values))
    assert labels.dims == jlabels.dims


@pytest.mark.parametrize('feature_dims', [[], ['time']])
def test_build_X_matches(both, feature_dims):
    jds, _, ds, _ = both
    np.testing.assert_array_equal(
        _build_X(ds, feature_dims).numpy(),
        np.asarray(j_build_X(jds, feature_dims)))
    np.testing.assert_array_equal(
        _build_X(ds['C11'], feature_dims).numpy(),
        np.asarray(j_build_X(jds['C11'], feature_dims)))


@pytest.mark.parametrize('form', ['dataarray', 'numpy', 'transposed'])
def test_broadcast_labels_matches(both, form):
    jds, jlabels, ds, labels = both
    if form == 'dataarray':
        jl, tl = jlabels, labels
    elif form == 'numpy':
        jl = tl = np.asarray(jlabels.values)
    else:
        jl = JDataArray(np.asarray(jlabels.values).T, dims=('x', 'y'))
        tl = DataArray(labels.values.T, dims=('x', 'y'), device='cpu')
    ref = j_broadcast_labels(jl, jds)
    got = _broadcast_labels(tl, ds)
    if form == 'numpy':
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert got.dims == ref.dims
        np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    with pytest.raises(ValueError):
        _broadcast_labels(np.ones((7, 30)), ds)


def test_class_mean_matches(both):
    jds, jlabels, ds, labels = both
    # NaN pixels of both classes exercise the sequential fill
    for d in (jds, ds):
        for v in d.data_vars:
            data = np.array(d[v].values)
            data[:2, :2, 0] = np.nan
            data[-2:, -2:, 1] = np.nan
            d[v] = (d[v].dims, torch.from_numpy(data) if d is ds else data)
    ref = jclass_mean(jds, jlabels)
    got = class_mean(ds, labels)
    for v in ds.data_vars:
        np.testing.assert_allclose(got[v].values, np.asarray(ref[v].values),
                                   rtol=1e-12)


@pytest.mark.parametrize('scale', [False, True])
def test_logistic_regression_predictions_equal(both, scale):
    from sklearn.linear_model import LogisticRegression
    jds, jlabels, ds, labels = both
    for d in (jds, ds):
        for v in d.data_vars:
            data = np.array(d[v].values)
            data[:3, :3, :] = np.nan
            d[v] = (d[v].dims, torch.from_numpy(data) if d is ds else data)
    ref = JClassifier(LogisticRegression(max_iter=200), scale=scale) \
        .fit_predict(jds, jlabels)
    got = Classifier(LogisticRegression(max_iter=200), scale=scale) \
        .fit_predict(ds, labels)
    assert got.dims == ref.dims
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    np.testing.assert_array_equal(got['y'].values, np.asarray(ref['y'].values))


@pytest.mark.parametrize('hidden', [(), (16,), (8, 4)])
def test_torch_classifier_matches_jax_classifier(both, hidden):
    jds, jlabels, ds, labels = both
    jc = JaxClassifier(hidden=hidden, epochs=20, lr=0.05)
    start = jc._init_params(4, 2)
    jc._init_params = lambda n_features, n_classes: start
    jc.fit(jds, jlabels)
    tc = TorchClassifier(hidden=hidden, epochs=20, lr=0.05)
    tc.load_params([tuple(np.asarray(a) for a in pair) for pair in start])
    tc.fit(ds, labels)
    assert len(tc.params) == len(jc.params) == len(hidden) + 1
    for (tw, tb), (jw, jb) in zip(tc.params, jc.params):
        assert tw.dtype == tb.dtype == torch.float32
        assert tuple(tw.shape) == np.shape(jw)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_array_equal(tc.predict(ds).values,
                                  np.asarray(jc.predict(jds).values))
    np.testing.assert_allclose(
        tc.predict(ds, func='predict_proba').values,
        np.asarray(jc.predict(jds, func='predict_proba').values),
        rtol=1e-4, atol=1e-6)


def test_loaded_params_of_the_wrong_shape_raise(mock):
    ds, labels = mock
    c = TorchClassifier(hidden=(3,), epochs=1)
    c.load_params([(np.zeros((5, 3)), np.zeros(3)),
                   (np.zeros((3, 2)), np.zeros(2))])
    with pytest.raises(ValueError, match='shapes'):
        c.fit(ds, labels)


def test_he_init_is_seeded_on_the_cpu():
    a = TorchClassifier(hidden=(16,), seed=3)._init_params(7, 2, 'cpu')
    b = TorchClassifier(hidden=(16,), seed=3)._init_params(7, 2, 'cpu')
    assert all(torch.equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))
    assert tuple(a[0][0].shape) == (7, 16) and tuple(a[1][0].shape) == (16, 2)
    assert 0.3 < float(a[0][0].std()) * np.sqrt(7 / 2.0) < 1.7


def test_nd_classify_accessor(both):
    from sklearn.linear_model import LogisticRegression
    jds, jlabels, ds, labels = both
    ref = jds.nd.classify(LogisticRegression(max_iter=200), jlabels)
    got = ds.nd.classify(LogisticRegression(max_iter=200), labels)
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    got = ds.nd.classify(LogisticRegression(max_iter=200), labels,
                         feature_dims=['time'])
    assert set(got.dims) == {'y', 'x'}


@pytest.mark.parametrize('hidden', [(), (16,), (8, 4)])
def test_train_step_matches_jax_train_step(hidden):
    """Five ``train_step`` calls with ``torch.optim.Adam`` against
    ``JaxClassifier.train_step`` with ``optax.adam`` from JAX's initial
    parameters on the same standardised design matrix: losses rtol 1e-5,
    parameters rtol 1e-4 / atol 1e-6 (the fit's contract above);
    ``opt_state`` is the optimizer's ``state_dict()``."""
    import jax.numpy as jnp
    import optax
    rng = np.random.RandomState(4)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int32)
    jc = JaxClassifier(hidden=hidden, lr=0.05)
    jp = jc._init_params(5, 2)
    jopt = optax.adam(0.05)
    jstate = jopt.init(jp)
    tc = TorchClassifier(hidden=hidden, lr=0.05)
    tp = [tuple(torch.from_numpy(np.array(a, np.float32)) for a in pair)
          for pair in jp]
    leaves = [a.clone().requires_grad_(True) for pair in tp for a in pair]
    topt = torch.optim.Adam(leaves, lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    tstate = None
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y).long()
    for _ in range(5):
        jp, jstate, jloss = jc.train_step(jp, jstate, jnp.asarray(X),
                                          jnp.asarray(y), jopt)
        tp, tstate, tloss = tc.train_step(tp, tstate, Xt, yt, topt)
        assert tloss.shape == () and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert isinstance(tstate, dict) and set(tstate) == {'state',
                                                        'param_groups'}
    assert int(tstate['state'][0]['step']) == 5
    for (tw, tb), (jw, jb) in zip(tp, jp):
        assert not tw.requires_grad and tw.dtype == torch.float32
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-4,
                                   atol=1e-6)


def test_train_step_with_no_state_starts_afresh():
    """``opt_state=None`` is a fresh optimizer state, as JAX's
    ``train_step`` is pure in ``opt_state``: two None calls from the same
    parameters on one optimizer that has already stepped give equal
    losses and parameters (exactly), each with Adam's step count 1; the
    state passed in is left as it was."""
    rng = np.random.RandomState(5)
    X = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    y = torch.from_numpy((rng.normal(size=64) > 0).astype(np.int64))
    tc = TorchClassifier(hidden=(3,), lr=0.05)
    start = tc._init_params(4, 2, 'cpu')
    leaves = [a.clone().requires_grad_(True) for pair in start for a in pair]
    opt = torch.optim.Adam(leaves, lr=0.05)
    p1, s1, l1 = tc.train_step(start, None, X, y, opt)
    tc.train_step(p1, s1, X, y, opt)
    p2, s2, l2 = tc.train_step(start, None, X, y, opt)
    assert float(l1) == float(l2)
    assert int(s1['state'][0]['step']) == int(s2['state'][0]['step']) == 1
    for a, b in zip(p1, p2):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_train_step_checks_the_optimizer():
    tc = TorchClassifier()
    params = [(torch.zeros(3, 2), torch.zeros(2))]
    opt = torch.optim.Adam([torch.zeros(3, 2, requires_grad=True)])
    with pytest.raises(ValueError, match='holds 1 tensors, params 2'):
        tc.train_step(params, None, torch.zeros(4, 3),
                      torch.zeros(4, dtype=torch.long), opt)
