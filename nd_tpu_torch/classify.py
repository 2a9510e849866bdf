"""Classification and clustering on datacubes.

Counterpart of ``nd_tpu/classify.py``: the ``Classifier`` wrapper
marshals datacubes into (samples, features) design matrices for any
scikit-learn estimator, with NaN masking, label broadcasting and
optional scaling; it goes through numpy, as scikit-learn does.

:class:`TorchClassifier` is the counterpart of the JAX package's
``JaxClassifier``: a full-batch trainer (Adam) for logistic-regression /
MLP heads whose design matrix, masks, class ids, parameters and
predictions stay on the cube's device.
"""

from __future__ import annotations

import copy
from collections import OrderedDict

import numpy as np
import torch

from . import utils
from .core import DataArray, Dataset
from .core.variable import as_tensor
from .ops.interp import full_f32_matmul

try:
    from sklearn import metrics, preprocessing
except ImportError:  # pragma: no cover  (the card's machine has none)
    metrics = preprocessing = None

__all__ = ['Classifier', 'TorchClassifier', 'class_mean']


def _device(ds):
    """The device of the first tensor-backed variable of ``ds``."""
    for da in ([ds] if isinstance(ds, DataArray)
               else list(ds.data_vars.values())):
        if isinstance(da.data, torch.Tensor):
            return da.data.device
    return torch.device('cpu')


def class_mean(ds, labels):
    """Replace every pixel with the mean of its class.

    Parameters
    ----------
    ds : Dataset
    labels : DataArray
        Class label per pixel; label dims may be a subset of data dims.
    """
    # Deliberate parity with the reference's sequential fillna loop
    # (the JAX package's class_mean): each class's fill step replaces
    # EVERY remaining NaN, including NaN pixels of classes processed
    # later, so earlier classes' means leak into later ones.
    data = labels.data if isinstance(labels, DataArray) \
        else as_tensor(labels, _device(ds))
    uniques = torch.unique(data).tolist()
    _means = ds.copy()
    for lab in uniques:
        if np.isnan(lab):
            continue
        where = _means.where(labels == lab)
        filled = _means.where(labels != lab)
        means = where.mean()
        for v in _means.data_vars:
            vals = filled[v].data
            filled[v] = (filled[v].dims,
                         torch.where(torch.isnan(vals), means[v].data,
                                     vals))
        _means = filled
    return _means


def _get_data_dims(ds, feature_dims=[]):
    return tuple(d for d in ds.coords if d in ds.sizes
                 and d not in feature_dims)


def _get_data_shape(ds, feature_dims=[]):
    data_dims = _get_data_dims(ds, feature_dims=feature_dims)
    return tuple(ds.sizes[d] for d in data_dims)


def _build_X(ds, feature_dims=[]):
    """Stack feature_dims + variables into the feature axis and flatten
    the remaining dims into samples -> (n_samples, n_features), a tensor
    on the data's device."""
    data_dims = _get_data_dims(ds, feature_dims=feature_dims)
    features = tuple(feature_dims) + ('variable',)

    if isinstance(ds, Dataset):
        variables = utils.get_vars_for_dims(ds, data_dims)
        data = ds[variables].to_array()
    else:
        data = ds.expand_dims('variable')

    # order: data_dims..., then feature dims, flattened
    order = tuple(data_dims) + features
    arr = data.transpose(*[d for d in order if d in data.dims]).data
    n_feat = int(np.prod(arr.shape[len(data_dims):]))
    return arr.reshape((-1, n_feat))


def _name_label_axes(shape, ds, data_dims):
    """Pair every axis of a bare label array with a sample dim.

    Axes are matched left to right against the first not-yet-claimed
    sample dim of the same length, turning an anonymous array into a
    named-dim view that the DataArray broadcast path can handle.
    """
    unclaimed = list(data_dims)
    named = []
    for length in shape:
        dim = next((d for d in unclaimed if ds.sizes[d] == length), None)
        if dim is None:
            raise ValueError(
                'label array of shape {!r} does not align with sample '
                'dims {!r}'.format(tuple(shape), tuple(data_dims)))
        named.append(dim)
        unclaimed.remove(dim)
    return tuple(named)


def _broadcast_labels(labels, ds, feature_dims=[]):
    """Broadcast labels over every sample dim of ``ds`` (named-dim
    alignment). A bare array or tensor comes back as a tensor on the
    data's device; a DataArray as a DataArray with ``ds``' sample
    coordinates."""
    data_dims = _get_data_dims(ds, feature_dims=feature_dims)
    bare = isinstance(labels, (np.ndarray, torch.Tensor))
    if bare:
        dims = _name_label_axes(labels.shape, ds, data_dims)
        labels = DataArray(as_tensor(labels, _device(ds)), dims=dims)
    if not isinstance(labels, DataArray):
        raise TypeError(type(labels))

    # lay the label axes out in sample order, leave singleton slots for
    # the dims the labels don't carry, then stretch those slots
    present = [d for d in data_dims if d in labels.dims]
    body = labels.transpose(*present).data
    slotted = body.reshape(tuple(
        ds.sizes[d] if d in present else 1 for d in data_dims))
    full = slotted.expand(tuple(ds.sizes[d] for d in data_dims))
    if bare:
        return full
    coords = OrderedDict((d, ds._coords[d]) for d in data_dims
                         if d in ds.coords)
    return DataArray(full, dims=data_dims, coords=coords)


def _make_Xy(ds, labels, feature_dims):
    """(X, y) tensors on the data's device: the samples with a positive
    finite label (when labels are given) and no NaN feature; y float64."""
    if isinstance(labels, Dataset):
        raise ValueError('`labels` should be a DataArray or numpy '
                         'array of the same dimensions as the '
                         'dataset.')
    if isinstance(labels, (DataArray, np.ndarray, torch.Tensor)):
        labels = labels.squeeze()

    X = _build_X(ds, feature_dims=feature_dims)
    y = None
    if labels is not None:
        labels = _broadcast_labels(labels, ds, feature_dims=feature_dims)
        y = (labels.data if isinstance(labels, DataArray) else labels) \
            .to(torch.float64).reshape(-1)
        # valid samples carry a positive finite class id; NaN and the 0
        # "unlabelled" sentinel both fail the comparison
        ymask = y > 0
        X, y = X[ymask], y[ymask]
    Xmask = ~torch.isnan(X).any(dim=1)
    X = X[Xmask]
    if y is not None:
        y = y[Xmask]
    return X, y


def _to_dataarray(mask, result, ds, feature_dims):
    """Predictions of the unmasked samples back onto the data dims (NaN
    where a sample had a NaN feature), a float64 DataArray on the
    result's device."""
    data_dims = _get_data_dims(ds, feature_dims=feature_dims)
    data_shape = _get_data_shape(ds, feature_dims=feature_dims)
    coords = OrderedDict((dim, ds._coords[dim]) for dim in data_dims
                         if dim in ds.coords)
    flat = torch.full(tuple(mask.shape) + tuple(result.shape[1:]),
                      float('nan'), dtype=torch.float64,
                      device=result.device)
    flat[mask] = result.to(torch.float64)
    data = flat.reshape(data_shape + tuple(result.shape[1:]))
    if result.ndim > 1:
        data_dims = data_dims + ('label',)
        coords['label'] = np.arange(result.shape[1])
    return DataArray(data, dims=data_dims, coords=coords,
                     device=result.device)


class Classifier:
    """Bridge between datacubes and scikit-learn estimators.

    Parameters
    ----------
    clf : sklearn estimator
        Must provide ``fit`` and ``predict``.
    feature_dims : list, optional
        Extra dimensions treated as features rather than samples (e.g.
        ``['time']`` to make every time step an independent feature).
    scale : bool, optional
        Standardize features before fitting (default: False).

    The design matrix is built on the data's device and handed to the
    estimator as numpy; predictions come back onto the data's device.
    """

    def __init__(self, clf, feature_dims=[], scale=False):
        self.clf = clf
        self.feature_dims = feature_dims
        self.scale = scale
        self._scaler = None

    def make_Xy(self, ds, labels=None):
        """Build scikit-learn compatible numpy (X, y) with NaN/0
        masking."""
        X, y = _make_Xy(ds, labels, self.feature_dims)
        X = X.cpu().numpy()
        y = None if y is None else y.cpu().numpy()
        if self.scale:
            if preprocessing is None:
                raise ImportError('scale=True requires scikit-learn')
            self._scaler = preprocessing.StandardScaler()
            self._scaler.fit(X)
            X = self._scaler.transform(X)
        return (X, y)

    def fit(self, ds, labels=None):
        """Train the wrapped estimator on the datacube."""
        X, y = self.make_Xy(ds, labels=labels)
        self.clf.fit(X, y)
        return self

    def predict(self, ds, func='predict'):
        """Predict labels (or probabilities with func='predict_proba');
        NaN rows stay NaN, output is reshaped to the data dims."""
        if func not in dir(self.clf):
            raise AttributeError('Classifier has no method {}.'
                                 .format(func))
        X = _build_X(ds, feature_dims=self.feature_dims)
        mask = ~torch.isnan(X).any(dim=1)
        Xv = X[mask].cpu().numpy()
        if self.scale:
            Xv = self._scaler.transform(Xv)
        result = torch.from_numpy(np.asarray(
            getattr(self.clf, func)(Xv), np.float64)).to(X.device)
        return _to_dataarray(mask, result, ds, self.feature_dims)

    def fit_predict(self, ds, labels=None):
        self.fit(ds, labels)
        return self.predict(ds)

    def score(self, ds, labels=None, method='accuracy'):
        """Classification score using a scikit-learn scorer by name."""
        if metrics is None:
            raise ImportError('score() requires scikit-learn')
        try:
            scorer = metrics.get_scorer(method)
        except Exception:
            raise ValueError("'{}' is not a valid scoring method"
                             .format(method))
        X, y = self.make_Xy(ds, labels=labels)
        return scorer(self.clf, X, y)


class TorchClassifier:
    """Classifier trained on the cube's device with Adam: the
    counterpart of the JAX package's ``JaxClassifier``.

    Parameters
    ----------
    hidden : tuple of int, optional
        Hidden layer widths; empty tuple = multinomial logistic
        regression (default: ()).
    n_classes : int, optional
        Number of classes (default: inferred from labels in fit()).
    epochs : int, optional
        Full-batch training epochs (default: 100).
    lr : float, optional
        Adam learning rate (default: 1e-2; b1 0.9, b2 0.999, eps 1e-8,
        as ``optax.adam``).
    seed : int, optional
        Seed of the He-normal initialisation, drawn from a CPU
        generator so every device starts from the same values
        (default: 0).
    feature_dims : list, optional
        Same semantics as :class:`Classifier`.

    ``params`` is the JAX layout: a list of ``(w (in, out), b (out,))``
    float32 tensor pairs. The design matrix is standardised (mean, std
    with ddof 0, plus 1e-8) and trained on whole; predictions take the
    argmax over the classes seen in ``fit`` only.
    """

    def __init__(self, hidden=(), n_classes=None, epochs=100, lr=1e-2,
                 seed=0, feature_dims=[]):
        self.hidden = tuple(hidden)
        self.n_classes = n_classes
        self.epochs = epochs
        self.lr = lr
        self.seed = seed
        self.feature_dims = feature_dims
        self.params = None
        self._classes = None
        self._start = None

    # -- model ------------------------------------------------------------
    def _init_params(self, n_features, n_classes, device):
        gen = torch.Generator().manual_seed(int(self.seed))
        sizes = (n_features,) + self.hidden + (n_classes,)
        params = []
        for i in range(len(sizes) - 1):
            w = torch.randn((sizes[i], sizes[i + 1]), generator=gen,
                            dtype=torch.float32) * np.sqrt(2.0 / sizes[i])
            b = torch.zeros((sizes[i + 1],), dtype=torch.float32)
            params.append((w.to(device), b.to(device)))
        return params

    def load_params(self, params):
        """Start every later :meth:`fit` from ``params`` (the JAX
        layout: a list of ``(w (in, out), b (out,))`` pairs of arrays or
        tensors, e.g. ``JaxClassifier._init_params(...)`` as numpy) in
        place of the He-normal draw. Stored as float32; fit moves them
        to the data's device and checks their shapes."""
        self._start = [tuple(
            (a if isinstance(a, torch.Tensor)
             else torch.from_numpy(np.array(a))).to(torch.float32)
            for a in pair) for pair in params]
        return self

    @staticmethod
    def _forward(params, X):
        h = X
        with full_f32_matmul():
            for i, (w, b) in enumerate(params):
                h = torch.matmul(h, w) + b
                if i < len(params) - 1:
                    h = torch.relu(h)
        return h

    def loss_fn(self, params, X, y):
        logp = torch.log_softmax(self._forward(params, X), dim=-1)
        # one-hot by comparison (a masked reduction, as the JAX package)
        classes = torch.arange(logp.shape[-1], device=y.device)
        onehot = (y[:, None] == classes).to(logp.dtype)
        return -torch.mean(torch.sum(onehot * logp, dim=-1))

    def train_step(self, params, opt_state, X, y, optimizer):
        """One optimizer step: the counterpart of ``JaxClassifier
        .train_step``. Returns ``(params, opt_state, loss)``.

        ``optimizer`` is a ``torch.optim`` optimizer built over one leaf
        tensor per parameter, in the order of ``params`` (a list of
        ``(w, b)`` pairs), e.g. ``torch.optim.Adam([a for pair in params
        for a in pair], lr=1e-2)``. The step writes ``params`` into those
        tensors, loads ``opt_state`` (the optimizer's ``state_dict()``;
        None clears the optimizer's state, so the step starts afresh, as
        JAX's is pure in ``opt_state``), takes the loss of ``X`` against the
        class indices ``y``, its gradient and the optimizer's step. It
        returns copies of the new parameters, a copy of the optimizer's
        ``state_dict()`` and the loss, detached; the optimizer's tensors
        hold the new parameters too.
        """
        leaves = [p for group in optimizer.param_groups
                  for p in group['params']]
        flat = [a for pair in params for a in pair]
        if len(leaves) != len(flat):
            raise ValueError('the optimizer holds %d tensors, params %d'
                             % (len(leaves), len(flat)))
        with torch.no_grad():
            for leaf, a in zip(leaves, flat):
                if leaf is not a:
                    leaf.copy_(a)
        if opt_state is None:
            optimizer.state.clear()
        else:
            # torch keeps some loaded tensors (Adam's 'step') as they are
            # and steps them in place: load a copy, so opt_state stays put
            optimizer.load_state_dict(copy.deepcopy(opt_state))
        optimizer.zero_grad()
        it = iter(leaves)
        pairs = [tuple(next(it) for _ in pair) for pair in params]
        with torch.enable_grad():
            loss = self.loss_fn(pairs, X, y)
            loss.backward()
        optimizer.step()
        new = [tuple(a.detach().clone() for a in pair) for pair in pairs]
        return new, copy.deepcopy(optimizer.state_dict()), loss.detach()

    # -- API --------------------------------------------------------------
    def fit(self, ds, labels):
        X, y = _make_Xy(ds, labels, self.feature_dims)
        self._classes, y_idx = torch.unique(y, sorted=True,
                                            return_inverse=True)
        if self.n_classes and len(self._classes) > self.n_classes:
            raise ValueError(
                'labels contain %d distinct classes but n_classes=%d'
                % (len(self._classes), self.n_classes))
        n_classes = self.n_classes or len(self._classes)

        Xd = X.to(torch.float32)
        self._mu = torch.mean(Xd, dim=0)
        self._sd = torch.std(Xd, dim=0, correction=0) + 1e-8
        Xd = (Xd - self._mu) / self._sd

        sizes = (X.shape[1],) + self.hidden + (n_classes,)
        if self._start is None:
            start = self._init_params(X.shape[1], n_classes, X.device)
        else:
            start = self._start
            got = [tuple(w.shape) for w, _ in start]
            want = [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]
            if got != want:
                raise ValueError('loaded weights have shapes %r, the model '
                                 '%r' % (got, want))
        params = [tuple(a.detach().to(X.device).clone().requires_grad_(True)
                        for a in pair) for pair in start]
        optimizer = torch.optim.Adam([a for pair in params for a in pair],
                                     lr=self.lr, betas=(0.9, 0.999),
                                     eps=1e-8)
        for _ in range(self.epochs):
            optimizer.zero_grad()
            self.loss_fn(params, Xd, y_idx).backward()
            optimizer.step()
        self.params = [tuple(a.detach() for a in pair) for pair in params]
        return self

    def predict(self, ds, func='predict'):
        if self.params is None:
            raise RuntimeError('fit() must be called before predict()')
        X = _build_X(ds, feature_dims=self.feature_dims)
        mask = ~torch.isnan(X).any(dim=1)
        if func not in ('predict', 'predict_proba'):
            raise AttributeError('unknown prediction func %r' % func)
        Xd = (X[mask].to(torch.float32) - self._mu) / self._sd
        with torch.no_grad():
            logits = self._forward(self.params, Xd)
        if func == 'predict_proba':
            result = torch.softmax(logits, dim=-1)
        else:
            # argmax only over the classes observed in fit(): with an
            # explicit wider n_classes the surplus columns are
            # untrained and must never win
            idx = torch.argmax(logits[:, :len(self._classes)], dim=1)
            result = self._classes[idx]
        return _to_dataarray(mask, result, ds, self.feature_dims)

    def fit_predict(self, ds, labels):
        self.fit(ds, labels)
        return self.predict(ds)
