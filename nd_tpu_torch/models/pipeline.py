"""Flagship end-to-end pipeline: multilook, exact omnibus change
detection, change features and a classifier head.

Counterpart of ``nd_tpu/models/pipeline.py``. ``forward`` is the
inference path; ``loss`` and ``train_step`` train the head (a linear
layer over the seven change features) by SGD on one device. The
features do not depend on the head's parameters, so they are computed
without autograd and only the head is differentiated. The sharded step
(``train_step(mesh=...)``, ``make_sharded_step``) waits for
``parallel/`` (ROADMAP item 14).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.variable import DEFAULT_DEVICE, as_tensor
from ..ops.change import change_detection_exact, omnibus_probabilities
from ..ops.conv import convolve
from ..ops.interp import full_f32_matmul

__all__ = ['SARChangePipeline', 'multilook', 'change_features']

# margin_eps of the pipeline's exact scan (the reference's value here;
# OmnibusTest and change_detection_exact default to 1e-4)
PIPELINE_MARGIN_EPS = 3e-4


def multilook(values, w=3):
    """Boxcar multilook of a (y, x, time, 4) covariance stack."""
    np_dtype = np.dtype(str(values.dtype).replace('torch.', ''))
    kernel = np.ones((w, w), np_dtype) / (w * w)
    return convolve(values, kernel, axes=(0, 1), mode='reflect')


def change_features(values, n=1, device=None):
    """Per-pixel features from a (y, x, time, 4) covariance stack.

    Returns (y, x, F) on ``values``' device (numpy input lands on
    ``device``, by default ``cuda``): temporal mean/std (ddof 0) of the
    diagonal channels, the mean C11/C22 ratio, the mean cross-channel
    coherence, and the omnibus probability of the full series (NaN
    becomes 0).
    """
    values = as_tensor(values, device)
    c11 = values[..., 0]
    c22 = values[..., 3]
    eps = 1e-12
    ratio = c11 / (c22 + eps)
    coh = torch.sqrt(values[..., 1] ** 2 + values[..., 2] ** 2) \
        / (torch.sqrt(torch.abs(c11 * c22)) + eps)
    prob = omnibus_probabilities(values, n=n)
    feats = [c11.mean(-1), c11.std(-1, correction=0), c22.mean(-1),
             c22.std(-1, correction=0), ratio.mean(-1), coh.mean(-1),
             torch.nan_to_num(prob, nan=0.0)]
    return torch.stack(feats, dim=-1)


class SARChangePipeline(nn.Module):
    """Multilook + omnibus change detection + classifier head.

    Parameters
    ----------
    ml : int, optional
        Multilook window (default 3).
    n : int, optional
        Looks already present in the input (default 1; the multilook
        multiplies this by ml**2).
    alpha : float, optional
        Change threshold (default 0.9).
    n_classes : int, optional
        Classifier classes (default 2).
    lr : float, optional
        SGD learning rate for the classifier head (default 0.05).

    The training API is the JAX package's: ``params`` is a dict
    ``{'w': (7, n_classes), 'b': (n_classes,)}`` of float32 tensors,
    passed to :meth:`loss` and :meth:`train_step` and returned updated.
    """

    N_FEATURES = 7

    def __init__(self, ml=3, n=1, alpha=0.9, n_classes=2, lr=0.05):
        super().__init__()
        self.ml = ml
        self.n = n
        self.alpha = alpha
        self.n_classes = n_classes
        self.lr = lr
        # the JAX layout: features x classes, and per-class bias
        self.w = nn.Parameter(torch.zeros(self.N_FEATURES, n_classes),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(n_classes), requires_grad=False)

    def _checked(self, params, device):
        """``params`` as float32 tensors of the head's shapes on
        ``device``."""
        shapes = {'w': (self.N_FEATURES, self.n_classes),
                  'b': (self.n_classes,)}
        out = {}
        for name, shape in shapes.items():
            value = params[name]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.array(value))
            if tuple(value.shape) != shape:
                raise ValueError('%s has shape %r, expected %r'
                                 % (name, tuple(value.shape), shape))
            out[name] = value.to(device=device, dtype=torch.float32)
        return out

    def load_params(self, params):
        """Load ``{'w': (7, n_classes), 'b': (n_classes,)}`` arrays (the
        JAX package's ``init_params()`` as numpy) into the parameters,
        on their current device."""
        with torch.no_grad():
            for name, value in self._checked(params, self.w.device).items():
                getattr(self, name).copy_(value)
        return self

    def params_from_jax(self, params, device=None):
        """The JAX package's head parameters (numpy or JAX arrays,
        ``{'w': (7, n_classes), 'b': (n_classes,)}``) as this port's
        ``params``: float32 tensors on ``device`` (default ``cuda``)."""
        return self._checked(params, torch.device(
            DEFAULT_DEVICE if device is None else device))

    def params(self):
        """The head's parameters as numpy arrays (JAX layout)."""
        return {'w': self.w.detach().cpu().numpy(),
                'b': self.b.detach().cpu().numpy()}

    # -- initialization ------------------------------------------------------
    def init_params(self, seed=0, device=None):
        """Fresh head parameters: ``w`` N(0, 0.1^2), ``b`` zeros, drawn
        from a CPU generator seeded with ``seed`` and then moved to
        ``device`` (default ``cuda``), so the card and the CPU start
        from the same values. (The JAX package draws with threefry;
        ``params_from_jax`` carries its draws across.)"""
        gen = torch.Generator().manual_seed(int(seed))
        w = torch.randn((self.N_FEATURES, self.n_classes), generator=gen,
                        dtype=torch.float32) * 0.1
        b = torch.zeros((self.n_classes,), dtype=torch.float32)
        return self.params_from_jax({'w': w, 'b': b}, device)

    # -- forward (inference) -------------------------------------------------
    def forward(self, values):
        """values (y, x, time, 4) -> boolean change map (y, x, time), on
        ``values``' device: the multilook, then the exact omnibus scan
        (fused f32 kernel + float64 rescan of near-margin pixels)."""
        looked = multilook(values, self.ml)
        n = self.n * self.ml ** 2
        return change_detection_exact(looked, float(self.alpha), n=int(n),
                                      margin_eps=PIPELINE_MARGIN_EPS)

    # -- training ---------------------------------------------------------------
    def features(self, looked):
        """The change features of a multilooked cube (no autograd)."""
        with torch.no_grad():
            return change_features(looked, n=self.n * self.ml ** 2)

    def head_loss(self, params, feats, labels):
        """Masked cross-entropy of the head over ``feats`` (y, x, 7);
        ``labels`` (y, x) of class ids, -1 masked. Differentiable in
        ``params``."""
        labels = as_tensor(labels, feats.device)
        # float32 logits from features of any float type, as
        # jnp.dot(..., preferred_element_type=float32)
        with full_f32_matmul():
            logits = torch.matmul(feats, params['w'].to(feats.dtype)).to(
                torch.float32) + params['b']
        logp = torch.log_softmax(logits, dim=-1)
        # one-hot by comparison: a masked label (-1) gives a zero row, as
        # jax.nn.one_hot does (F.one_hot refuses it)
        classes = torch.arange(self.n_classes, device=labels.device)
        onehot = (labels[..., None] == classes).to(logits.dtype)
        mask = (labels >= 0).to(logits.dtype)
        ll = torch.sum(logp * onehot, dim=-1) * mask
        return -torch.sum(ll) / torch.clamp_min(torch.sum(mask), 1.0)

    def head_step(self, params, feats, labels):
        """One SGD step of the head on fixed features: ``(params,
        loss)``. The gradient comes from autograd; the update runs
        outside it."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = self.head_loss(leaves, feats, labels)
            grads = torch.autograd.grad(loss, [leaves['w'], leaves['b']])
        with torch.no_grad():
            new = {k: leaves[k] - self.lr * g
                   for k, g in zip(('w', 'b'), grads)}
        return new, loss.detach()

    def loss(self, params, values, labels):
        """Masked cross-entropy of the classifier head over change
        features; ``values`` are already multilooked."""
        return self.head_loss(params, self.features(as_tensor(values)),
                              labels)

    def train_step(self, params, values, labels, mesh=None):
        """One training step on ``values``' device: multilook (the
        sepconv kernel on the card), change features, the head's loss,
        its gradient and the SGD update. Returns ``(params, loss)``.

        Only ``mesh=None`` (one device) is ported.
        """
        if mesh is not None:
            raise NotImplementedError(
                'train_step(mesh=...) needs parallel/ (ROADMAP item 14)')
        with torch.no_grad():
            looked = multilook(as_tensor(values), self.ml)
        return self.head_step(params, self.features(looked), labels)

    def make_sharded_step(self, mesh, shape=None):
        """The sharded training step: not ported (ROADMAP item 14)."""
        raise NotImplementedError(
            'make_sharded_step needs parallel/ (ROADMAP item 14)')
