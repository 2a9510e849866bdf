"""Flagship end-to-end pipeline: multilook, then exact omnibus change
detection; the classifier head's parameters ride along.

Counterpart of ``nd_tpu/models/pipeline.py``. ``forward`` is the
inference path; ``loss`` and ``train_step`` are still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.change import change_detection_exact
from ..ops.conv import convolve

__all__ = ['SARChangePipeline', 'multilook']

# margin_eps of the pipeline's exact scan (the reference's value here;
# OmnibusTest and change_detection_exact default to 1e-4)
PIPELINE_MARGIN_EPS = 3e-4


def multilook(values, w=3):
    """Boxcar multilook of a (y, x, time, 4) covariance stack."""
    np_dtype = np.dtype(str(values.dtype).replace('torch.', ''))
    kernel = np.ones((w, w), np_dtype) / (w * w)
    return convolve(values, kernel, axes=(0, 1), mode='reflect')


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

    def load_params(self, params):
        """Load ``{'w': (7, n_classes), 'b': (n_classes,)}`` arrays (the
        JAX package's ``init_params()`` as numpy) into the parameters,
        on their current device."""
        with torch.no_grad():
            for name in ('w', 'b'):
                p = getattr(self, name)
                value = torch.tensor(np.array(params[name]),
                                     dtype=p.dtype)
                if tuple(value.shape) != tuple(p.shape):
                    raise ValueError('%s has shape %r, expected %r'
                                     % (name, tuple(value.shape),
                                        tuple(p.shape)))
                p.copy_(value)
        return self

    def params(self):
        """The head's parameters as numpy arrays (JAX layout)."""
        return {'w': self.w.detach().cpu().numpy(),
                'b': self.b.detach().cpu().numpy()}

    def forward(self, values):
        """values (y, x, time, 4) -> boolean change map (y, x, time), on
        ``values``' device: the multilook, then the exact omnibus scan
        (fused f32 kernel + float64 rescan of near-margin pixels)."""
        looked = multilook(values, self.ml)
        n = self.n * self.ml ** 2
        return change_detection_exact(looked, float(self.alpha), n=int(n),
                                      margin_eps=PIPELINE_MARGIN_EPS)
