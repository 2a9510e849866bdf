"""Flagship end-to-end pipeline: multilook, exact omnibus change
detection, change features and a classifier head.

Counterpart of ``nd_tpu/models/pipeline.py``. ``forward`` is the
inference path; ``loss`` and ``train_step`` train the head (a linear
layer over the seven change features) by SGD. The features do not
depend on the head's parameters, so they are computed without autograd
and only the head is differentiated.

The step shards over a device mesh (``train_step(mesh=...)``,
``make_sharded_step``): the multilook runs through
``parallel.halo.shard_apply`` with halos from the neighbouring blocks,
and the features, the loss and its gradient are data-parallel over the
(y, x) blocks. The loss is the sum of the blocks' masked
log-likelihoods over the sum of their masks, and the blocks' gradients
are summed (``torch.distributed`` all-reduces both across processes).
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
        ll, mask = self._head_ll(params, feats, labels)
        return -ll / torch.clamp_min(mask, 1.0)

    def _head_ll(self, params, feats, labels):
        """The head's masked log-likelihood summed over the pixels, and
        the count of labelled pixels (the loss is ``-ll / max(count,
        1)``)."""
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
        return torch.sum(ll), torch.sum(mask)

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

        With ``mesh`` (a ``parallel.mesh.Mesh``) the step is sharded over
        the mesh's (y, x) positions: ``values`` and ``labels`` are the
        global tensors, or ShardedArrays placed by
        :meth:`make_sharded_step`'s placements. The new parameters and
        the loss land on ``params``' device.
        """
        if mesh is None:
            with torch.no_grad():
                looked = multilook(as_tensor(values), self.ml)
            return self.head_step(params, self.features(looked), labels)
        from ..parallel.distributed import all_reduce_sum
        from ..parallel.halo import ShardedArray, on_device
        home = params['w'].device
        if not isinstance(labels, ShardedArray):
            labels = as_tensor(labels)

        def label_block(pos, index, device):
            if isinstance(labels, ShardedArray):
                return labels.blocks[pos].to(device)
            return labels[index].to(device)
        with torch.no_grad():
            looked = self._sharded_multilook(values, mesh)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        ll = torch.zeros((), dtype=torch.float32, device=home)
        count = torch.zeros((), dtype=torch.float32, device=home)
        with torch.enable_grad():
            for pos, block in looked.blocks.items():
                index = looked.index(pos)
                if block.shape[0] == 0 or block.shape[1] == 0:
                    continue
                with on_device(block.device):
                    feats = self.features(block)
                    part, n = self._head_ll(
                        {k: v.to(block.device) for k, v in leaves.items()},
                        feats, label_block(pos, index[:2], block.device))
                ll = ll + part.to(home)
                count = count + n.to(home)
            # a process whose blocks are all empty adds zeros
            grads = torch.autograd.grad(ll, [leaves['w'], leaves['b']]) \
                if ll.requires_grad \
                else [torch.zeros_like(leaves[k]) for k in ('w', 'b')]
        with torch.no_grad():
            # one all-reduce of (ll, count, gradients) across processes
            packed = all_reduce_sum(torch.cat(
                [ll.detach().reshape(1), count.reshape(1)]
                + [g.reshape(-1) for g in grads]))
            ll, count = packed[0], packed[1]
            denom = torch.clamp_min(count, 1.0)
            w_size = leaves['w'].numel()
            g_w = packed[2:2 + w_size].reshape(leaves['w'].shape)
            g_b = packed[2 + w_size:].reshape(leaves['b'].shape)
            new = {'w': leaves['w'] - self.lr * (-g_w / denom),
                   'b': leaves['b'] - self.lr * (-g_b / denom)}
        return {k: v.detach() for k, v in new.items()}, -ll / denom

    def _sharded_multilook(self, values, mesh):
        """Multilook with halos from the neighbouring blocks, through the
        shared ``parallel.halo`` engine (which also handles pixel grids
        that don't divide the mesh). The block kernel IS
        :func:`multilook`: one definition for the single-device and
        sharded paths, so they cannot diverge. Returns the multilooked
        cube as a ShardedArray of this process's (y, x) blocks."""
        from ..parallel.halo import ShardedArray, shard_blocks
        if not isinstance(values, ShardedArray):
            values = as_tensor(values)
        halo = self.ml // 2
        return shard_blocks(lambda x: multilook(x, self.ml), values, mesh,
                            {'y': (0, halo), 'x': (1, halo)},
                            mode='symmetric')

    # -- full sharded step -----------------------------------------------------
    def make_sharded_step(self, mesh, shape=None):
        """A training step with mesh-sharded inputs.

        Returns ``(step, data_sharding, label_sharding)``:
        ``step(params, values, labels)`` is :meth:`train_step` on the
        mesh, and the two placements put the global values
        ``(y, x, time, 4)`` and labels ``(y, x)`` on the mesh
        (``data_sharding.place(values)``), the counterparts of the JAX
        package's NamedShardings P('y', 'x', None, None) and P('y', 'x').
        Parameters stay on their device.

        ``shape`` (ny, nx), when given, shrinks each mesh axis to the
        largest count that DIVIDES the pixel grid: a placement needs
        blocks of equal size, so without the fit a 17 x 19 grid on a
        2 x 4 mesh is refused (``train_step(mesh=)`` on the global
        tensors pads instead).
        """
        if shape is not None:
            from ..parallel.mesh import _largest_divisor
            ny_n = _largest_divisor(mesh.shape['y'], shape[0])
            nx_n = _largest_divisor(mesh.shape['x'], shape[1])
            if (ny_n, nx_n) != (mesh.shape['y'], mesh.shape['x']):
                mesh = mesh.reshaped((ny_n, nx_n))
        data_sharding = Placement(mesh, ('y', 'x', None, None))
        label_sharding = Placement(mesh, ('y', 'x'))

        def step(params, values, labels):
            return self.train_step(params, values, labels, mesh=mesh)
        return step, data_sharding, label_sharding


class Placement:
    """Where a sharded step's argument lives: one block per mesh
    position, split along the array axes named in ``spec`` (the JAX
    package's NamedSharding)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def place(self, arr):
        """The global ``arr`` (a tensor, or numpy from the host) as a
        ShardedArray: its blocks copied to their positions' devices."""
        from ..parallel.halo import place
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        chunks = list(arr.shape)
        for axis, name in enumerate(self.spec):
            if name is not None:
                n = self.mesh.shape[name]
                if arr.shape[axis] % n:
                    raise ValueError(
                        'axis %d (%d) does not divide the mesh axis %r (%d); '
                        'make_sharded_step(mesh, shape=...) fits the mesh'
                        % (axis, arr.shape[axis], name, n))
                chunks[axis] = arr.shape[axis] // n
        return place(arr, self.mesh, self.spec, tuple(chunks))
