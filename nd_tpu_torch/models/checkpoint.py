"""Checkpoint / resume of parameter trees.

Counterpart of ``nd_tpu/models/checkpoint.py``, and file-compatible
with it:

  - ``save_params`` / ``load_params``: ``.npz`` snapshots of a tree of
    dicts, lists, tuples and ``None`` with tensor (or array) leaves. The
    leaves are stored as ``arr_0, arr_1, ...`` in JAX's flatten order
    (dict keys sorted) beside ``__treedef__``, the string JAX prints for
    the tree's structure, so files written by either package load in
    the other.
  - ``Checkpointer``: step-indexed checkpoints with retention, written
    on a worker thread.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.variable import DEFAULT_DEVICE

__all__ = ['save_params', 'load_params', 'Checkpointer']


def _flatten(tree):
    """(leaves, structure string) in JAX's order and notation."""
    if tree is None:
        return [], 'None'
    if isinstance(tree, dict):
        leaves, parts = [], []
        for key in sorted(tree):
            sub, spec = _flatten(tree[key])
            leaves += sub
            parts.append('%r: %s' % (key, spec))
        return leaves, '{%s}' % ', '.join(parts)
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for item in tree:
            sub, spec = _flatten(item)
            leaves += sub
            parts.append(spec)
        if isinstance(tree, list):
            return leaves, '[%s]' % ', '.join(parts)
        return leaves, '(%s%s)' % (', '.join(parts),
                                   ',' if len(parts) == 1 else '')
    return [tree], '*'


def _treedef(spec):
    return 'PyTreeDef(%s)' % spec


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``; a leaf of ``like`` is replaced by the next one,
    an ``Ellipsis`` too (see :func:`_parse`)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(item, leaves) for item in like)
    return next(leaves)


def _parse(treedef):
    """The structure a ``__treedef__`` string records, with ``Ellipsis``
    at each leaf."""
    spec = treedef[len('PyTreeDef('):-1]
    out = []
    for tok in tokenize.generate_tokens(io.StringIO(spec).readline):
        if tok.type == tokenize.OP and tok.string == '*':
            out.append((tokenize.OP, '...'))
        else:
            out.append((tok.type, tok.string))
    return ast.literal_eval(tokenize.untokenize(out))


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to('cpu', copy=True).numpy()
    return np.asarray(leaf)


def _write(flat, spec, path):
    arrays = {('arr_%d' % i): a for i, a in enumerate(flat)}
    tmp = str(path) + '.part'
    np.savez(tmp, __treedef__=np.array(_treedef(spec)), **arrays)
    os.replace(tmp + '.npz', path)   # np.savez appends .npz to `tmp`
    return path


def save_params(params, path):
    """Save a tree of tensors (or arrays) to an .npz file (atomic
    rename), in the JAX package's format.

    The tree structure's string form is stored alongside the leaves so
    :func:`load_params` can reject a mismatched ``like`` tree instead
    of silently rebinding leaves to the wrong positions.
    """
    flat, spec = _flatten(params)
    return _write([_host(a) for a in flat], spec, path)


def _read(path):
    with np.load(path, allow_pickle=False) as data:
        n = len([k for k in data.files if k.startswith('arr_')])
        flat = [data['arr_%d' % i] for i in range(n)]
        saved_tree = str(data['__treedef__']) \
            if '__treedef__' in data.files else None
    return flat, saved_tree


def _tensor(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def load_params(path, like=None, device=None):
    """Load a tree saved by :func:`save_params` (or by the JAX
    package's).

    ``like`` supplies the tree structure (e.g. freshly initialized
    params) and is validated against the structure recorded at save
    time; without it a flat list is returned. Each leaf is a tensor on
    the device of ``like``'s leaf in its place where that is a tensor,
    else on ``device`` (default ``cuda``).
    """
    flat, saved_tree = _read(path)
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if like is None:
        return [_tensor(a, device) for a in flat]
    like_leaves, spec = _flatten(like)
    if saved_tree is not None and _treedef(spec) != saved_tree:
        raise ValueError(
            'checkpoint tree structure %s does not match `like` %s'
            % (saved_tree, _treedef(spec)))
    if len(like_leaves) != len(flat):
        raise ValueError('checkpoint holds %d leaves, `like` %d'
                         % (len(flat), len(like_leaves)))
    tensors = [_tensor(a, ref.device if isinstance(ref, torch.Tensor)
                       else device) for a, ref in zip(flat, like_leaves)]
    return _unflatten(like, iter(tensors))


class Checkpointer:
    """Versioned checkpoints (step-indexed, the newest ``max_to_keep``
    retained; ``None`` keeps all).

    The JAX package's ``Checkpointer`` writes orbax checkpoints; this
    one needs no orbax (the card's machine has none) and its files are
    not orbax's: each step is one ``step_<n>.npz`` in the format of
    :func:`save_params`, which both packages' ``load_params`` read.
    :meth:`save` copies the leaves to the host and returns; one worker
    thread writes the file and removes the steps past ``max_to_keep``.
    :meth:`wait` is the durability barrier; :meth:`restore` and
    :meth:`latest_step` wait first.
    """

    _FILE = re.compile(r'^step_(\d+)\.npz$')

    def __init__(self, directory, max_to_keep=3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max = max_to_keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def _path(self, step):
        return os.path.join(self._dir, 'step_%d.npz' % step)

    def _steps(self):
        return sorted(int(m.group(1)) for m in map(self._FILE.match,
                                                   os.listdir(self._dir))
                      if m)

    def _save(self, step, flat, spec):
        _write(flat, spec, self._path(step))
        if self._max is not None:
            for old in self._steps()[:-self._max]:
                os.remove(self._path(old))

    def save(self, step, state):
        """Snapshot ``state`` (leaves copied to the host now) and write
        it as ``step`` on the worker thread."""
        flat, spec = _flatten(state)
        self._pending.append(self._pool.submit(
            self._save, int(step), [_host(a) for a in flat], spec))

    def wait(self):
        """Block until every save so far is on disk; raise the first
        save's error, if any."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def restore(self, step=None, like=None, device=None):
        """The tree saved at ``step`` (default: the latest; ``None`` if
        there is none), shaped as ``like`` (validated) or as saved,
        leaves on ``like``'s devices or ``device`` (default ``cuda``)."""
        self.wait()   # never read a torn save
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._path(step)
        if like is not None:
            return load_params(path, like=like, device=device)
        flat, saved_tree = _read(path)
        device = torch.device(DEFAULT_DEVICE if device is None else device)
        return _unflatten(_parse(saved_tree),
                          iter(_tensor(a, device) for a in flat))

    def latest_step(self):
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self):
        self.wait()
        self._pool.shutdown(wait=True)
