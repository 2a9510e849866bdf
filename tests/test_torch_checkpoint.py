"""Checkpoints: nd_tpu_torch's files against nd_tpu's.

Files written by either package's ``save_params`` load in the other's
``load_params`` bit for bit, for the pipeline's parameter dict and the
classifier's list of ``(w, b)`` pairs; the structure strings equal JAX's
``str(tree_structure(...))``; the ``Checkpointer`` keeps the newest
``max_to_keep`` steps.
"""

import numpy as np
import pytest
import torch

import jax

from nd_tpu.classify import JaxClassifier
from nd_tpu.models.checkpoint import load_params as jload
from nd_tpu.models.checkpoint import save_params as jsave
from nd_tpu.models.pipeline import SARChangePipeline as JPipeline
from nd_tpu_torch.models import checkpoint as tck
from nd_tpu_torch.models.checkpoint import (Checkpointer, load_params,
                                            save_params)

TREES = {
    'dict': {'w': 1.0, 'b': 2.0},
    'pairs': [(1.0, 2.0), (3.0, 4.0)],
    'nested': {'a': None, 'b': [1.0, (2.0,)], 'c': {}},
    'none': None,
    'empty tuple': (),
    'one tuple': (1.0,),
    'int keys': {3: 1.0, 1: 2.0},
    'quoted keys': {"it's": 1.0, 'a"b': 2.0},
    'leaf': 1.0,
    'list with none': [1.0, None],
}


@pytest.mark.parametrize('name', sorted(TREES))
def test_structure_string_and_order_are_jax(name):
    tree = TREES[name]
    leaves, spec = tck._flatten(tree)
    assert 'PyTreeDef(%s)' % spec == str(jax.tree_util.tree_structure(tree))
    assert leaves == jax.tree_util.tree_leaves(tree)
    parsed = tck._parse('PyTreeDef(%s)' % spec)
    assert tck._unflatten(parsed, iter(leaves)) == tree


def _jax_pipeline_params():
    params = JPipeline(n_classes=3).init_params(seed=4)
    return {k: np.asarray(v) for k, v in params.items()}


def _jax_classifier_params():
    return [tuple(np.asarray(a) for a in pair)
            for pair in JaxClassifier(hidden=(5,))._init_params(4, 3)]


def _torch_like(tree):
    return jax.tree_util.tree_map(lambda a: torch.zeros(np.shape(a)), tree)


@pytest.mark.parametrize('which', ['pipeline', 'classifier'])
def test_jax_files_load_in_the_port(tmp_path, which):
    tree = _jax_pipeline_params() if which == 'pipeline' \
        else _jax_classifier_params()
    path = str(tmp_path / 'p.npz')
    jsave(tree, path)
    got = load_params(path, like=_torch_like(tree))
    assert type(got) is type(tree)
    ref_leaves = jax.tree_util.tree_leaves(tree)
    got_leaves = jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(got_leaves) == len(ref_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        assert isinstance(g, torch.Tensor) and g.device.type == 'cpu'
        assert g.dtype == torch.from_numpy(np.array(r)).dtype
        np.testing.assert_array_equal(g.numpy(), r)
    flat = load_params(path, device='cpu')
    assert [f.shape for f in flat] == [torch.Size(r.shape)
                                       for r in ref_leaves]


@pytest.mark.parametrize('which', ['pipeline', 'classifier'])
def test_port_files_load_in_jax(tmp_path, which):
    tree = _jax_pipeline_params() if which == 'pipeline' \
        else _jax_classifier_params()
    ttree = jax.tree_util.tree_map(torch.from_numpy, tree)
    path = str(tmp_path / 'p.npz')
    assert save_params(ttree, path) == path
    got = jload(path, like=tree)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(g), r)


def test_mismatched_like_raises(tmp_path):
    path = str(tmp_path / 'p.npz')
    save_params({'w': torch.ones(2), 'b': torch.zeros(1)}, path)
    with pytest.raises(ValueError, match='does not match'):
        load_params(path, like=[torch.ones(2), torch.zeros(1)])
    with pytest.raises(ValueError):
        jload(path, like=[np.ones(2), np.zeros(1)])


def test_leaves_follow_like_devices_else_device(tmp_path):
    path = str(tmp_path / 'p.npz')
    save_params({'w': torch.ones(2, 3), 'b': np.zeros(3, np.float32)}, path)
    got = load_params(path, like={'w': torch.zeros(2, 3), 'b': 0.0},
                      device='meta')
    assert got['w'].device.type == 'cpu' and got['b'].device.type == 'meta'
    assert [t.device.type for t in load_params(path, device='meta')] == \
        ['meta', 'meta']


def test_checkpointer_keeps_two_and_restores(tmp_path):
    ck = Checkpointer(str(tmp_path / 'ck'), max_to_keep=2)
    states = [{'w': torch.full((3, 2), float(i)), 'b': torch.arange(2.0) + i,
               'meta': (torch.tensor(i), None)} for i in range(3)]
    for i, state in enumerate(states):
        ck.save(i, state)
    states[2]['w'] += 100          # the save holds a snapshot
    assert ck.latest_step() == 2
    assert sorted(p.name for p in (tmp_path / 'ck').iterdir()) == \
        ['step_1.npz', 'step_2.npz']
    got = ck.restore(like=states[0])
    np.testing.assert_array_equal(got['w'].numpy(), np.full((3, 2), 2.0))
    np.testing.assert_array_equal(got['b'].numpy(), [2.0, 3.0])
    assert got['meta'][1] is None and int(got['meta'][0]) == 2
    assert got['w'].device.type == 'cpu'
    old = ck.restore(step=1, device='cpu')      # as saved, no `like`
    assert set(old) == {'w', 'b', 'meta'} and isinstance(old['meta'], tuple)
    np.testing.assert_array_equal(old['b'].numpy(), [1.0, 2.0])
    # each step is a save_params file, readable by the JAX package
    ref = jload(str(tmp_path / 'ck' / 'step_1.npz'),
                like={'w': 0, 'b': 0, 'meta': (0, None)})
    np.testing.assert_array_equal(np.asarray(ref['w']), np.ones((3, 2)))
    ck.close()


def test_checkpointer_empty_and_unbounded(tmp_path):
    ck = Checkpointer(str(tmp_path / 'ck'), max_to_keep=None)
    assert ck.latest_step() is None and ck.restore() is None
    for i in (5, 7, 6):
        ck.save(i, [torch.tensor(float(i))])
    ck.wait()
    assert ck.latest_step() == 7
    assert len(list((tmp_path / 'ck').iterdir())) == 3
    assert float(ck.restore(step=5, device='cpu')[0]) == 5.0
    ck.close()
