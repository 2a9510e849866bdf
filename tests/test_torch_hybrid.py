"""``ops.change.change_detection_hybrid`` against nd_tpu's on numpy input,
on the CPU.

The port's hybrid is the exact mode with numpy delivery (the bool map
copied to the host); nd_tpu's, on the CPU,
takes its exact decisions too. The maps are held equal (0 mismatches)
at every route: the round kernel's plain version (k <= 48), the
sequential scan's (48 < k <= 256) and the full-grid 'mixed' scan
(where no kernel serves: here k = 56 at alpha 1e-12, whose scan tables
are infeasible). ``return_device`` returns the bool tensor on the input's
device. The port's ``ops.__all__`` equals nd_tpu's but for ``nlmeans``
(the port's ``ops.nlmeans`` is the module).
"""

import numpy as np
import pytest
import torch

import nd_tpu.ops as jops
from nd_tpu.ops.change import change_detection_hybrid as jhybrid
import nd_tpu_torch.ops as tops
from nd_tpu_torch.ops.change import change_detection_hybrid
from torch_cubes import long_stack_cube, sar_cube


def _cube(case):
    return {'k12': lambda: sar_cube(19, 23, 12, seed=3),
            'k5': lambda: sar_cube(9, 10, 5, seed=4),
            'k15': lambda: sar_cube(9, 10, 15, seed=8),
            'k40': lambda: sar_cube(12, 11, 40, seed=5),
            'k60': lambda: long_stack_cube(10, 12, 60, seed=6),
            'k56': lambda: long_stack_cube(6, 5, 56, seed=7),
            'f64': lambda: sar_cube(13, 9, 12, seed=9).astype(np.float64),
            }[case]()


@pytest.mark.parametrize('case,alpha,n', [
    ('k12', 0.99, 9), ('k12', 0.01, 1), ('k5', 0.5, 4), ('k15', 0.9, 9),
    ('k40', 0.99, 9), ('k60', 0.99, 9), ('k56', 1e-12, 9),
    ('f64', 0.2, 1)])
def test_hybrid_matches_jax_on_numpy(case, alpha, n):
    v = _cube(case)
    ref = np.asarray(jhybrid(v, alpha, n=n))
    got = change_detection_hybrid(v, alpha, n=n, device='cpu')
    assert isinstance(got, np.ndarray)
    assert got.dtype == np.bool_ and got.shape == v.shape[:3]
    assert int((got != ref).sum()) == 0
    dev = change_detection_hybrid(torch.from_numpy(v), alpha, n=n,
                                  return_device=True)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.bool
    np.testing.assert_array_equal(dev.numpy(), got)


def test_hybrid_signature_matches_jax():
    import inspect
    ref = list(inspect.signature(jhybrid).parameters)
    got = list(inspect.signature(change_detection_hybrid).parameters)
    assert got[:len(ref)] == ref and got[len(ref):] == ['device']


def test_ops_all_matches_jax():
    assert set(tops.__all__) == set(jops.__all__) - {'nlmeans'}
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
