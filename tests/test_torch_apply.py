"""``utils.apply`` and the ``ds.nd.apply`` accessor: nd_tpu_torch against
nd_tpu on the same cube (both ``generate_test_dataset``s draw the same
float64 values from one seed).

The vmap route (``torch.vmap`` against ``jax.vmap``) and the host route
(``np.vectorize`` in both) must agree within rtol 1e-12 (the same
arithmetic; sums may round in another order). The route each call took
is recorded in ``utils.routes``.
"""

import numpy as np
import pytest
import torch

from nd_tpu.testing import generate_test_dataset as jgen
from nd_tpu.utils import apply as japply
import nd_tpu_torch  # noqa: F401  (the accessors)
from nd_tpu_torch import utils
from nd_tpu_torch.core import DataArray
from nd_tpu_torch.testing import generate_test_dataset

DIMS = {'y': 5, 'x': 4, 'time': 6}


def _pair():
    return jgen(dims=DIMS), generate_test_dataset(dims=DIMS, device='cpu')


def _span_ratio(x):
    """(time, var) -> (time): the span C11 + C22 over its mean."""
    s = x[:, 0] + x[:, 3]
    return s / s.mean(0)


def _demean(x):
    return x - x.mean(0)


def _slope_numpy(x):
    """numpy only: a host-route function (its own slope per series)."""
    t = np.arange(x.shape[0], dtype=np.float64)
    return np.polyfit(t, np.asarray(x), 1)[0] * np.ones(x.shape[0])


def _same(got, ref):
    if hasattr(ref, 'data_vars'):
        assert sorted(got.data_vars) == sorted(ref.data_vars)
        for v in ref.data_vars:
            _same(got[v], ref[v])
        return
    assert got.dims == ref.dims
    np.testing.assert_allclose(got.values, np.asarray(ref.values),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('fn,signature,route', [
    (_span_ratio, '(time,var)->(time)', 'vmap'),
    (_demean, '(time)->(time)', 'vmap'),
    (_slope_numpy, '(time)->(time)', 'host'),
])
def test_apply_matches_jax(fn, signature, route):
    j, t = _pair()
    before = dict(utils.routes)
    got = utils.apply(t, fn, signature=signature)
    other = 'host' if route == 'vmap' else 'vmap'
    assert utils.routes[route] > before[route]
    assert utils.routes[other] == before[other]
    _same(got, japply(j, fn, signature=signature))


def test_accessor_matches_the_function():
    j, t = _pair()
    got = t.nd.apply(_span_ratio, signature='(time,var)->(time)')
    _same(got, japply(j, _span_ratio, signature='(time,var)->(time)'))
    assert got.data.device.type == 'cpu'


def test_var_stacking_keeps_variables():
    j, t = _pair()
    got = utils.apply(t, _demean, signature='(time,var)->(time,var)')
    ref = japply(j, _demean, signature='(time,var)->(time,var)')
    _same(got, ref)
    assert list(got.data_vars) == list(t.data_vars)


def test_reduction_signature_on_a_dataarray():
    j, t = _pair()
    got = utils.apply(t['C11'], lambda x: x.sum(0), signature='(time)->()')
    ref = japply(j['C11'], lambda x: x.sum(0), signature='(time)->()')
    _same(got, ref)


def test_vmap_route_equals_the_direct_expression():
    _, t = _pair()
    got = t.nd.apply(_span_ratio, signature='(time,var)->(time)')
    s = t['C11'] + t['C22']
    ref = s / s.mean('time')
    np.testing.assert_allclose(got.values, ref.transpose(*got.dims).values,
                               rtol=1e-15)


def test_other_errors_propagate():
    da = DataArray(torch.rand(3, 4, dtype=torch.float64), dims=('y', 'time'))
    with pytest.raises(RuntimeError, match='shape'):
        utils.apply(da, lambda x: x.reshape(3), signature='(time)->(time)')
    with pytest.raises(ValueError, match='signature'):
        utils.apply(da, _demean, signature='(time)->(band)')
    with pytest.raises(ValueError):
        utils.apply(da, _demean, signature='time->time')
