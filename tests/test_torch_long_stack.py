"""The long-stack path end to end: nd_tpu_torch against nd_tpu.

Chain A of a one-year Sentinel-1 stack (56 dates):
``NLMeansFilter(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1, sigma=2,
h=3)`` then ``OmnibusTest(ml=3, alpha=0.99)`` on the same seeded cube
through both packages. NLMeans is held to rtol 1e-5, atol 1e-6; the
change map must equal nd_tpu's on the same filtered data exactly, and
the port's float64 'mixed' scan of it. On the CPU the port runs the
kernels' plain versions: the 3-D NLMeans window, the boxcar multilook
and the long-series scan with its rescan.
"""

import numpy as np
import torch

from nd_tpu.change import OmnibusTest as JOmnibusTest
from nd_tpu.core import Dataset as JDataset
from nd_tpu.filters import NLMeansFilter as JNLMeansFilter
import nd_tpu_torch as ndt
from nd_tpu_torch.core import Dataset, from_jax_dataset
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_scan_cuda, conv_cuda
from torch_cubes import long_stack_cube

VARS = ('C11', 'C12__re', 'C12__im', 'C22')
NLM = dict(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1, sigma=2, h=3)


def test_long_stack_chain_matches_jax(monkeypatch):
    cube = long_stack_cube(16, 24, 56, seed=41)
    jds = JDataset({v: (('y', 'x', 'time'), cube[..., i])
                    for i, v in enumerate(VARS)},
                   coords={'time': np.arange(56)})
    ref_flt = JNLMeansFilter(**NLM).apply(jds)
    ref_change = JOmnibusTest(ml=3, alpha=0.99).apply(ref_flt)

    calls = []
    real = change_scan_cuda.change_detection_scan

    def spy(values, *a, **kw):
        calls.append(tuple(values.shape))
        return real(values, *a, **kw)

    monkeypatch.setattr(change_scan_cuda, 'change_detection_scan', spy)
    flt = ndt.NLMeansFilter(**NLM).apply(from_jax_dataset(jds, device='cpu'))
    change = ndt.OmnibusTest(ml=3, alpha=0.99).apply(flt)
    assert calls == [(16, 24, 56, 4)]             # the long-series scan

    for v in VARS:
        assert flt[v].dims == ('y', 'x', 'time')
        np.testing.assert_allclose(flt[v].values, ref_flt[v].values,
                                   rtol=1e-5, atol=1e-6)
    # the omnibus stage on the same filtered data on both sides
    same = JOmnibusTest(ml=3, alpha=0.99).apply(JDataset(
        {v: (('y', 'x', 'time'), flt[v].values) for v in VARS}))
    assert change.dims == ('y', 'x', 'time')
    np.testing.assert_array_equal(change.values, np.asarray(same.values))
    assert change.values.any(-1).all()         # every pixel sees the step
    looked = conv_cuda.sepconv2_plain(
        torch.stack([flt[v].data for v in VARS]),
        np.ones(3) / 9, np.ones(3))                  # (4, y, x, t)
    mixed = tchange.change_detection(looked.permute(1, 2, 3, 0)
                                     .contiguous(), 0.99, n=9)
    np.testing.assert_array_equal(change.values, mixed.numpy())
    # and nd_tpu's chain from the same cube (the filtered data differ by
    # f32 rounding only; no decision of this cube sits that close)
    np.testing.assert_array_equal(change.values,
                                  np.asarray(ref_change.values))


def test_long_stack_dataset_from_torch():
    cube = torch.from_numpy(long_stack_cube(8, 10, 56, seed=42))
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(VARS)})
    flt = ndt.NLMeansFilter(**NLM).apply(ds)
    change = ndt.OmnibusTest(ml=3, alpha=0.99).apply(flt)
    assert change.data.dtype == torch.bool
    assert tuple(change.data.shape) == (8, 10, 56)
    assert all(bool(torch.isfinite(flt[v].data).all()) for v in VARS)
