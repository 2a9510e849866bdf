"""The dated-stack chain at a small size: gap filling, monthly
composites, a non-separable filter and the change test, with pandas
blocked in the port's process.

A one-year stack (56 dates, 2% no-data) goes through
``interpolate_na(dim='time')`` then ``resample(time='1MS').mean()`` then
``ConvolutionFilter(dims=('y', 'x'), kernel=disk)`` then
``OmnibusTest(ml=3, alpha=0.99)``: in nd_tpu_torch in a subprocess where
``import pandas`` fails, and in nd_tpu here. The composites agree within
rtol 1e-6, atol 1e-6 (float32: interpolation weights and means round in
another order), the filtered composites within rtol 1e-5, atol 1e-5
(the stencil sums its taps in another order than XLA), and the port's
change map equals nd_tpu's on the port's own filtered composites.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np

from nd_tpu.change import OmnibusTest as JOmnibusTest
from nd_tpu.core import Dataset as JDataset
from nd_tpu.filters import ConvolutionFilter as JConvolutionFilter
from torch_cubes import dated_stack

VARS = ('C11', 'C12__re', 'C12__im', 'C22')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHAIN = textwrap.dedent('''
    import sys
    sys.modules['pandas'] = None          # the card's machine has none
    import numpy as np
    import nd_tpu_torch as ndt
    from nd_tpu_torch.core import Dataset
    src = np.load(sys.argv[1])
    cube, times, disk = src['cube'], src['times'], src['disk']
    names = ('C11', 'C12__re', 'C12__im', 'C22')
    ds = Dataset({v: (('y', 'x', 'time'), cube[..., i])
                  for i, v in enumerate(names)},
                 coords={'time': times}, device='cpu')
    comp = ds.interpolate_na(dim='time').resample(time='1MS').mean()
    flt = ndt.ConvolutionFilter(dims=('y', 'x'), kernel=disk).apply(comp)
    change = ndt.OmnibusTest(ml=3, alpha=0.99).apply(flt)
    try:
        import pandas
    except ImportError:
        blocked = True
    else:
        blocked = False
    np.savez(sys.argv[2], blocked=blocked, times=comp['time'].values,
             comp=np.stack([comp[v].values for v in names], -1),
             flt=np.stack([flt[v].values for v in names], -1),
             change=change.values, dims=np.array(change.dims))
''')


def test_dated_stack_chain_without_pandas():
    cube, times = dated_stack(12, 14, seed=61)
    disk = np.array([[1.0 if i * i + j * j <= 5 else 0.0
                      for j in range(-2, 3)] for i in range(-2, 3)]) / 21
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, 'in.npz'), os.path.join(tmp, 'out.npz')
        np.savez(src, cube=cube, times=times, disk=disk)
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run([sys.executable, '-c', CHAIN, src, out],
                              capture_output=True, text=True, env=env,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        got = dict(np.load(out))
    assert bool(got['blocked'])

    jds = JDataset({v: (('y', 'x', 'time'), cube[..., i])
                    for i, v in enumerate(VARS)}, coords={'time': times})
    jcomp = jds.interpolate_na(dim='time').resample(time='1MS').mean()
    np.testing.assert_array_equal(got['times'],
                                  np.asarray(jcomp['time'].values))
    assert got['comp'].shape == (12, 14, 11, 4)
    ref = np.stack([np.asarray(jcomp[v].values) for v in VARS], -1)
    np.testing.assert_allclose(got['comp'], ref, rtol=1e-6, atol=1e-6)
    jflt = JConvolutionFilter(dims=('y', 'x'), kernel=disk).apply(jcomp)
    ref = np.stack([np.asarray(jflt[v].values) for v in VARS], -1)
    np.testing.assert_allclose(got['flt'], ref, rtol=1e-5, atol=1e-5)
    # the change test on the port's own composites, in both packages
    same_in = JDataset({v: (('y', 'x', 'time'), got['flt'][..., i])
                        for i, v in enumerate(VARS)},
                       coords={'time': got['times']})
    jchange = JOmnibusTest(ml=3, alpha=0.99).apply(same_in)
    assert tuple(got['dims']) == jchange.dims
    np.testing.assert_array_equal(got['change'], np.asarray(jchange.values))
    assert got['change'].any()
