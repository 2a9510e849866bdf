"""nd_tpu_torch.tracing against nd_tpu.tracing on the CPU.

Host spans: the port records the same span names with the same counts
as nd_tpu for the same calls (``Algorithm.apply`` spans included; the
times are host clocks and are not compared, beyond a sleep's floor).
The device trace is ``torch.profiler``'s Chrome trace, written into the
log directory and parsed here: the ``annotate`` range is in it and holds
the filter's operator events. A second ``start_device_trace`` raises, as
``jax.profiler.start_trace`` does.
"""

import glob
import json
import os
import time

import numpy as np
import pytest
import torch

import nd_tpu
from nd_tpu import tracing as jtracing
from nd_tpu.testing import generate_test_dataset as jgen
import nd_tpu_torch as ndt
from nd_tpu_torch import tracing
from nd_tpu_torch.core import from_jax_dataset
from nd_tpu_torch.testing import generate_test_dataset as tgen


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    jtracing.reset()
    yield
    if tracing._PROFILER is not None:
        tracing.stop_device_trace()


def _counts(report):
    return {k: v['count'] for k, v in report.items()}


def test_tracing_spans():
    tracing.reset()
    with tracing.span('unit-test'):
        time.sleep(0.01)

    @tracing.trace('deco-test')
    def fn():
        return 42

    assert fn() == 42
    rep = tracing.report()
    assert rep['unit-test']['count'] == 1
    assert rep['unit-test']['total'] >= 0.01
    assert rep['unit-test']['max'] == rep['unit-test']['total']
    assert rep['deco-test']['count'] == 1
    assert set(rep['deco-test']) == {'count', 'total', 'max'}
    assert json.loads(tracing.report(as_json=True)) == rep


def test_algorithm_apply_traced():
    """Every Algorithm.apply records a tracing span automatically."""
    ds = tgen(dims={'y': 8, 'x': 8, 'time': 2}, device='cpu')
    ndt.BoxcarFilter(w=3).apply(ds)
    rep = tracing.report()
    assert rep['BoxcarFilter.apply']['count'] == 1


def test_trace_bare_and_parametrised_match_jax():
    def run(mod):
        @mod.trace
        def bare(x):
            return x + 1

        @mod.trace('named')
        def named(x):
            return x * 2

        @mod.trace('')
        def empty(x):
            return x

        assert (bare(1), named(2), empty(3), bare(4)) == (2, 4, 3, 5)
        assert bare.__name__ == 'bare'
        return _counts(mod.report())
    got, ref = run(tracing), run(jtracing)
    assert got == ref
    assert got['named'] == 1
    assert any(k.endswith('.bare') and v == 2 for k, v in got.items())


def _chain_calls():
    def boxcar(mod, ds):
        mod.filters.BoxcarFilter(w=3).apply(ds)

    def readme(mod, ds):
        flt = mod.filters.NLMeansFilter(r=1, f=1, sigma=2, h=3).apply(ds)
        mod.change.OmnibusTest(ml=3, alpha=0.01).apply(flt)

    def njobs(mod, ds):
        mod.filters.GaussianFilter(sigma=1).apply(ds, njobs=2)
        mod.filters.BoxcarFilter(w=3).apply(ds, njobs=3)

    def functional(mod, ds):
        mod.filters.boxcar(ds, w=3)
        mod.filters.gaussian(ds, sigma=1.5)
    return {'boxcar': boxcar, 'readme': readme, 'njobs': njobs,
            'functional': functional}


@pytest.mark.parametrize('name', sorted(_chain_calls()))
def test_apply_spans_match_jax(name):
    """The same calls record the same spans, with the same counts, in both
    packages (OmnibusTest's multilook is a BoxcarFilter.apply in both)."""
    call = _chain_calls()[name]
    j = jgen(dims={'y': 16, 'x': 14, 'time': 4})
    call(nd_tpu, j)
    call(ndt, from_jax_dataset(j, device='cpu'))
    ref, got = _counts(jtracing.report()), _counts(tracing.report())
    assert got == ref and got


def _trace_file(logdir):
    files = glob.glob(os.path.join(str(logdir), '*.pt.trace.json'))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return files[0], json.load(fh)['traceEvents']


def test_device_trace_of_boxcar(tmp_path):
    """A Chrome trace of BoxcarFilter on the CPU: written into the log
    directory, the annotate range in it, the filter's operators inside
    that range, and the host span recorded beside it."""
    ds = tgen(dims={'y': 32, 'x': 30, 'time': 3}, device='cpu')
    ref = ndt.BoxcarFilter(w=3).apply(ds)
    tracing.reset()
    tracing.start_device_trace(str(tmp_path))
    with tracing.annotate('boxcar'):
        got = ndt.BoxcarFilter(w=3).apply(ds)
    tracing.stop_device_trace()
    for v in ref.data_vars:
        assert torch.equal(got[v].data, ref[v].data)
    path, events = _trace_file(tmp_path)
    assert os.path.getsize(path) > 0
    ranges = [e for e in events if e.get('name') == 'boxcar'
              and e.get('ph') == 'X']
    assert len(ranges) == 1
    r = ranges[0]
    assert r.get('cat') == 'user_annotation'
    inside = [e for e in events if e.get('cat') == 'cpu_op'
              and e.get('ph') == 'X' and r['ts'] <= e['ts']
              and e['ts'] + e.get('dur', 0) <= r['ts'] + r['dur']]
    names = {e['name'] for e in inside}
    assert any(n.startswith('aten::') for n in names), sorted(names)[:20]
    assert tracing.report()['BoxcarFilter.apply']['count'] == 1


def test_second_start_raises(tmp_path):
    tracing.start_device_trace(str(tmp_path / 'a'))
    with pytest.raises(RuntimeError, match='already running'):
        tracing.start_device_trace(str(tmp_path / 'b'))
    tracing.stop_device_trace()
    with pytest.raises(RuntimeError, match='no device trace'):
        tracing.stop_device_trace()
    # a trace can start again once the first has stopped
    tracing.start_device_trace(str(tmp_path / 'c'))
    tracing.stop_device_trace()
    _trace_file(tmp_path / 'c')


def test_annotate_without_a_trace_is_a_plain_range():
    with tracing.annotate('outside'):
        x = torch.arange(4.0) * 2
    np.testing.assert_array_equal(x.numpy(), [0, 2, 4, 6])
