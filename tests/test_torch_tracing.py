"""nd_tpu_torch.tracing against nd_tpu.tracing on the CPU.

Host spans: every span nd_tpu records for a call (``Algorithm.apply``
spans), the port records with the same count; the port's other spans
are its own (``PORT_SPANS``: ``OmnibusTest.apply``, the data model's
copies and the omnibus steps), exactly those a call should record (the
times are host clocks and are not compared, beyond a sleep's floor).
With no profiler a span opens no ``record_function``, records no CUDA
event and a count holds nothing; under a ``torch.profiler`` recording
the README chain's spans are ranges of the Chrome trace, nested as the
calls are, and the counters sum ints and tensors (the rescan's count
included). The device trace is ``torch.profiler``'s Chrome trace,
written into the log directory and parsed here: the ``annotate`` range
is in it and holds the filter's operator events. A second
``start_device_trace`` raises, as ``jax.profiler.start_trace`` does.
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


# the spans the port records beside nd_tpu's, by call: OmnibusTest.apply,
# the data model's copies (data.*) and the omnibus steps (omnibus.*)
README_SPANS = {'OmnibusTest.apply': 1, 'data.filter_to_array': 1,
                'data.nlmeans_contiguous': 1, 'data.filter_stack': 1,
                'data.omnibus_in': 1, 'omnibus.kernel': 1,
                'omnibus.rescan': 1, 'omnibus.unpack': 1, 'omnibus.result': 1}
PORT_SPANS = {'boxcar': {'data.filter_stack': 1}, 'readme': README_SPANS,
              'njobs': {'data.filter_stack': 5},
              'functional': {'data.filter_stack': 2}}


@pytest.mark.parametrize('name', sorted(_chain_calls()))
def test_apply_spans_match_jax(name):
    """Every span nd_tpu records for a call, the port records with the
    same count (OmnibusTest's multilook is a BoxcarFilter.apply in both);
    the port's other spans are exactly its own (``PORT_SPANS``)."""
    call = _chain_calls()[name]
    j = jgen(dims={'y': 16, 'x': 14, 'time': 4})
    call(nd_tpu, j)
    call(ndt, from_jax_dataset(j, device='cpu'))
    ref, got = _counts(jtracing.report()), _counts(tracing.report())
    assert ref and {k: got.get(k) for k in ref} == ref
    assert {k: v for k, v in got.items() if k not in ref} == PORT_SPANS[name]


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


def _readme_chain(ny=24, nx=20, k=12):
    from torch_cubes import sar_cube
    cube = torch.from_numpy(sar_cube(ny, nx, k, seed=3, special=False))
    ds = ndt.Dataset({v: (('y', 'x', 'time'), cube[..., i]) for i, v in
                      enumerate(('C11', 'C12__re', 'C12__im', 'C22'))})
    nlm = ndt.NLMeansFilter(dims=('y', 'x'), r=2, f=1, sigma=2, h=3)
    omn = ndt.OmnibusTest(ml=3, alpha=0.01)
    return lambda: omn.apply(nlm.apply(ds))


class _Event:
    """A stand-in for a CUDA timing event on the host clock (seconds
    apart as milliseconds), counting how many were made."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        assert stream is _STREAM
        self.at = time.perf_counter()

    def query(self):
        return self.at is not None

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return 1e3 * (end.at - self.at)


class _Stream:
    device_index = 0


_STREAM = _Stream()


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA reported initialised, its stream a stand-in, its events on
    the host clock, and the ``record_function`` ranges the spans open
    counted."""
    opened = []

    class Range(tracing.record_function):
        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(_Event, 'made', 0)
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch._C, '_CudaEventBase', _Event)
    monkeypatch.setattr(tracing, '_current_stream', lambda: _STREAM)
    monkeypatch.setattr(tracing, 'record_function', Range)
    return opened


def test_without_a_profiler_the_chain_opens_no_range_event_or_count(
        fake_cuda):
    """No profiler: the README chain's spans open no range, make no event
    and hold no counted tensor, though CUDA reads as initialised; each
    span keeps its host aggregate alone."""
    chain = _readme_chain()
    chain()
    tracing.count('omnibus.rescanned', torch.tensor([7], dtype=torch.int32))
    assert fake_cuda == [] and _Event.made == 0
    assert tracing.counters() == {} and not tracing._COUNTS
    rep = tracing.report()
    assert {k for k in rep if k in README_SPANS} == set(README_SPANS)
    assert all(set(v) == {'count', 'total', 'max'} for v in rep.values())


def test_under_a_profiler_spans_time_the_stream(fake_cuda):
    """Under a CPU profiler with CUDA reading as initialised: each span
    opens its range and records an event pair, and ``report`` adds the
    pairs' summed time as ``device``; ``reset`` drops it all."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tracing.span('outer'):
                with tracing.span('inner'):
                    time.sleep(0.002)
    assert fake_cuda == ['outer', 'inner'] * 3 and _Event.made == 12
    rep = tracing.report()
    assert rep['inner']['count'] == rep['outer']['count'] == 3
    assert 0.006 <= rep['inner']['device'] <= rep['outer']['device']
    assert rep['outer']['device'] == pytest.approx(rep['outer']['total'],
                                                   abs=1e-3)
    assert tracing.report()['inner']['device'] == rep['inner']['device']
    tracing.reset()
    assert tracing.report() == {} and not tracing._PENDING


def test_report_resolves_pairs_and_a_later_trace_adds_to_them(fake_cuda):
    """The pairs wait unread until ``report``, which resolves every one;
    the spans of a later trace add their device seconds to the total."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(20):
            with tracing.span('a'):
                pass
    assert len(tracing._PENDING) == 3 * 20 and _Event.made == 40
    rep = tracing.report()
    assert not tracing._PENDING
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with tracing.span('a'):
                time.sleep(0.001)
    rep2 = tracing.report()
    assert rep2['a']['count'] == 25 and _Event.made == 50
    assert rep2['a']['device'] - rep['a']['device'] >= 0.005
    assert rep2['a']['device'] == pytest.approx(rep2['a']['total'],
                                                abs=1e-3)


def test_tensor_counts_sum_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile
    tracing.count('n', 5)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count('n', 3)
        tracing.count('n', torch.tensor([4], dtype=torch.int32))
        tracing.count('m', torch.tensor([2**40]))
        tracing.count('n', np.int64(2))
    tracing.count('n', 100)
    assert tracing.counters() == {'n': 9, 'm': 2**40}
    assert tracing.counters() == {'n': 9, 'm': 2**40}
    tracing.reset()
    assert tracing.counters() == {}


def test_readme_chain_spans_nest_in_the_chrome_trace(tmp_path):
    """The README chain under a CPU profiler: each of its spans is a
    ``user_annotation`` range of the Chrome trace, once, inside the
    ``<Class>.apply`` range of the call that opened it."""
    chain = _readme_chain()
    chain()
    tracing.start_device_trace(str(tmp_path))
    chain()
    tracing.stop_device_trace()
    _, events = _trace_file(tmp_path)
    ranges = {}
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') == 'user_annotation':
            assert e['name'] not in ranges, e['name']
            ranges[e['name']] = (e['ts'], e['ts'] + e['dur'])
    assert set(README_SPANS) | {'NLMeansFilter.apply',
                                'BoxcarFilter.apply'} <= set(ranges)

    def inside(name, outer):
        return (ranges[outer][0] <= ranges[name][0]
                and ranges[name][1] <= ranges[outer][1])
    for name in ('data.filter_to_array', 'data.nlmeans_contiguous'):
        assert inside(name, 'NLMeansFilter.apply')
        assert not inside(name, 'OmnibusTest.apply')
    for name in set(README_SPANS) - {'OmnibusTest.apply',
                                     'data.filter_to_array',
                                     'data.nlmeans_contiguous'}:
        assert inside(name, 'OmnibusTest.apply'), name
    assert inside('data.filter_stack', 'BoxcarFilter.apply')
    assert inside('BoxcarFilter.apply', 'OmnibusTest.apply')
    steps = ['data.omnibus_in', 'omnibus.kernel', 'omnibus.rescan',
             'omnibus.unpack', 'omnibus.result']
    assert [ranges[a][1] <= ranges[b][0]
            for a, b in zip(steps, steps[1:])] == [True] * 4
    assert _counts(tracing.report()) == dict(
        README_SPANS, **{'NLMeansFilter.apply': 2, 'BoxcarFilter.apply': 2,
                         **{k: 2 for k in README_SPANS}})


@pytest.mark.parametrize('k,alpha', [(12, 0.01), (56, 0.5), (56, 1e-12)])
def test_rescan_counters_equal_the_exact_modes_count(k, alpha):
    """``omnibus.rescanned`` and ``omnibus.pixels``, the inputs of
    ``rescan_suspect_pct``, equal ``change_detection_exact``'s count and
    the pixel count: the round kernel's route (k = 12: most pixels pass
    its round cap at alpha 0.01), the scan's (k = 56: one suspect) and the
    whole-grid 'mixed' route (thresholds infeasible at alpha 1e-12: every
    pixel)."""
    from torch.profiler import ProfilerActivity, profile
    from torch_cubes import long_stack_cube, sar_cube
    from nd_tpu_torch.ops.change import change_detection_exact
    cube = (sar_cube(6, 8, k, seed=5) if k == 12
            else long_stack_cube(8, 12, k, seed=2))
    cube = torch.from_numpy(cube)
    with profile(activities=[ProfilerActivity.CPU]):
        _, n = change_detection_exact(cube, alpha, n=9, return_count=True)
        _, m = change_detection_exact(cube, alpha, n=9, return_count=True)
    pixels = cube.shape[0] * cube.shape[1]
    assert n == m and 0 < n <= pixels
    assert (n == pixels) == (alpha == 1e-12)
    assert tracing.counters() == {'omnibus.pixels': 2 * pixels,
                                  'omnibus.rescanned': 2 * n}
