"""The readers of the program's spans and counters: copy_ms_per_tile,
unpack_ms_per_tile and rescan_suspect_pct, on a registry written by
hand, on one that lacks their data (as a program without these spans
and counters has), and on a small traced run on the CPU (counters, but
no device times: a CUDA event needs a card)."""

import time

import pytest

from harness.runner import Run, run_cell
from harness.spec import load_plugin
from helpers import ROOT, small_cell
from nd_tpu_torch import tracing

NAMES = ('copy_ms_per_tile', 'unpack_ms_per_tile', 'rescan_suspect_pct')


def read(name, run):
    return load_plugin(ROOT, 'metrics', name).read(run)


def _run(tiles):
    run = Run(cell=small_cell('s1_k12.readme_chain'), seed=1)
    run.trace = {'tiles': tiles}
    return run


@pytest.fixture(autouse=True)
def _clean():
    tracing.reset()
    yield
    tracing.reset()


def test_readers_of_device_times_and_counters(monkeypatch):
    spans = {'data.filter_stack': {'count': 4, 'total': 1e-3, 'max': 1e-3,
                                   'device': 0.010},
             'data.omnibus_in': {'count': 4, 'total': 1e-3, 'max': 1e-3,
                                 'device': 0.030},
             'data.never_on_the_card': {'count': 1, 'total': 1e-3,
                                        'max': 1e-3},
             'omnibus.unpack': {'count': 4, 'total': 1e-3, 'max': 1e-3,
                                'device': 0.002},
             'OmnibusTest.apply': {'count': 4, 'total': 0.1, 'max': 0.03,
                                   'device': 0.5}}
    monkeypatch.setattr(tracing, 'report', lambda: spans)
    monkeypatch.setattr(tracing, 'counters', lambda: {
        'omnibus.pixels': 4000, 'omnibus.rescanned': 30})
    run = _run(4)
    assert read('copy_ms_per_tile', run) == pytest.approx(10.0)
    assert read('unpack_ms_per_tile', run) == pytest.approx(0.5)
    assert read('rescan_suspect_pct', run) == pytest.approx(0.75)
    run.trace = None
    assert [read(n, run) for n in NAMES] == [None] * 3


def test_readers_of_a_program_without_the_spans_give_none(monkeypatch):
    """Host aggregates alone and no ``counters``: a program that records
    none of what the readers read. They give None and do not raise."""
    monkeypatch.setattr(tracing, 'report', lambda: {
        'OmnibusTest.apply': {'count': 4, 'total': 0.1, 'max': 0.03}})
    monkeypatch.delattr(tracing, 'counters')
    assert [read(n, _run(4)) for n in NAMES] == [None] * 3


def test_a_traced_cpu_run_counts_the_rescans_and_times_nothing():
    """A small traced run of the omnibus-only cell on the CPU: the
    counters cover the traced window's tiles alone, and without a card
    no span has device time."""
    cell = small_cell('s1_k12.omnibus_only', y=48, x=64)
    run = run_cell(cell, 2 ** 33 + 7, 0.05, 1, 'cpu', time.perf_counter(),
                   log=lambda *a: None)
    got = tracing.counters()
    assert got['omnibus.pixels'] == 48 * 64 * run.trace['tiles']
    assert 0 <= got['omnibus.rescanned'] <= got['omnibus.pixels']
    assert read('rescan_suspect_pct', run) == pytest.approx(
        100.0 * got['omnibus.rescanned'] / got['omnibus.pixels'])
    assert read('copy_ms_per_tile', run) is None
    assert read('unpack_ms_per_tile', run) is None
    assert tracing.report()['OmnibusTest.apply']['count'] \
        > run.trace['tiles']
