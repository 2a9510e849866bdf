"""What a run reports of its scene: the omnibus stage's reading of a
change map, and the set-up's parts summing to ``setup_s``."""

import time

import torch

from harness.runner import run_cell
from harness.spec import load_plugin
from helpers import ROOT, small_cell


def test_describe_reads_flags_and_change_points():
    flags = torch.zeros((4, 5, 6), dtype=torch.bool)
    flags[0, 0, [1, 3, 5]] = True
    flags[2, 4, 2] = True
    got = load_plugin(ROOT, 'stages', 'omnibus').describe(flags)
    assert got == {'flagged_px_pct': 10.0, 'change_points_per_px': 0.2,
                   'change_points_max': 3.0}


def test_setup_parts_cover_the_setup():
    t0 = time.perf_counter()
    run = run_cell(small_cell('s1_k56.omnibus_only'), 4, 0.05, 0, 'cpu',
                   t0, log=lambda *a: None,
                   marks=[('import_torch', time.perf_counter())])
    assert list(run.setup_parts) == ['import_torch', 'harness', 'stages',
                                     'pool', 'warm_up']
    assert abs(sum(run.setup_parts.values()) - run.setup_s) < 1e-6
    assert set(run.scene) == {'flagged_px_pct', 'change_points_per_px',
                              'change_points_max'}
