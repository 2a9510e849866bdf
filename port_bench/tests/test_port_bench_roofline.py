"""The frozen work counts against counts made by hand."""

import torch

from harness.spec import load_json, load_plugin
from helpers import ROOT

DIMS = ('y', 'x', 'time')


def test_peaks_are_the_data_sheets():
    p = load_json(ROOT + '/port_bench/roofline/peaks.json')
    assert (p['hbm_bytes_per_s'], p['f32_ops_per_s'],
            p['f64_ops_per_s']) == (3.35e12, 67e12, 34e12)


def test_nlmeans_counts():
    roof = load_plugin(ROOT, 'roofline', 'nlmeans')
    spatial = {'dims': ['y', 'x'], 'r': 2, 'f': 1, 'sigma': 2, 'h': 3}
    # 5 x 5 window: 12 pairs; per pair 11 + 2 (1 + 1) + 5 + 2 * 10 = 40
    w = roof.work((4, 4, 2), 4, spatial, DIMS)
    assert w == {'bytes': 2 * 32 * 4 * 4, 'f32_ops': 32 * 12 * 40,
                 'f64_ops': 0}
    full = {'dims': ['y', 'x', 'time'], 'r': [2, 2, 1], 'f': 1}
    # 5 x 5 x 3 window: 37 pairs; per pair 11 + 2 * 3 + 5 + 20 = 42
    assert roof.work((4, 4, 2), 4, full, DIMS)['f32_ops'] == 32 * 37 * 42


def test_omnibus_counts():
    roof = load_plugin(ROOT, 'roofline', 'omnibus')
    flags = torch.zeros((1, 2, 5), dtype=torch.bool)
    flags[0, 1, 2] = True          # a round from date 2: 3 steps
    flags[0, 1, 4] = True          # the last date starts no round
    # pixel 0: one round of 5 steps (4 tested); pixel 1: 5 + 3 steps in
    # two rounds (6 tested)
    assert roof.steps(flags) == (13, 10)
    w = roof.work((1, 2, 5), 4, {'ml': 3}, DIMS, flags)
    looks = 10 * 4 * 5
    test = 10 * (6 + 25) + 13 * 6 + 10 * (19 + 25)
    assert w == {'bytes': 10 * 16 + 10, 'f32_ops': looks + test,
                 'f64_ops': 0}
