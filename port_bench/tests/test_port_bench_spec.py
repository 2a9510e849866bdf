"""BENCHMARK.json and the files it names: every cell resolves to files
that exist, and the file keeps to the benchmark's contract."""

import json
import os
import re

import pytest

from harness.spec import BENCH_DIR, load_cell, load_json, load_plugin
from helpers import CELLS, ROOT

BENCH = load_json(os.path.join(ROOT, 'BENCHMARK.json'))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRIC_KEYS = {'name', 'unit', 'better', 'bound', 'source'}
LAYER_KEYS = {'name', 'unit', 'better', 'source', 'layer', 'moves'}


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'port_bench/run.py']
    assert BENCH['paths'] == [BENCH_DIR]
    assert len(json.dumps(BENCH, indent=2)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_the_four_cells_on_one_chip():
    assert [w['name'] for w in BENCH['workloads']] == list(CELLS)
    assert {w['config'] for w in BENCH['workloads']} == {
        's1_dualpol_k12', 's1_dualpol_k56'}
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and NAME.match(w['name'])
        assert 1 <= len(w['why']) <= 200 and '\n' not in w['why']


@pytest.mark.parametrize('name', CELLS)
def test_cell_files_exist_and_name_what_runs(name):
    cell = load_cell(ROOT, name)
    assert cell.tile_shape == tuple(cell.config[d]
                                    for d in cell.config['dims'])
    checks = set()
    for kind, params in cell.stages:
        mod = load_plugin(ROOT, 'stages', kind)
        checks |= set(mod.CHECKS)
        assert hasattr(load_plugin(ROOT, 'roofline', kind), 'work')
        assert params == cell.config['chain'][kind]
    assert set(cell.limits) == checks
    assert cell.check_tiles >= 1
    assert hasattr(load_plugin(ROOT, 'generators',
                               cell.traffic['generator']), 'make')
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(load_plugin(ROOT, 'metrics', m['name']), 'read')


def test_configs_state_their_cuts():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith(BENCH_DIR + '/')
        cfg = load_json(os.path.join(ROOT, c['file']))
        assert cfg['name'] == c['name']
        assert cfg['reduced'] == c['reduced']
        assert cfg['source'] == c['source'] and len(c['source']) <= 200
        for key in c['reduced']:
            assert key in cfg and 'scene_' + key in cfg
            assert cfg[key] < cfg['scene_' + key]


def test_metrics_keep_to_the_contract():
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(set(names)) == len(names)
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == METRIC_KEYS
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == LAYER_KEYS
        assert m['moves'] in e2e
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        for cell in m.get('workloads', CELLS):
            moved = e2e[m['moves']]
            assert cell in moved.get('workloads', CELLS)
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', CELLS)) <= set(CELLS)


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_reports_enough(name):
    cell = load_cell(ROOT, name)
    e2e = [m['name'] for m in cell.end_to_end]
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer
