"""Adding a configuration, a traffic generator, a traffic mix, a cell
and a per-layer metric takes new files only: in a copy of the
benchmark, a throwaway cell made of new files (and entries in
BENCHMARK.json) runs, and the files that were there are untouched. A
mix of the shipped generator with other parameters (several change
points a patch) is data alone. The copy without the program cannot
run."""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

from harness.runner import make_scene, run_cell
from harness.spec import load_cell
from helpers import ROOT
from run import result_of

# A second generator: gamma intensities, a cross term of fixed
# coherence, one step down by half at the middle date in every pixel of
# the tile's left half.
NEW_GENERATOR = '''
import torch
from harness.scene import Scene, tile_seed


def make(config, traffic, seed, index, device):
    import nd_tpu_torch as ndt
    ny, nx, k = (int(config[d]) for d in config['dims'])
    g = torch.Generator(device=device)
    g.manual_seed(tile_seed(seed, index))
    conc = torch.full((ny, nx, k), float(traffic['looks']), device=device)
    c11 = torch._standard_gamma(conc, generator=g) / traffic['looks']
    c22 = torch._standard_gamma(conc, generator=g) / traffic['looks']
    c11[:, :nx // 2, k // 2:] *= 0.5
    amp = (c11 * c22).sqrt()
    inputs = {'C11': c11, 'C12__re': 0.1 * amp, 'C12__im': -0.05 * amp,
              'C22': c22}
    dims = tuple(config['dims'])
    ds = ndt.Dataset({v: (dims, t) for v, t in inputs.items()},
                     attrs={'made_by': 'gamma_halves'}, device=device)
    return Scene(inputs=inputs, dataset=ds)
'''


def _copy(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'port_bench'),
                    tmp_path / 'port_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    return tmp_path


def test_a_new_cell_needs_only_new_files(tmp_path):
    root = _copy(tmp_path)
    bench = root / 'port_bench'
    cfg = json.loads((bench / 'configs' / 's1_dualpol_k12.json').read_text())
    cfg.update(name='tiny_k8', y=48, x=64, time=8, pool_tiles=2,
               reduced=['y', 'x'])
    cfg['chain']['nlmeans'].update(r=1)
    (bench / 'configs' / 'tiny_k8.json').write_text(json.dumps(cfg))
    (bench / 'generators' / 'gamma_halves.py').write_text(NEW_GENERATOR)
    (bench / 'traffic' / 'dense_small.json').write_text(json.dumps(
        {'generator': 'gamma_halves', 'stages': ['nlmeans', 'omnibus'],
         'looks': 9.0, 'in_flight': 1}))
    (bench / 'workloads' / 'tiny.dense.json').write_text(json.dumps(
        {'check_tiles': 1, 'limits': {'nlmeans_err': 2e-4,
                                      'change_mismatch': 0}}))
    (bench / 'metrics' / 'tiles_checked.py').write_text(
        'def read(run):\n    return float(len(run.tiles))\n')
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['configs'].append({'name': 'tiny_k8', 'source': 'a test',
                            'file': 'port_bench/configs/tiny_k8.json',
                            'reduced': ['y', 'x'], 'why': 'a test'})
    spec['workloads'].append({'name': 'tiny.dense', 'config': 'tiny_k8',
                              'traffic': 'dense_small', 'chips': 1,
                              'why': 'a test'})
    spec['per_layer'].append({'name': 'tiles_checked', 'unit': 'tiles',
                              'better': 'higher', 'source': 'host_clock',
                              'layer': 'harness', 'moves': 'cube_mpix_s',
                              'workloads': ['tiny.dense']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))

    cell = load_cell(root, 'tiny.dense')
    assert make_scene(cell, 1, 0, 'cpu').dataset.attrs == {
        'made_by': 'gamma_halves'}
    run = run_cell(cell, 2 ** 33 + 1, 0.3, 1, 'cpu', time.perf_counter(),
                   log=lambda *a: None)
    res = result_of(run, 1, 'cpu')
    assert res['correct'], res['checks']
    assert run.scene['flagged_px_pct'] > 0
    assert res['metrics']['tiles_checked']['value'] == len(run.tiles)
    assert set(res['checks']) == {'nlmeans_err', 'change_mismatch'}
    same = filecmp.dircmp(os.path.join(ROOT, 'port_bench'), bench,
                          ignore=['__pycache__'])

    def changed(d):
        return d.diff_files + [f for s in d.subdirs.values()
                               for f in changed(s)]
    assert changed(same) == []


def test_a_dense_mix_is_data_alone(tmp_path):
    """The Open questions' dense-change mix: 1-3 change points a patch
    over 30% of the tile, as a new traffic file of the shipped
    generator."""
    root = _copy(tmp_path)
    bench = root / 'port_bench'
    mix = json.loads((bench / 'traffic' / 'omnibus_sparse.json')
                     .read_text())
    mix.update(changed_share=0.3, changes_per_patch=[1, 3])
    (bench / 'traffic' / 'dense_change.json').write_text(json.dumps(mix))
    (bench / 'workloads' / 's1_k12.dense_change.json').write_text(
        (bench / 'workloads' / 's1_k12.omnibus_only.json').read_text())
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['workloads'].append({'name': 's1_k12.dense_change',
                              'config': 's1_dualpol_k12',
                              'traffic': 'dense_change', 'chips': 1,
                              'why': 'a test'})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    cell = load_cell(root, 's1_k12.dense_change')
    cell.config.update(y=128, x=128, pool_tiles=1)
    cell.traffic['patch'] = 16
    run = run_cell(cell, 5, 0.01, 0, 'cpu', time.perf_counter(),
                   log=lambda *a: None, warm_tiles=0, min_tiles=2)
    res = result_of(run, 0, 'cpu')
    assert res['correct'], res['checks']
    assert run.scene['change_points_max'] >= 2


def test_without_the_program_a_copy_cannot_run(tmp_path):
    root = _copy(tmp_path)
    code = ('import sys; sys.path[:0] = ["port_bench", "."]; '
            'from harness.spec import load_cell; '
            'from harness.runner import make_scene; '
            'make_scene(load_cell(".", "s1_k56.year_chain"), 1, 0, "cpu")')
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "No module named 'nd_tpu_torch'" in proc.stderr


def test_no_card_no_result(capsys):
    import run
    assert run.main(['--workload', 's1_k12.readme_chain', '--seed', '1',
                     '--seconds', '1', '--trace', '0']) == 2
    assert capsys.readouterr().out == ''
