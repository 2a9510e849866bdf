"""The plain references against the port on the CPU at a tiny size, and
their independence from the port."""

import os
import subprocess
import sys

import pytest
import torch

from harness.runner import make_scene
from helpers import ROOT, small_cell
from reference import nlmeans as ref_nl
from reference import omnibus as ref_om
from reference.omnibus import VARIABLES

import nd_tpu_torch as ndt

DIMS = ('y', 'x', 'time')


def _tile(name, **kw):
    cell = small_cell(name, **kw)
    cell.traffic['changed_share'] = 1.0
    return cell, make_scene(cell, 11, 0, 'cpu').inputs


def _ds(tile):
    return ndt.Dataset({v: (DIMS, t) for v, t in tile.items()},
                       device='cpu')


@pytest.mark.parametrize('name', ['s1_k12.readme_chain',
                                  's1_k56.year_chain'])
def test_nlmeans_reference_matches_the_port(name):
    cell, tile = _tile(name, y=40, x=48)
    params = cell.config['chain']['nlmeans']
    got = ndt.NLMeansFilter(dims=tuple(params['dims']), r=params['r'],
                            f=params['f'], sigma=params['sigma'],
                            h=params['h']).apply(_ds(tile))
    r, f = ref_nl.window(params, DIMS)
    want = ref_nl.nlmeans(torch.stack([tile[v] for v in VARIABLES], -1),
                          r, f, params['sigma'], params['h'], rows=7)
    for i, v in enumerate(VARIABLES):
        w = want[..., i]
        err = float((got[v].data.double() - w).abs().max() / w.abs().max())
        assert err < 2e-6, (v, err)
    whole = ref_nl.nlmeans(torch.stack([tile[v] for v in VARIABLES], -1),
                           r, f, params['sigma'], params['h'])
    assert torch.equal(whole, want)          # blocks change nothing


def test_window_of_the_two_configurations():
    spatial = {'dims': ['y', 'x'], 'r': 2, 'f': 1}
    full = {'dims': ['y', 'x', 'time'], 'r': [2, 2, 1], 'f': 1}
    assert ref_nl.window(spatial, DIMS) == ((2, 2, 0), (1, 1, 0))
    assert ref_nl.window(full, DIMS) == ((2, 2, 1), (1, 1, 1))


def test_multilook_is_bit_equal_to_the_boxcar():
    _, tile = _tile('s1_k12.omnibus_only', y=33, x=41)
    got = ndt.BoxcarFilter(w=3).apply(_ds(tile))
    looked = ref_om.multilook(tile, 3)
    for i, v in enumerate(VARIABLES):
        assert torch.equal(got[v].data, looked[..., i]), v


@pytest.mark.parametrize('name', ['s1_k12.omnibus_only',
                                  's1_k56.omnibus_only'])
def test_change_map_equals_the_port(name):
    cell, tile = _tile(name, y=64, x=64, k56=56)
    p = cell.config['chain']['omnibus']
    got = ndt.OmnibusTest(ml=p['ml'], alpha=p['alpha']).apply(_ds(tile))
    want = ref_om.change_map(tile, p['ml'], p['alpha'])
    assert int(want.sum()) > 0
    assert torch.equal(got.data, want)


def test_thresholds_solve_the_chi_square_mixture():
    from scipy.stats import chi2
    z = ref_om.thresholds(12, 9.0, 0.01)
    assert z[0] == z[1] == float('inf')
    j, n, p = 5, 9.0, 2.0
    rho = 1 - (2 * p * p - 1) / (6 * (j - 1) * p) * (j / n - 1 / (n * j))
    om = (p * p * (p * p - 1) / (24 * rho * rho)
          * (j / n ** 2 - 1 / (n * j) ** 2)
          - p * p * (j - 1) / 4 * (1 - 1 / rho) ** 2)
    f = (j - 1) * p * p
    prob = chi2.cdf(z[j], f) + om * (chi2.cdf(z[j], f + 4)
                                     - chi2.cdf(z[j], f))
    assert prob == pytest.approx(0.01, abs=1e-12)


def test_reference_imports_nothing_of_the_port():
    code = ('import sys; sys.path.insert(0, %r); '
            'import reference.nlmeans, reference.omnibus; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("nd_tpu_torch", "nd_tpu", "jax", "jaxlib", "flax")]; '
            'print(bad); sys.exit(1 if bad else 0)'
            % os.path.join(ROOT, 'port_bench'))
    proc = subprocess.run([sys.executable, '-c', code], cwd='/',
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
