"""The traffic generator 'wishart_patches': the same tile for the same
seed and index, another for another; complex-Wishart speckle at the
configuration's looks; exactly the changed share in patches, each step
within the mix's range in dB; the Dataset's coordinates."""

import copy
import math

import numpy as np
import pytest
import torch

from harness.runner import make_scene
from harness.scene import tile_seed
from helpers import small_cell

BIG = 2 ** 31 + 12345          # seeds past 32 signed bits


def _gen(cell):
    from harness.spec import load_plugin
    return load_plugin(cell.root, 'generators', cell.traffic['generator'])


def _tile(cell, seed, index):
    return make_scene(cell, seed, index, 'cpu').inputs


def test_same_seed_same_tile_other_seed_other_tile():
    cell = small_cell('s1_k12.readme_chain')
    a, b = _tile(cell, BIG, 1), _tile(cell, BIG, 1)
    for v in a:
        assert torch.equal(a[v], b[v])
    other_seed, other_index = _tile(cell, BIG + 1, 1), _tile(cell, BIG, 2)
    assert not torch.equal(a['C11'], other_seed['C11'])
    assert not torch.equal(a['C11'], other_index['C11'])
    assert len({tile_seed(BIG, i) for i in range(8)}) == 8
    assert all(0 <= tile_seed(2 ** 40 + s, 3) < 2 ** 63 for s in range(4))


def test_speckle_is_wishart_at_the_configured_looks():
    cell = small_cell('s1_k12.omnibus_only', y=256, x=256)
    cell.traffic['changed_share'] = 0.0
    t = _tile(cell, 5, 0)
    sp = cell.config['speckle']
    s11, s22 = (10 ** (db / 10) for db in sp['sigma_db'])
    c11, c22 = t['C11'].double(), t['C22'].double()
    assert float(c11.mean()) == pytest.approx(s11, rel=0.01)
    assert float(c22.mean()) == pytest.approx(s22, rel=0.01)
    assert float(t['C12__re'].double().mean()) == pytest.approx(
        sp['coherence'] * math.sqrt(s11 * s22), rel=0.03)
    assert abs(float(t['C12__im'].double().mean())) < 0.01 * math.sqrt(
        s11 * s22)
    for c in (c11, c22):             # an intensity's ENL: mean^2 / var
        assert float(c.mean() ** 2 / c.var()) == pytest.approx(
            sp['enl'], rel=0.03)
    det = c11 * c22 - t['C12__re'].double() ** 2 \
        - t['C12__im'].double() ** 2
    assert float(det.min()) > 0 and t['C11'].dtype == torch.float32


def test_changed_share_in_patches_and_steps_in_range():
    cell = small_cell('s1_k12.readme_chain', y=256, x=320, patch=32)
    cell.traffic['changed_share'] = 0.25
    calm = copy.deepcopy(cell)
    calm.traffic['changes_per_patch'] = [0, 0]   # the same speckle
    got, still = _tile(cell, 7, 0), _tile(calm, 7, 0)
    changed = (got['C11'] != still['C11']).any(-1)
    n = _gen(cell).patch_count(256, 320, 32, 0.25)
    assert n == 20
    assert int(changed.sum()) == n * 32 * 32
    ratio = got['C11'].double() / still['C11'].double()
    for v in ('C12__re', 'C12__im', 'C22'):       # Sigma scaled whole
        r = got[v].double() / still[v].double()
        assert torch.allclose(r, ratio, rtol=1e-5)
    # whole patches on the grid, each one step at a date of its own
    blocks = ratio.view(8, 32, 10, 32, 12).permute(0, 2, 1, 3, 4) \
        .reshape(80, 32 * 32, 12)
    lo, hi = cell.traffic['step_db']
    for b in blocks:
        if not (b != 1).any():
            continue
        assert torch.allclose(b, b[:1].expand_as(b), rtol=1e-6)
        levels = torch.unique(torch.round(b[0] * 1e4))
        assert len(levels) == 2 and float(b[0, 0]) == 1.0
        db = abs(10 * math.log10(float(b[0, -1])))
        assert lo - 1e-4 <= db <= hi + 1e-4


def test_dense_change_by_data_alone():
    cell = small_cell('s1_k12.readme_chain', y=128, x=128, patch=32)
    cell.traffic.update(changed_share=1.0, changes_per_patch=[1, 3])
    calm = copy.deepcopy(cell)
    calm.traffic['changes_per_patch'] = [0, 0]
    ratio = _tile(cell, 9, 0)['C11'].double() \
        / _tile(calm, 9, 0)['C11'].double()
    points = [int((torch.diff(ratio[y, x]).abs() > 1e-6).sum())
              for y in range(0, 128, 32) for x in range(0, 128, 32)]
    assert max(points) <= 3 and min(points) >= 1 and max(points) >= 2


def test_the_dataset_has_the_grids_coordinates():
    cell = small_cell('s1_k56.year_chain', y=40, x=48)
    ds = make_scene(cell, 3, 2, 'cpu').dataset
    g = cell.config['grid']
    assert ds.attrs['crs'] == g['crs']
    y = np.asarray(ds['y'].values)
    x = np.asarray(ds['x'].values)
    t = np.asarray(ds['time'].values)
    assert len(y) == 40 and len(x) == 48 and len(t) == 20
    assert np.all(np.diff(y) == -g['spacing'])
    assert x[0] == g['x0'] + (2 * 48 + 0.5) * g['spacing']
    assert np.all(np.diff(t) == np.timedelta64(g['revisit_days'], 'D'))
    assert str(t[0])[:10] == g['t0']
