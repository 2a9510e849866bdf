"""The control (the reference one precision step below the
configuration's, in the program's place) makes a run come out not
correct through the run's own check; the program's run is correct. On
the CPU at a small size, and at the cell's own size on a card."""

import time

import pytest
import torch

from harness.runner import run_cell
from harness.spec import load_cell
from helpers import CELLS, ROOT, small_cell
from run import result_of


def _result(cell, seed, side, device):
    run = run_cell(cell, seed, 0.01, 0, device, time.perf_counter(),
                   log=lambda *a: None, side=side, warm_tiles=0,
                   min_tiles=cell.check_tiles)
    return result_of(run, 0, device)


@pytest.mark.parametrize('side', ['program', 'control'])
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_and_program_passes_small(name, side):
    cell = small_cell(name, y=128, x=128, patch=16, k56=56)
    cell.traffic['changed_share'] = 0.25
    for seed in (1, 2, 3):
        res = _result(cell, seed, side, 'cpu')
        assert res['correct'] is (side == 'program'), res['checks']
        assert res['attempted'] >= cell.check_tiles


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the cell\'s own size')
    cell = load_cell(ROOT, name)
    for seed in (901, 902, 903):
        assert _result(cell, seed, 'control', 'cuda')['correct'] is False
