"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a stage that returns its state
unchanged, half of a tile left out, an answer altered where it is
produced (one chip: no exchange between chips to leave out). The run
skips only the look for a card and runs on the CPU at a small size."""

import time

import pytest
import torch

import nd_tpu_torch.change as change_mod
import nd_tpu_torch.filters as filters_mod
from harness.runner import run_cell
from helpers import small_cell
from run import result_of


def _nlmeans_fault(real, fault):
    def broken(arr, r, f, sigma, h, n_eff=-1.0, device=None):
        if fault == 'unchanged':
            return arr
        out = real(arr, r, f, sigma, h, n_eff).clone()
        if fault == 'half':
            n = out.shape[0] // 2
            out[n:] = arr[n:]
        else:
            flat = out.view(-1)
            flat[flat.numel() // 2] += 0.01 * float(out.abs().max())
        return out
    return broken


def _omnibus_fault(real, fault):
    def broken(values, alpha, n=1, **kw):
        out = real(values, alpha, n=n, **kw)
        if fault == 'unchanged':
            return torch.zeros_like(out)
        out = out.clone()
        if fault == 'half':
            out[out.shape[0] // 2:] = False
        else:
            out[0, 0, 1] = ~out[0, 0, 1]
        return out
    return broken


FAULTS = [(c, s, f)
          for c, stages in (('s1_k12.readme_chain', ('nlmeans', 'omnibus')),
                            ('s1_k56.year_chain', ('nlmeans', 'omnibus')),
                            ('s1_k12.omnibus_only', ('omnibus',)),
                            ('s1_k56.omnibus_only', ('omnibus',)))
          for s in stages for f in ('unchanged', 'half', 'altered')]


def _small(name):
    cell = small_cell(name)
    cell.traffic['changed_share'] = 1.0
    return cell


def _run(cell, seed=3):
    run = run_cell(cell, seed, 0.3, 0, 'cpu', time.perf_counter(),
                   log=lambda *a: None)
    return result_of(run, 0, 'cpu')


@pytest.mark.parametrize('name', [c for c, s, f in FAULTS[::3]
                                  if s == 'omnibus'])
def test_sound_run_is_correct(name):
    res = _run(_small(name))
    assert res['correct'] and res['failed'] == 0, res['checks']
    assert list(res)[-1] == 'checks'


@pytest.mark.parametrize('name,stage,fault', FAULTS)
def test_fault_makes_the_run_not_correct(monkeypatch, name, stage, fault):
    if stage == 'nlmeans':
        monkeypatch.setattr(filters_mod, '_nlmeans', _nlmeans_fault(
            filters_mod._nlmeans, fault))
    else:
        monkeypatch.setattr(change_mod, 'change_detection_exact',
                            _omnibus_fault(change_mod.change_detection_exact,
                                           fault))
    res = _run(_small(name))
    assert not res['correct']
    assert res['failed'] >= 1
    over = [n for n, c in res['checks'].items() if not c['value']
            <= c['limit']]
    assert over, res['checks']
