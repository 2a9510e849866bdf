"""Readings that set a cell's limits: the numbers a run compares, for
the program or for a control in its place, on several seeds, at the
cell's own size, in one process.

    python3 port_bench/control.py --workload <cell> --side control \
        --seeds 1 2 3 [--seconds 0.5]

Each seed is one run of the cell (``harness.runner.run_cell``) with
``--side`` in the program's place (``program``, or a name of a stage's
``CONTROLS``: ``control`` is the plain reference one precision step
below the configuration's), a short window of at least ``check_tiles``
tiles, judged by the run's own check (``run.result_of``). One JSON line
per seed: ``correct`` and each number beside its limit. The benchmark's
own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from harness.runner import run_cell  # noqa: E402
from harness.spec import load_cell  # noqa: E402
from run import result_of  # noqa: E402


def reading(cell, seed, side, seconds, device):
    """The result line's object of one short run of ``side``."""
    run = run_cell(cell, seed, seconds, 0, device, time.perf_counter(),
                   log=lambda *a: None, side=side,
                   warm_tiles=1 if side == 'program' else 0,
                   min_tiles=cell.check_tiles)
    res = result_of(run, 0, device)
    res['scene'] = run.scene
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--side', default='control')
    ap.add_argument('--seconds', type=float, default=0.5)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        res = reading(cell, seed, args.side, args.seconds, 'cuda')
        print(json.dumps({'workload': cell.name, 'side': args.side,
                          'seed': seed, 'correct': res['correct'],
                          'tiles': res['attempted'], 'scene': res['scene'],
                          'checks': res['checks']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
