"""The forced-plan sweep behind ``ops.change_scan_cuda._scan_plan``.

    python -m nd_tpu_torch.scan_sweep       # from the repository root

Runs the long-series scan kernel with every plan of
``change_scan_cuda.plan_candidates`` on ``chip_smoke.py``'s long stack
(1024 x 1024 x 56) and path-B stack (256 x 512 x 200), and on 256 x 512
stacks at k = 16, 100 and 256 (the same generator). Each plan's flags
and margins must be bit-equal to the plain version's (a failure raises);
its time is the median of 5 CUDA-event timings of one kernel call after
one warm-up. Prints one line per shape and plan, fastest first, with
the plan's shared memory and blocks per SM, then the chosen plan's time
and rank. Every line ends with the card's name and power limit. Without
a CUDA device it exits non-zero.
"""

import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .ops import change_scan_cuda as scan


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _key(plan):
    return (plan['threads'], plan['T'], plan['nbuf'])


def main():
    if not torch.cuda.is_available():
        print('scan_sweep: needs a CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    shapes = [(cs.NY, cs.NX, cs.KL, cs.SEED + 3), (cs.BNY, cs.BNX, cs.BK,
                                                   cs.SEED + 2),
              (256, 512, 16, 7), (256, 512, 100, 8), (256, 512, 256, 9)]
    for ny, nx, k, seed in shapes:
        vals = torch.from_numpy(cs.make_cube(ny, nx, k, seed=seed,
                                             step=5.0, burst=True)).to(dev)
        tabs = scan.scan_tables(k, 9, 0.99)
        ref_p, ref_m = scan.scan_plain(vals, tabs, 9.0)
        chosen = scan._scan_plan(k, ny * nx)
        rows = []
        for plan in scan.plan_candidates(k, ny * nx):
            got_p, got_m = scan.scan_kernel(vals, tabs, 9.0, plan)
            torch.cuda.synchronize()
            same = bool((got_p == ref_p).all()) and bool(
                (got_m.view(torch.int32) == ref_m.view(torch.int32)).all())
            if not same:
                raise RuntimeError('plan %r at k=%d differs from the plain '
                                   'version' % (plan, k))
            rows.append((_ms(lambda: scan.scan_kernel(vals, tabs, 9.0, plan)),
                         plan))
        rows.sort(key=lambda r: r[0])
        label = '%dx%dx%d' % (ny, nx, k)
        for ms, plan in rows:
            print('%s threads %3d T %3d nbuf %2d smem %6d '
                  '(%d blocks/SM by smem): %.4f ms | %s'
                  % (label, plan['threads'], plan['T'], plan['nbuf'],
                     plan['smem'],
                     min(scan.SMEM_MAX // max(plan['smem'], 1),
                         2048 // plan['threads']), ms, card), flush=True)
        rank = [_key(p) for _, p in rows].index(_key(chosen))
        print('%s chosen plan %r: %.4f ms, rank %d of %d (best %.4f ms) | %s'
              % (label, _key(chosen), rows[rank][0], rank + 1, len(rows),
                 rows[0][0], card), flush=True)
        del vals, ref_p, ref_m
    return 0


if __name__ == '__main__':
    sys.exit(main())
