"""Where the long-stack paths spend their time on one CUDA device.

    python -m nd_tpu_torch.breakdown        # from the repository root

Builds ``chip_smoke.py``'s long stack (1024 x 1024 x 56 float32
covariance cube, a 5x step half-way, the bursty column) and its path-B
stack (k = 200 on 256 x 512), then prints one line per measurement:

  - path A: ``NLMeansFilter(dims=('y','x','time'), r=(2,2,1), f=1)``
    apply and ``OmnibusTest(ml=3, alpha=0.99)`` apply; inside the latter
    the multilook kernel, the scan kernel call and the float64 'mixed'
    rescan of the suspects (``change_mixed_cuda.rescan``: their selection
    on the card and the ``omnibus_mixed`` kernel);
  - path B: ``change_detection_exact`` at k = 200: the scan kernel call
    and the rescan of the suspects;
  - one ``torch.profiler`` window each around ``OmnibusTest.apply`` and
    both exact calls: wall ms, device-busy ms and share, the number of
    device events and the four device kernels with the most time.

Times are host-clock ms around synchronised calls, median of 3 after one
warm-up. Every line ends with the card's name and power limit. Without a
CUDA device it exits non-zero.
"""

import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from .change import MARGIN_EPS, OmnibusTest
from .core import Dataset
from .filters import BoxcarFilter, NLMeansFilter
from .ops import change_scan_cuda, conv_cuda
from .ops.change import change_detection_exact
from .ops.change_mixed_cuda import rescan
from .ops.conv import _separable_factors

NAMES = ('C11', 'C12__re', 'C12__im', 'C22')


def _host_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profiled(fn):
    """(wall ms, device-busy ms, device events, top kernels) of one call
    under torch.profiler, after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float('-inf')          # union of the device spans, us
    per_name = defaultdict(float)
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        per_name[name[:40]] += (e - s) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    return wall, busy / 1e3, len(spans), top


def main():
    if not torch.cuda.is_available():
        print('breakdown: needs a CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    def say(text):
        print('%s | %s' % (text, card), flush=True)

    def say_profile(label, fn):
        wall, busy, events, top = profiled(fn)
        say('%s: wall %.3f ms under the profiler, device busy %.3f ms '
            '(%.1f%%), %d device events; top %s'
            % (label, wall, busy, 100.0 * busy / wall, events,
               ', '.join('%s %.3f ms' % kv for kv in top)))

    dev = torch.device('cuda')
    stack = torch.from_numpy(cs.make_cube(cs.NY, cs.NX, cs.KL,
                                          seed=cs.SEED + 3, step=5.0,
                                          burst=True)).to(dev)
    bcube = torch.from_numpy(cs.make_cube(cs.BNY, cs.BNX, cs.BK,
                                          seed=cs.SEED + 2,
                                          burst=True)).to(dev)
    ds = Dataset({v: (('y', 'x', 'time'), stack[..., i])
                  for i, v in enumerate(NAMES)})
    nlm = NLMeansFilter(dims=('y', 'x', 'time'), r=(2, 2, 1), f=1, sigma=2,
                        h=3)
    omn = OmnibusTest(ml=3, alpha=0.99)

    flt = nlm.apply(ds)
    say('A: NLMeansFilter.apply %.3f ms, OmnibusTest.apply %.3f ms'
        % (_host_ms(lambda: nlm.apply(ds)), _host_ms(lambda: omn.apply(flt))))
    x4 = torch.stack([flt[v].data for v in NAMES])           # (4, y, x, t)
    box = _separable_factors(np.ones((3, 3)) / 9)
    say('A: multilook sepconv2 kernel alone %.3f ms'
        % _host_ms(lambda: conv_cuda.sepconv2(x4, *box)))
    looked = BoxcarFilter(w=3).apply(flt)
    looked = torch.stack([looked[v].data for v in NAMES], -1).contiguous()
    del x4

    for label, vals in (('A (k=%d, %dx%d)' % (cs.KL, cs.NY, cs.NX), looked),
                        ('B (k=%d, %dx%d)' % (cs.BK, cs.BNY, cs.BNX), bcube)):
        packed, margin = change_scan_cuda.change_detection_scan(
            vals, 0.99, n=9, return_packed=True)
        count = int((~(margin > MARGIN_EPS)).sum())
        exact_ms = _host_ms(lambda: change_detection_exact(
            vals, 0.99, n=9, margin_eps=MARGIN_EPS))
        scan_ms = _host_ms(lambda: change_scan_cuda.change_detection_scan(
            vals, 0.99, n=9, return_packed=True))
        rows = vals.reshape(-1, vals.shape[2], 4)
        rescan_ms = _host_ms(lambda: rescan(rows, margin, packed, 0.99, 9,
                                            MARGIN_EPS))
        say('%s: exact %.3f ms; scan kernel call %.3f ms; rescan of %d '
            'suspects %.3f ms' % (label, exact_ms, scan_ms, count,
                                  rescan_ms))
        say_profile(label + ' exact', lambda: change_detection_exact(
            vals, 0.99, n=9, margin_eps=MARGIN_EPS))
    say_profile('A OmnibusTest.apply', lambda: omn.apply(flt))
    return 0


if __name__ == '__main__':
    sys.exit(main())
