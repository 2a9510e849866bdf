"""Host cost of one ``nd_tpu_torch.tracing`` span and count.

    python3 tools/span_cost.py            # from the repository root

Prints, in microseconds a call (the best of 5 rounds of N calls): an
empty ``with span(...)`` and a ``count(...)`` with no profiler running;
then, where a CUDA device is available (its context made first), the
same under a ``torch.profiler`` recording of CPU and CUDA activity,
where a span also opens a ``record_function`` range and records two
timing events, and ``report()``'s resolution of the pending event pairs.
The card's name and power limit end the line where ``nvidia-smi`` runs.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from nd_tpu_torch import tracing  # noqa: E402

N = 20000


def per_call_us(fn, n=N, rounds=5):
    best = float('inf')
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn(n)
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    return best


def spans(n):
    for _ in range(n):
        with tracing.span('span_cost'):
            pass


def counts(n):
    one = torch.ones(1, dtype=torch.int32, device='cuda'
                     if torch.cuda.is_available() else 'cpu')
    for _ in range(n):
        tracing.count('span_cost', one)


def card():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'no nvidia-smi'


def main():
    line = ['torch %s' % torch.__version__]
    if torch.cuda.is_available():
        torch.ones(1, device='cuda').add_(1)     # a context and a stream
        torch.cuda.synchronize()
    line.append('off: span %.3f us, count %.3f us'
                % (per_call_us(spans), per_call_us(counts)))
    tracing.reset()
    if torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            on_span = per_call_us(spans, n=2000)
            on_count = per_call_us(counts, n=2000)
        pairs = len(tracing._PENDING) // 3
        t0 = time.perf_counter()
        device = tracing.report()['span_cost']['device']
        resolve = (time.perf_counter() - t0) / pairs * 1e6
        line.append('on: span %.3f us, count %.3f us, report %.3f us a '
                    'pair (%d pairs, %.6f s of device time)'
                    % (on_span, on_count, resolve, pairs, device))
    tracing.reset()
    print(' | '.join(line + [card()]), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
