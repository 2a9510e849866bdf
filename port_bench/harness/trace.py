"""Reading a ``torch.profiler`` Chrome trace of the traced window.

The benchmark marks each tile with the range ``TILE`` and each stage
call with ``STAGE + kind`` (``record_function``), and synchronizes at
the end of each stage's range, so the device work a stage launched ends
inside its range. From the trace it takes:

- the window: the first tile range's start to the last one's end;
- device busy time: the union of kernel, copy and memset intervals,
  inside the window and inside each stage's ranges;
- the kernels launched (events of category ``kernel``);
- the device operations that took most time, by name (each name
  shortened for the record, the sums taken by the whole name);
- the device's idle gaps, each named by the innermost host event that
  was running at its middle on the thread that ran the tiles.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

__all__ = ['TILE', 'STAGE', 'summarize', 'merge', 'covered']

TILE = 'port_bench.tile'
STAGE = 'port_bench.stage.'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver')
TOP = 10
NAME_CHARS = 160


def short(name):
    """A device operation's name without the C++ noise that every kernel
    of a library repeats, cut to NAME_CHARS characters."""
    for noise in ('(anonymous namespace)::', 'at::native::', 'void '):
        name = name.replace(noise, '')
    return name if len(name) <= NAME_CHARS \
        else name[:NAME_CHARS - 3] + '...'


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(union, lo, hi, starts=None):
    """Length of [lo, hi] that the disjoint sorted ``union`` covers
    (``starts``: its intervals' starts, where the caller has them)."""
    if starts is None:
        starts = [u[0] for u in union]
    total = 0.0
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    while i < len(union) and union[i][0] < hi:
        s, e = union[i]
        a, b = max(s, lo), min(e, hi)
        if b > a:
            total += b - a
        i += 1
    return total


def _innermost(host, points):
    """For each sorted point, the name of the innermost host event that
    contains it (events of one thread nest), or 'no host event'."""
    events = sorted(host, key=lambda e: (e[0], -e[1]))
    names = []
    stack = []
    i = 0
    for p in points:
        while i < len(events) and events[i][0] <= p:
            s, e, name = events[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else 'no host event')
    return names


def summarize(path):
    """Summary of the trace at ``path`` (times in seconds)."""
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    spans = [e for e in events if e.get('ph') == 'X']
    tiles = [e for e in spans if e.get('name') == TILE
             and e.get('cat') == 'user_annotation']
    if not tiles:
        raise RuntimeError('no %s range in the trace' % TILE)
    t0 = min(e['ts'] for e in tiles)
    t1 = max(e['ts'] + e['dur'] for e in tiles)
    thread = (tiles[0].get('pid'), tiles[0].get('tid'))

    device = [(float(e['ts']), float(e['ts']) + float(e.get('dur', 0)),
               e['name'], e['cat']) for e in spans
              if e.get('cat') in DEVICE_CATS
              and e['ts'] >= t0 and e['ts'] + e.get('dur', 0) <= t1]
    union = merge([(s, e) for s, e, _, _ in device])
    starts = [u[0] for u in union]
    busy = covered(union, t0, t1, starts)

    stage_busy = defaultdict(float)
    for e in spans:
        name = e.get('name', '')
        if e.get('cat') == 'user_annotation' and name.startswith(STAGE):
            kind = name[len(STAGE):]
            stage_busy[kind] += covered(union, e['ts'], e['ts'] + e['dur'],
                                         starts)

    by_name = defaultdict(float)
    for s, e, name, _ in device:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps = []
    last = t0
    for s, e in union:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    host = [(float(e['ts']), float(e['ts']) + float(e['dur']), e['name'])
            for e in spans if e.get('cat') in HOST_CATS
            and (e.get('pid'), e.get('tid')) == thread]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    gap_by = defaultdict(float)
    names = _innermost(host, [m for m, _ in mids])
    for (_, length), name in zip(mids, names):
        gap_by[name] += length
    idle = sorted(gap_by.items(), key=lambda kv: -kv[1])[:TOP]

    us = 1e-6
    return {
        'tiles': len(tiles),
        'window_s': (t1 - t0) * us,
        'busy_s': busy * us,
        'kernels': sum(1 for d in device if d[3] == 'kernel'),
        'stage_busy_s': {k: v * us for k, v in stage_busy.items()},
        'device_ops': [[short(n), v * us] for n, v in ops],
        'idle_gaps': [[n, v * us] for n, v in idle],
    }
