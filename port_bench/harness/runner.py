"""One run of one cell: set-up, the measured window, the traced window,
the check of the sampled outputs, the metrics.

Closed loop, one tile in flight: each tile of the window goes through
the traffic's stages of the configuration's chain, the program's
``.apply`` calls, and ends in a ``torch.cuda.synchronize()``; the tiles
cycle through the pool that the traffic's generator
(``generators/<name>.py``) makes on the card in set-up. The outputs stay
on the card. A reservoir drawn from the seed keeps ``check_tiles``
tiles' outputs, a uniform sample of the window's tiles, for the check
after the window.

``side`` puts another implementation in the program's place, stage by
stage: a stage module's ``CONTROLS`` maps a side's name to a factory of
objects with the program's ``apply`` (a stage without that side runs
the program). The controls are judged by the same check as the
program.
"""

from __future__ import annotations

import os
import random
import sys
import tempfile
import time
from dataclasses import dataclass, field

from .spec import BENCH_DIR, load_json, load_plugin
from .trace import STAGE, TILE, summarize

__all__ = ['Tile', 'Run', 'run_cell', 'make_scene', 'WARM_TILES',
           'TRACE_TILES', 'TRACE_SECONDS']

WARM_TILES = 2          # tiles through the chain in set-up
TRACE_TILES = 200       # the traced window: at most this many tiles
TRACE_SECONDS = 5.0     # ... or about this many seconds


@dataclass
class Tile:
    start: float        # host clock, s: the first call
    end: float          # after the synchronize
    host: list          # seconds each stage's .apply took to return


@dataclass
class Run:
    cell: object
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    tiles: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: dict = None
    stage_bound_s: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    failed: int = 0
    reference_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)
    scene: dict = field(default_factory=dict)


def make_scene(cell, seed, index, device):
    """Tile ``index`` of run ``seed``, from the traffic's generator."""
    gen = load_plugin(cell.root, 'generators', cell.traffic['generator'])
    return gen.make(cell.config, cell.traffic, seed, index, device)


def _implementations(cell, side):
    """The objects whose ``apply`` each stage of ``cell`` calls."""
    out = []
    for kind, params in cell.stages:
        mod = load_plugin(cell.root, 'stages', kind)
        factory = getattr(mod, 'CONTROLS', {}).get(side)
        out.append(mod.make(params) if side == 'program' or factory is None
                   else factory(params, tuple(cell.config['dims'])))
    return out


def _sync(device):
    import torch
    if str(device).startswith('cuda'):
        torch.cuda.synchronize()


def _bound_s(work, peaks):
    """The least time the device could take for ``work``."""
    t_bytes = work['bytes'] / peaks['hbm_bytes_per_s']
    t_ops = (work['f32_ops'] / peaks['f32_ops_per_s']
             + work['f64_ops'] / peaks['f64_ops_per_s'])
    return max(t_bytes, t_ops)


def _chain(programs, ds):
    outs = []
    host = []
    x = ds
    for prog in programs:
        a = time.perf_counter()
        x = prog.apply(x)
        host.append(time.perf_counter() - a)
        outs.append(x)
    return outs, host


def _traced_window(cell, stages, programs, datasets, first, device):
    """Profile up to TRACE_TILES tiles or TRACE_SECONDS, each stage in a
    range of its own that ends in a synchronize; returns the trace's
    summary and the tiles' outputs by pool index (first of each), kept
    only for the stages whose roofline reads them (``READS_OUTPUT``):
    an output held past its tile takes memory the next tile's call
    would reuse, and the allocator's growth shows as idle time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if str(device).startswith('cuda'):
        acts.append(ProfilerActivity.CUDA)
    keep = [getattr(load_plugin(cell.root, 'roofline', kind),
                    'READS_OUTPUT', True) for kind, _ in stages]
    first_out = {}
    counts = {}
    with tempfile.TemporaryDirectory(prefix='port_bench_trace_') as tmp:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            j = 0
            while j < TRACE_TILES and time.perf_counter() - t0 < TRACE_SECONDS:
                p = (first + j) % len(datasets)
                outs = []
                with record_function(TILE):
                    x = datasets[p]
                    for (kind, _), prog, k in zip(stages, programs, keep):
                        with record_function(STAGE + kind):
                            x = prog.apply(x)
                            _sync(device)
                        outs.append(x if k else None)
                first_out.setdefault(p, outs)
                counts[p] = counts.get(p, 0) + 1
                j += 1
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        del prof
        summary = summarize(path)
    return summary, first_out, counts


def _stage_bounds(cell, stages, first_out, counts, peaks):
    """{stage: the least device time of its traced calls}."""
    bounds = {}
    for s, (kind, params) in enumerate(stages):
        roof = load_plugin(cell.root, 'roofline', kind)
        mod = load_plugin(cell.root, 'stages', kind)
        total = 0.0
        for p, outs in first_out.items():
            got = None if outs[s] is None else mod.outputs(outs[s])
            work = roof.work(cell.tile_shape, len(cell.config['variables']),
                             params, cell.config['dims'], got)
            total += counts[p] * _bound_s(work, peaks)
        bounds[kind] = total
    return bounds


def _check(run, stages, pool, samples):
    """Judge each sampled tile stage by stage: a stage's check takes the
    input the program's stage was given (the benchmark's tile, or the
    program's output of the stage before) and the stage's output. A
    stage's ``describe``, where it has one, reads what the outputs say
    of the scene (into ``run.scene``: the samples' mean, or the most of
    a name ending in ``_max``)."""
    cell = run.cell
    worst = {}
    seen = {}
    failed = 0
    for p, outs in samples:
        inputs = pool[p].inputs
        bad = False
        for s, (kind, params) in enumerate(stages):
            mod = load_plugin(cell.root, 'stages', kind)
            got = mod.outputs(outs[s])
            if hasattr(mod, 'describe'):
                for name, value in mod.describe(got).items():
                    seen.setdefault(name, []).append(value)
            for name, value in mod.check(inputs, got, params,
                                         cell.config['dims']).items():
                prev = worst.get(name)
                if prev is None or not value <= prev:
                    worst[name] = value
                limit = cell.limits.get(name)
                bad |= limit is None or not value <= limit
            inputs = got
        failed += bad
    run.scene = {name: max(v) if name.endswith('_max') else sum(v) / len(v)
                 for name, v in seen.items()}
    return worst, failed


def run_cell(cell, seed, seconds, trace, device, t_start, log=None,
             side='program', warm_tiles=WARM_TILES, min_tiles=1, marks=()):
    """Run ``cell`` once; returns the Run. ``t_start`` is the process's
    start on the host clock (``time.perf_counter``): set-up runs from it
    to the window's start, in the parts that ``marks`` (the caller's
    (name, end) pairs) and this function's own steps end. The window
    lasts ``seconds`` and at least ``min_tiles`` tiles."""
    import torch
    if log is None:
        def log(*a):
            print(*a, file=sys.stderr, flush=True)
    if int(cell.traffic.get('in_flight', 1)) != 1:
        raise ValueError('the harness runs one tile in flight')
    run = Run(cell=cell, seed=int(seed))
    cfg = cell.config
    stages = cell.stages
    marks = list(marks) + [('harness', time.perf_counter())]
    programs = _implementations(cell, side)
    marks.append(('stages', time.perf_counter()))
    pool = [make_scene(cell, seed, p, device)
            for p in range(int(cfg['pool_tiles']))]
    datasets = [s.dataset for s in pool]
    _sync(device)
    marks.append(('pool', time.perf_counter()))
    for p in range(min(warm_tiles, len(datasets))):
        _chain(programs, datasets[p])
        _sync(device)

    rng = random.Random(int(seed))
    samples = []
    t_window = time.perf_counter()
    run.setup_s = t_window - t_start
    t = t_start
    for name, at in marks + [('warm_up', t_window)]:
        run.setup_parts[name] = at - t
        t = at
    i = 0
    while i < min_tiles or time.perf_counter() - t_window < seconds:
        p = i % len(datasets)
        t0 = time.perf_counter()
        outs, host = _chain(programs, datasets[p])
        _sync(device)
        t1 = time.perf_counter()
        run.tiles.append(Tile(t0, t1, host))
        if len(samples) < cell.check_tiles:
            samples.append((p, outs))
        else:
            slot = rng.randrange(i + 1)
            if slot < cell.check_tiles:
                samples[slot] = (p, outs)
        i += 1
    run.window_s = run.tiles[-1].end - t_window
    del outs
    if str(device).startswith('cuda'):
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    log('tiles %d window_s %.6f' % (len(run.tiles), run.window_s))

    if trace:
        peaks = load_json(cell.root / BENCH_DIR / 'roofline' / 'peaks.json')
        run.trace, first_out, counts = _traced_window(
            cell, stages, programs, datasets, i, device)
        run.stage_bound_s = _stage_bounds(cell, stages, first_out, counts,
                                          peaks)
        del first_out
    del programs, datasets

    t0 = time.perf_counter()
    run.checks, run.failed = _check(run, stages, pool, samples)
    run.reference_s = time.perf_counter() - t0
    log('reference_s %.3f' % run.reference_s)
    return run
