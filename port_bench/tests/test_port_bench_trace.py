"""The arithmetic of the metrics: rate, tail, idle share, rooflines and
kernel counts, on synthetic tiles and a synthetic Chrome trace."""

import json
import statistics

import pytest

from harness.runner import Run, Tile, _bound_s
from harness.spec import load_plugin
from harness.trace import STAGE, TILE, covered, merge, summarize
from helpers import ROOT, small_cell


def read(name, run):
    return load_plugin(ROOT, 'metrics', name).read(run)


def _run(times):
    cell = small_cell('s1_k12.readme_chain', y=100, x=100)   # 120,000 px
    run = Run(cell=cell, seed=1)
    t = 10.0
    for dt in times:
        run.tiles.append(Tile(t, t + dt, [0.001, 0.002]))
        t += dt
    run.window_s = t - 10.0 + 0.5        # the window started 0.5 s early
    run.setup_s = 3.25
    run.peak_bytes = 3 * 2 ** 30
    return run


def test_rate_tail_memory_host_time():
    times = [0.05 + 0.001 * (i % 10) for i in range(200)]
    run = _run(times)
    assert read('cube_mpix_s', run) == pytest.approx(
        200 * 0.12 / (sum(times) + 0.5))
    want = statistics.quantiles([1e3 * t for t in times], n=20,
                                method='inclusive')[18]
    assert read('tile_p95_ms', run) == pytest.approx(want)
    assert want == pytest.approx(59.0)
    assert read('peak_mem_gib', run) == pytest.approx(3.0)
    assert read('setup_s', run) == 3.25
    assert read('host_ms_per_tile', run) == pytest.approx(3.0)
    assert read('tile_p95_ms', _run(times[:10])) is None


def _ev(name, cat, ts, dur, tid=1, pid=1):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'pid': pid, 'tid': tid}


def _trace(tmp_path):
    ev = [_ev(TILE, 'user_annotation', 0, 1000),
          _ev(STAGE + 'nlmeans', 'user_annotation', 0, 600),
          _ev(STAGE + 'omnibus', 'user_annotation', 600, 400),
          _ev('aten::stack', 'cpu_op', 0, 100),
          _ev('cudaDeviceSynchronize', 'cuda_runtime', 550, 50),
          _ev('aten::copy_', 'cpu_op', 600, 150),
          _ev('k_nl', 'kernel', 100, 400, tid=7, pid=0),
          _ev('k_nl', 'kernel', 450, 100, tid=7, pid=0),   # overlaps
          _ev('k_om', 'kernel', 750, 200, tid=7, pid=0),
          _ev('Memset', 'gpu_memset', 960, 20, tid=7, pid=0),
          _ev(TILE, 'user_annotation', 1000, 500),
          _ev(STAGE + 'omnibus', 'user_annotation', 1000, 500),
          _ev('k_om', 'kernel', 1100, 350, tid=7, pid=0),
          _ev('k_late', 'kernel', 1600, 50, tid=7, pid=0)]   # outside
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': ev}))
    return summarize(str(path))


def test_trace_summary(tmp_path):
    s = _trace(tmp_path)
    assert s['tiles'] == 2 and s['kernels'] == 4
    assert s['window_s'] == pytest.approx(1500e-6)
    busy = 450 + 200 + 20 + 350
    assert s['busy_s'] == pytest.approx(busy * 1e-6)
    assert s['stage_busy_s']['nlmeans'] == pytest.approx(450e-6)
    assert s['stage_busy_s']['omnibus'] == pytest.approx(570e-6)
    assert s['device_ops'][0] == ['k_om', pytest.approx(550e-6)]
    gaps = dict(s['idle_gaps'])
    assert gaps['aten::stack'] == pytest.approx(100e-6)    # 0-100
    assert gaps['aten::copy_'] == pytest.approx(200e-6)    # 550-750
    assert gaps[STAGE + 'omnibus'] == pytest.approx(180e-6)
    assert sum(gaps.values()) == pytest.approx((1500 - busy) * 1e-6)


def test_per_layer_readers(tmp_path):
    run = _run([0.05] * 4)
    run.trace = _trace(tmp_path)
    run.stage_bound_s = {'nlmeans': 45e-6, 'omnibus': 57e-6}
    assert read('device_idle_pct', run) == pytest.approx(
        100 * (1 - 1020 / 1500))
    assert read('kernels_per_tile', run) == 2.0
    assert read('nlmeans_roofline_pct', run) == pytest.approx(10.0)
    assert read('omnibus_roofline_pct', run) == pytest.approx(10.0)
    run.trace = None
    for name in ('device_idle_pct', 'kernels_per_tile',
                 'nlmeans_roofline_pct', 'omnibus_roofline_pct'):
        assert read(name, run) is None


def test_interval_helpers_and_bound():
    u = merge([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert u == [[0, 3], [5, 9]]
    assert covered(u, 2, 6) == 2
    peaks = {'hbm_bytes_per_s': 1e3, 'f32_ops_per_s': 1e4,
             'f64_ops_per_s': 5e3}
    assert _bound_s({'bytes': 2e3, 'f32_ops': 1e4, 'f64_ops': 0},
                    peaks) == 2.0
    assert _bound_s({'bytes': 0, 'f32_ops': 1e4, 'f64_ops': 1e4},
                    peaks) == 3.0
