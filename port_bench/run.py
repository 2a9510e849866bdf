"""The benchmark of nd_tpu_torch: run one cell once.

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.
Prints diagnostics and, last, each compared number beside its limit on
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Without a card, with fewer cards than the cell asks for, or
with JAX or the JAX package loaded, it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from harness import guard  # noqa: E402
from harness.spec import load_cell, load_plugin  # noqa: E402


def _say(*args):
    print(*args, file=sys.stderr, flush=True)


def metrics_of(run, entries):
    """{name: {'value', 'unit'}} of the readers that found something."""
    out = {}
    for m in entries:
        value = load_plugin(run.cell.root, 'metrics', m['name']).read(run)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def result_of(run, trace, device):
    """The result line's object (``checks`` last)."""
    import torch
    cell = run.cell
    checks = {name: {'value': value, 'limit': cell.limits.get(name)}
              for name, value in sorted(run.checks.items())}
    correct = bool(checks) and run.failed == 0 and all(
        c['limit'] is not None and c['value'] <= c['limit']
        for c in checks.values())
    dev = {'platform': 'gpu' if device == 'cuda' else device,
           'kind': (torch.cuda.get_device_name(0) if device == 'cuda'
                    else device),
           'count': cell.chips, 'memory_peak_bytes': run.peak_bytes}
    res = {'correct': correct, 'attempted': len(run.tiles),
           'failed': run.failed,
           'metrics': metrics_of(run, cell.per_layer if trace
                                 else cell.end_to_end),
           'device': dev}
    if trace:
        dev['busy_s'] = run.trace['busy_s']
        dev['window_s'] = run.trace['window_s']
        res['breakdown'] = {'device_ops': run.trace['device_ops'],
                            'idle_gaps': run.trace['idle_gaps']}
    res['checks'] = checks
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)

    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _say('no result: the cell needs %d CUDA device(s), found %d'
             % (cell.chips, torch.cuda.device_count()
                if torch.cuda.is_available() else 0))
        return 2
    from harness.runner import run_cell
    torch.cuda.init()
    marks = [('import_torch', t_torch), ('cuda_init', time.perf_counter())]
    run = run_cell(cell, args.seed, args.seconds, args.trace, 'cuda',
                   T_START, marks=marks)
    res = result_of(run, args.trace, 'cuda')
    bad = guard.forbidden()        # after the window and the check
    if bad:
        _say('no result: loaded, and must not be: %s' % ', '.join(bad))
        return 2
    _say('setup %s' % ' '.join('%s %.3f' % kv
                                for kv in run.setup_parts.items()))
    for name, value in sorted(run.scene.items()):
        _say('scene %s %r' % (name, value))
    for name, c in res['checks'].items():
        _say('check %s %r limit %r' % (name, c['value'], c['limit']))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
