"""No JAX and no JAX package in a run: the guard compares top-level
names whole, and a run's imports load neither."""

import os
import subprocess
import sys

from harness import guard
from helpers import ROOT


def test_top_level_names_compared_whole():
    names = ['nd_tpu_torch', 'nd_tpu_torch.ops', 'nd_tpux', 'jax_foo',
             'jaxlib.xla', 'nd_tpu', 'nd_tpu.ops.change', 'flax', 'numpy']
    assert guard.forbidden(names) == ['flax', 'jaxlib.xla', 'nd_tpu',
                                      'nd_tpu.ops.change']


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A small run of every cell's stages on the CPU, in a process of
    its own, then the guard over its sys.modules."""
    code = '''
import sys, time
sys.path[:0] = [%r, %r]
from harness import guard
from harness.runner import run_cell
sys.path.insert(0, %r)
from helpers import CELLS, small_cell
for name in CELLS:
    run_cell(small_cell(name), 5, 0.2, 1, 'cpu', time.perf_counter(),
             log=lambda *a: None)
bad = guard.forbidden()
print(bad)
sys.exit(1 if bad else 0)
''' % (os.path.join(ROOT, 'port_bench'), ROOT,
       os.path.join(ROOT, 'port_bench', 'tests'))
    proc = subprocess.run([sys.executable, '-c', code], cwd='/',
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
