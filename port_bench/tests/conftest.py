"""Put the benchmark's folder and the checkout's root on ``sys.path``,
as ``run.py`` does, so that the tests import ``harness``,
``reference``, ``run`` and ``control`` and the program beside them."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)
