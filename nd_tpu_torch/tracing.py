"""Tracing and profiling: a host span tracer and a device trace.

Counterpart of ``nd_tpu/tracing.py``. :func:`span` / :func:`trace`
aggregate wall-clock spans (count, total and max seconds) in a report
that can be dumped as JSON; every ``Algorithm.apply`` records one
(``algorithm.parallelize``). The device trace is ``torch.profiler``:
:func:`start_device_trace` records host operations and, where CUDA is
available, the card's kernels, and :func:`stop_device_trace` writes a
Chrome trace (``*.pt.trace.json``, Perfetto or TensorBoard) into the
log directory. :func:`annotate` names a range in that trace and, on a
CUDA build with a card, an NVTX range that ``nsys`` shows.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
import time
from collections import defaultdict

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

__all__ = ['trace', 'span', 'report', 'reset', 'start_device_trace',
           'stop_device_trace', 'annotate']

_LOCK = threading.Lock()
_SPANS = defaultdict(lambda: {'count': 0, 'total': 0.0, 'max': 0.0})
_PROFILER = None


@contextlib.contextmanager
def span(name):
    """Time a host-side span; aggregated in the global report."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            s = _SPANS[name]
            s['count'] += 1
            s['total'] += dt
            s['max'] = max(s['max'], dt)


def trace(name=None):
    """Decorator form of :func:`span`, bare (``@trace``, labelled with the
    function's qualified name) or parametrised (``@trace('x')``)."""
    def deco(fn):
        label = (name if isinstance(name, str) and name
                 else fn.__qualname__)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)
        return wrapper

    if callable(name):          # bare @trace
        return deco(name)
    return deco


def report(as_json=False):
    """Aggregated span timings: name -> {'count', 'total', 'max'}."""
    with _LOCK:
        data = {k: dict(v) for k, v in _SPANS.items()}
    if as_json:
        return json.dumps(data, indent=2, sort_keys=True)
    return data


def reset():
    with _LOCK:
        _SPANS.clear()


def start_device_trace(logdir):
    """Start a ``torch.profiler`` trace (CPU activity, plus CUDA where a
    card is available) that :func:`stop_device_trace` writes into
    ``logdir``. One trace runs at a time: a second start raises."""
    global _PROFILER
    with _LOCK:
        if _PROFILER is not None:
            raise RuntimeError('a device trace is already running; call '
                               'stop_device_trace() first')
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(str(logdir)))
        prof.start()
        _PROFILER = prof


def stop_device_trace():
    """Stop the running trace and write its Chrome trace into the log
    directory given to :func:`start_device_trace`."""
    global _PROFILER
    with _LOCK:
        prof, _PROFILER = _PROFILER, None
    if prof is None:
        raise RuntimeError('no device trace is running')
    prof.stop()


@contextlib.contextmanager
def annotate(name):
    """Name a range in the device trace (``record_function``) and, where
    CUDA is available, an NVTX range."""
    with contextlib.ExitStack() as stack:
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(record_function(name))
        yield
