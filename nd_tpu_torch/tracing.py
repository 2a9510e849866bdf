"""Tracing and profiling: one span tracer with counters, and a device
trace.

Counterpart of ``nd_tpu/tracing.py``. :func:`span` (and its decorator
form :func:`trace`) names a piece of the program's work. Every
``Algorithm.apply`` records one (``algorithm.parallelize``;
``OmnibusTest.apply`` opens its own), and the change chain records its
data model's copies (``data.*``) and its omnibus steps (``omnibus.*``).
A span is read three ways:

- host: :func:`report` gives each name's ``count``, ``total`` and
  ``max`` seconds on the host clock. ``total`` is host time: it includes
  enqueueing the card's work and not the work itself, since a CUDA call
  returns before the card finishes. It is always kept;
- trace: while a ``torch.profiler`` trace records (the caller's own
  ``profile()``, or :func:`start_device_trace`), a span is also a
  ``record_function`` range in that trace, on the trace's clock, beside
  the kernels launched inside it;
- device: while a trace records and CUDA is initialised, a span records
  a timing CUDA event on the current stream at its entry and at its
  exit, and :func:`report` adds ``device``: the card's seconds between
  the span's entry and its exit on that stream, summed over the span's
  calls (its kernels, and any wait of the stream for the host inside
  the span).

:func:`count` adds an ``int`` or a 1-element tensor to a named counter,
and :func:`counters` sums them; a tensor is held unread until then, so
counting waits for nothing. ``device`` and the counters exist only
while a trace records, so both cover the trace's window. With no trace
a span costs two clock reads, one check of the profiler's flag and the
host aggregate, and :func:`count` does nothing.

The device trace is ``torch.profiler``: :func:`start_device_trace`
records host operations and, where CUDA is available, the card's
kernels, and :func:`stop_device_trace` writes a Chrome trace
(``*.pt.trace.json``, Perfetto or TensorBoard) into the log directory.
:func:`annotate` names a range in that trace and, on a CUDA build with
a card, an NVTX range.
"""

from __future__ import annotations

import contextlib
import functools
import json
import threading
from collections import defaultdict
from time import perf_counter

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

__all__ = ['trace', 'span', 'report', 'reset', 'start_device_trace',
           'stop_device_trace', 'annotate', 'count', 'counters']

_LOCK = threading.Lock()
_SPANS = {}                     # name -> [count, total s, max s], host clock
_DEVICE = defaultdict(float)    # name -> device seconds of resolved pairs
_PENDING = []                   # name, entry event, exit event, name, ...
_STREAMS = {}                   # (device, raw stream) -> its Stream
_COUNTS = defaultdict(list)     # name -> ints and 1-element tensors
_PROFILER = None
_recording = torch._C._autograd._profiler_enabled


class span:
    """Time a span on the host clock, aggregated in :func:`report`; while
    a ``torch.profiler`` trace records, also a range in that trace and,
    where CUDA is initialised, a pair of timing events on the current
    stream (``device`` in :func:`report`). Use as ``with span(name):``."""

    __slots__ = ('name', '_t0', '_range', '_start', '_stream')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._range = None
        if _recording():
            self._open()
        self._t0 = perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = perf_counter() - self._t0
        if self._range is not None:
            self._close()
        _LOCK.acquire()         # not ``with``: a third of the span's cost
        try:
            s = _SPANS.get(self.name)
            if s is None:
                _SPANS[self.name] = [1, dt, dt]
            else:
                s[0] += 1
                s[1] += dt
                if dt > s[2]:
                    s[2] = dt
        finally:
            _LOCK.release()
        return False

    def _open(self):
        self._range = record_function(self.name)
        self._range.__enter__()
        self._start = None
        if torch.cuda.is_initialized():
            self._stream = _current_stream()
            self._start = _event()
            self._start.record(self._stream)

    def _close(self):
        if self._start is not None:
            end = _event()
            end.record(self._stream)
            with _LOCK:         # flat: no object kept a span (see _event)
                _PENDING.extend((self.name, self._start, end))
        self._range.__exit__(None, None, None)


def _current_stream():
    """The current CUDA stream, its ``Stream`` object kept by raw handle:
    ``torch.cuda.current_stream()`` builds a new one each call, which
    costs about as much as an event record."""
    dev = torch._C._cuda_getDevice()
    key = (dev, torch._C._cuda_getCurrentRawStream(dev))
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.current_stream(dev)
    return stream


def _event():
    """A timing event, of ``torch.cuda.Event``'s base type: the garbage
    collector tracks no object of it, where each ``torch.cuda.Event``
    kept until :func:`report` would bring the next full collection (a
    few hundred ms with torch loaded) forward into the trace."""
    return torch._C._CudaEventBase(enable_timing=True)


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


def _resolve():
    """Move the closed spans' event pairs into the device seconds
    (waiting for each exit event)."""
    with _LOCK:
        pending = _PENDING[:]
        del _PENDING[:]
    seconds = defaultdict(float)
    for i in range(0, len(pending), 3):
        name, start, end = pending[i:i + 3]
        end.synchronize()
        seconds[name] += start.elapsed_time(end) / 1e3
    with _LOCK:
        for name, s in seconds.items():
            _DEVICE[name] += s


def report(as_json=False):
    """Aggregated spans: name -> {'count', 'total', 'max'} (host seconds),
    plus 'device' (seconds) for a span that recorded device time."""
    _resolve()
    with _LOCK:
        data = {k: {'count': c, 'total': t, 'max': m}
                for k, (c, t, m) in _SPANS.items()}
        for k, s in _DEVICE.items():
            if k in data:
                data[k]['device'] = s
    if as_json:
        return json.dumps(data, indent=2, sort_keys=True)
    return data


def count(name, value):
    """Add ``value`` (an ``int`` or a 1-element tensor, held unread) to
    the counter ``name`` while a ``torch.profiler`` trace records;
    otherwise do nothing."""
    if _recording():
        with _LOCK:
            _COUNTS[name].append(value)


def counters():
    """Counter totals: name -> int (reads the tensors counted)."""
    with _LOCK:
        held = {k: list(v) for k, v in _COUNTS.items()}
    return {k: sum(int(v) for v in values) for k, values in held.items()}


def reset():
    """Clear the spans, their pending device times and the counters."""
    with _LOCK:
        _SPANS.clear()
        _DEVICE.clear()
        del _PENDING[:]
        _COUNTS.clear()


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
