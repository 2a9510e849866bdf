"""Host (C++) components of nd_tpu_torch: the JPEG 2000 Tier-1 decoder
and the CPU oracles.

``jp2_t1.cpp`` is built with the host compiler (``g++ -O3 -fopenmp
-shared -fPIC -std=c++17``) at first use into ``nd_tpu_torch/.build/``
(listed in ``.gitignore``), under a name that carries the hash of the
source, the compiler and the flags, and bound with :mod:`ctypes`. The
build writes a temporary file and renames it into place, so processes
that build at once never load half a library. A missing compiler, a
failed build or a failed load raises: nothing falls back to the Python
decoder.

``nlmeans.cpp`` and ``change.cpp`` are the JAX package's host C++
NLMeans and omnibus change detection (``nd_tpu/_native``), built the
same way into a second library with that package's flags
(:data:`ORACLE_FLAGS`: ``-march=native`` lets the compiler contract
``a*b+c`` into an FMA, so the flags are part of the numerics; the CPU's
model and flags go into the library's hash). They are oracles and the
single-core CPU yardstick (:func:`nlmeans_native`,
:func:`change_detection_native`): nothing on a path of the port calls
them, and no kernel or route falls back to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

__all__ = ['library', 'build_info', 'jp2_t1_decode_batch', 'CXX',
           'CXX_FLAGS', 'ORACLE_FLAGS', 'oracles', 'oracle_info',
           'available', 'nlmeans_native', 'change_detection_native']

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / 'jp2_t1.cpp'
_ORACLE_SRCS = (_HERE / 'nlmeans.cpp', _HERE / 'change.cpp')
_BUILD_DIR = Path(__file__).resolve().parents[1] / '.build'
CXX = 'g++'
CXX_FLAGS = ('-O3', '-fopenmp', '-shared', '-fPIC', '-std=c++17')
ORACLE_FLAGS = ('-O3', '-march=native', '-fopenmp', '-shared', '-fPIC',
                '-std=c++17')
_T1_ORIENT = {'LL': 0, 'HL': 1, 'LH': 2, 'HH': 3}

_lock = threading.Lock()
_lib = None
_info = {}
_oracles = None
_oracle_info = {}


def _build(cxx, target, flags, srcs):
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, prefix=target.stem + '.',
                               suffix='.tmp')
    os.close(fd)
    try:
        cmd = [cxx, *flags, '-o', tmp] + [str(s) for s in srcs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('host build of %s failed (exit %d):\n%s\n%s'
                               % (' '.join(s.name for s in srcs),
                                  proc.returncode, ' '.join(cmd),
                                  (proc.stdout + proc.stderr)[-4000:]))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _cpu_identity():
    """The host CPU's model name and flags (``-march=native`` builds for
    them), from ``/proc/cpuinfo``."""
    try:
        with open('/proc/cpuinfo') as fh:
            lines = [ln for ln in fh if ln.startswith(('model name',
                                                       'flags'))]
    except OSError:
        return b''
    return ''.join(sorted(set(lines))).encode()


def _load(stem, srcs, flags, what, info, extra=b''):
    """Build (if needed) and load ``srcs`` as ``.build/<stem>_<hash>.so``;
    fill ``info``. Call with ``_lock`` held."""
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError('%s not found: %s of nd_tpu_torch is built with '
                           'the host C++ compiler at first use' % (CXX, what))
    h = hashlib.sha256()
    for src in srcs:
        h.update(src.read_bytes())
    h.update(' '.join((CXX,) + tuple(flags)).encode())
    h.update(extra)
    target = _BUILD_DIR / ('%s_%s.so' % (stem, h.hexdigest()[:16]))
    t0 = time.perf_counter()
    built = not target.exists()
    if built:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _build(cxx, target, flags, srcs)
    lib = ctypes.CDLL(str(target))
    info.update(path=str(target), built=built, compiler=cxx,
                seconds=time.perf_counter() - t0)
    return lib


def library():
    """The loaded Tier-1 library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _load('libnd_jp2_t1', [_SRC], CXX_FLAGS,
                    'the JPEG 2000 Tier-1 decoder', _info)
        fn = lib.nd_jp2_t1_decode_batch
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int64, p, p, p, ctypes.c_int]
        _lib = lib
        return lib


def build_info():
    """Where the library came from: path, compiler, whether this process
    built it and the seconds the build (or load) took."""
    library()
    return dict(_info)


def oracles():
    """The loaded oracle library (NLMeans, omnibus change detection),
    built first if needed."""
    global _oracles
    with _lock:
        if _oracles is not None:
            return _oracles
        lib = _load('libnd_oracles', _ORACLE_SRCS, ORACLE_FLAGS,
                    'the host C++ oracles', _oracle_info, _cpu_identity())
        i64, dbl, p = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
        for suffix in ('f32', 'f64'):
            fn = getattr(lib, 'nd_nlmeans_' + suffix)
            fn.restype = None
            fn.argtypes = [p, p] + [i64] * 10 + [dbl] * 3 + [ctypes.c_int]
            fc = getattr(lib, 'nd_change_' + suffix)
            fc.restype = None
            fc.argtypes = [p, p, i64, i64, i64, dbl, dbl, ctypes.c_int]
        _oracles = lib
        return lib


def oracle_info():
    """As :func:`build_info`, for the oracle library."""
    oracles()
    return dict(_oracle_info)


def available():
    """Whether the oracle library builds and loads here."""
    try:
        oracles()
        return True
    except (RuntimeError, OSError, AttributeError):
        return False


def nlmeans_native(arr, r, f, sigma, h, n_eff=-1.0, nthreads=1):
    """NLMeans over a 4-D (d0, d1, d2, var) numpy array on the host CPU:
    the oracle of ``ops.nlmeans`` (float32 and float64 keep their dtype;
    other dtypes run in float64). ``nthreads`` OpenMP threads over d0."""
    lib = oracles()
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float32:
        fn = lib.nd_nlmeans_f32
    else:
        arr = arr.astype(np.float64, copy=False)
        fn = lib.nd_nlmeans_f64
    out = np.empty_like(arr)
    d0, d1, d2, nv = arr.shape
    r = [int(v) for v in r]
    f = [int(v) for v in f]
    for i, dim in enumerate((d0, d1, d2)):
        if r[i] + f[i] >= dim:
            # beyond it the single-bounce reflect would read out of bounds
            raise ValueError(
                'r + f (%d) must be smaller than dim %d size (%d)'
                % (r[i] + f[i], i, dim))
    fn(arr.ctypes.data, out.ctypes.data, d0, d1, d2, nv, r[0], r[1], r[2],
       f[0], f[1], f[2], float(sigma), float(h), float(n_eff),
       int(nthreads))
    return out


def change_detection_native(values, alpha, n=1, nthreads=1):
    """Omnibus change detection over a (y, x, time, 4) numpy array on the
    host CPU (float64 arithmetic; float32 input read as float32): the
    oracle of the exact mode. Returns the (y, x, time) bool map."""
    lib = oracles()
    values = np.ascontiguousarray(values)
    if values.ndim != 4 or values.shape[-1] != 4:
        raise ValueError(
            'expected (y, x, time, 4) dual-pol covariance channels, '
            'got shape %r' % (values.shape,))
    if values.dtype == np.float32:
        fn = lib.nd_change_f32
    else:
        values = values.astype(np.float64, copy=False)
        fn = lib.nd_change_f64
    ny, nx, k, _ = values.shape
    out = np.zeros((ny, nx, k), dtype=np.uint8)
    fn(values.ctypes.data, out.ctypes.data, ny, nx, k, float(alpha),
       float(n), int(nthreads))
    return out.astype(bool)


def jp2_t1_decode_batch(blocks):
    """Tier-1 decode of code-blocks ``(buf, w, h, orientation, npasses,
    numbps)`` -> a list of ``(vals int64 (h, w), lastp int16 (h, w))`` in
    input order, bit-equal to ``io.jp2._T1Decoder``. The blocks are
    independent and fan out over an OpenMP thread per core."""
    lib = library()
    if not blocks:
        return []
    data = b''.join(b[0] for b in blocks)
    offs = np.zeros(len(blocks) + 1, np.int64)
    np.cumsum([len(b[0]) for b in blocks], out=offs[1:])
    meta = np.asarray(
        [(int(b[1]), int(b[2]), _T1_ORIENT[b[3]], int(b[4]), int(b[5]))
         for b in blocks], np.int64)
    out_offs = np.zeros(len(blocks) + 1, np.int64)
    np.cumsum([int(b[1]) * int(b[2]) for b in blocks], out=out_offs[1:])
    vals = np.zeros(int(out_offs[-1]), np.int64)
    lastp = np.zeros(int(out_offs[-1]), np.int16)
    buf = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    rc = lib.nd_jp2_t1_decode_batch(
        buf.ctypes.data, offs.ctypes.data, meta.ctypes.data, len(blocks),
        vals.ctypes.data, lastp.ctypes.data, out_offs.ctypes.data,
        os.cpu_count() or 1)
    if rc != 0:
        raise ValueError('more coding passes than bit-planes')
    out = []
    for i, b in enumerate(blocks):
        s = slice(int(out_offs[i]), int(out_offs[i + 1]))
        out.append((vals[s].reshape(int(b[2]), int(b[1])),
                    lastp[s].reshape(int(b[2]), int(b[1]))))
    return out
