"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) and the objects are linked into ONE shared library
with a plain C interface, loaded with :mod:`ctypes`. The library is
built at first use into ``nd_tpu_torch/.build/`` (listed in
``.gitignore``) and rebuilt whenever a source, a shared header
(``csrc/*.cuh``) or a flag changes: its file name carries a hash of
all of them. A failed build or load raises.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``, no
``--use_fast_math`` and ``-fmad=false``: multiply-adds are not
contracted, so each kernel rounds its products and sums separately, as
its plain PyTorch version does. The omnibus kernel's margin error bound
was calibrated on such separately rounded arithmetic.

``ND_TPU_TORCH_NVCC`` names the compiler; otherwise ``nvcc`` on
``PATH``, then ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``.

Threads: ``njobs`` chunks call the wrappers from a thread pool. The
build holds ``_lock`` from the check for the library to its load, so it
runs once per process; the wrappers' launch counters and their
check-then-set caches take ``state_lock`` (:func:`bump`).
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

__all__ = ['library', 'function', 'check', 'build_info', 'bump',
           'state_lock', 'NVCC_FLAGS']

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / 'csrc'
_BUILD_DIR = _PKG / '.build'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xptxas', '-v', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_lib = None
_info = {}
# the wrappers' launch counters and check-then-set caches, shared by the
# threads of an njobs pool
state_lock = threading.Lock()


def bump(counters, name):
    """``counters[name] += 1`` under ``state_lock``: a wrapper passes its
    module's ``globals()`` and its counter's name."""
    with state_lock:
        counters[name] += 1


def _nvcc():
    explicit = os.environ.get('ND_TPU_TORCH_NVCC')
    if explicit:
        return explicit
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found: the CUDA kernels of nd_tpu_torch '
                       'are built with nvcc at first use (set '
                       'ND_TPU_TORCH_NVCC or put nvcc on PATH)')


def _sources():
    srcs = sorted(_CSRC.glob('*.cu'))
    if not srcs:
        raise RuntimeError('no CUDA sources under %s' % _CSRC)
    return srcs


def _digest(srcs):
    h = hashlib.sha256()
    for s in srcs + sorted(_CSRC.glob('*.cuh')):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile_and_link(srcs, target):
    """One nvcc per source, all started together, then one link; the
    objects and the unlinked library live in a scratch directory under
    ``.build/`` that goes away whether the build succeeds or fails.
    Returns nvcc's output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as work:
        work = Path(work)
        objs = [work / (s.stem + '.o') for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, '-c', '-o', str(o), str(s)]
                for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, out in zip(cmds, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed (exit %d):\n%s\n%s'
                                   % (proc.returncode, ' '.join(cmd), out))
        tmp = work / target.name
        link = [nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
                *[str(o) for o in objs]]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('nvcc link failed (exit %d):\n%s\n%s'
                               % (proc.returncode, ' '.join(link),
                                  proc.stdout + proc.stderr))
        os.replace(tmp, target)
    return ''.join(outs)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        target = _BUILD_DIR / ('libnd_tpu_torch_%s.so' % _digest(srcs))
        t0 = time.perf_counter()
        log = ''
        built = False
        if not target.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            log = _compile_and_link(srcs, target)
            built = True
        _lib = ctypes.CDLL(str(target))
        _info.update(path=str(target), built=built, log=log,
                     seconds=time.perf_counter() - t0,
                     sources=[s.name for s in srcs])
        return _lib


def build_info():
    """Where the library came from: path, whether this process built it,
    the build seconds and nvcc's output (register and spill counts)."""
    library()
    return dict(_info)


_P = ctypes.c_void_p
_CTYPES = {'p': _P, 'i': ctypes.c_int, 'q': ctypes.c_longlong,
           'd': ctypes.c_double, 'f': ctypes.c_float}
_bound = {}


def function(name, signature):
    """C entry point ``name`` of the library with argument types from
    ``signature`` (one letter per argument: p pointer or stream, i int,
    q long long, d double, f float); returns int (a cudaError_t)."""
    fn = _bound.get(name)
    if fn is None:
        lib = library()
        with state_lock:
            fn = _bound.get(name)
            if fn is None:
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPES[c] for c in signature]
                fn.restype = ctypes.c_int
                _bound[name] = fn
    return fn


def check(name, err):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        fn = library().nd_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError('%s: CUDA error %d (%s) at launch'
                           % (name, err, fn(err).decode()))
