"""Host (C++) components of nd_tpu_torch: the JPEG 2000 Tier-1 decoder.

``jp2_t1.cpp`` is built with the host compiler (``g++ -O3 -fopenmp
-shared -fPIC -std=c++17``) at first use into ``nd_tpu_torch/.build/``
(listed in ``.gitignore``), under a name that carries the hash of the
source, the compiler and the flags, and bound with :mod:`ctypes`. The
build writes a temporary file and renames it into place, so processes
that build at once never load half a library. A missing compiler, a
failed build or a failed load raises: nothing falls back to the Python
decoder.
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
           'CXX_FLAGS']

_SRC = Path(__file__).resolve().parent / 'jp2_t1.cpp'
_BUILD_DIR = Path(__file__).resolve().parents[1] / '.build'
CXX = 'g++'
CXX_FLAGS = ('-O3', '-fopenmp', '-shared', '-fPIC', '-std=c++17')
_T1_ORIENT = {'LL': 0, 'HL': 1, 'LH': 2, 'HH': 3}

_lock = threading.Lock()
_lib = None
_info = {}


def _build(cxx, target):
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, prefix=target.stem + '.',
                               suffix='.tmp')
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, '-o', tmp, str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError('host build of %s failed (exit %d):\n%s\n%s'
                               % (_SRC.name, proc.returncode, ' '.join(cmd),
                                  (proc.stdout + proc.stderr)[-4000:]))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library():
    """The loaded Tier-1 library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = shutil.which(CXX)
        if cxx is None:
            raise RuntimeError(
                '%s not found: the JPEG 2000 Tier-1 decoder of nd_tpu_torch '
                'is built with the host C++ compiler at first use' % CXX)
        h = hashlib.sha256(_SRC.read_bytes())
        h.update(' '.join((CXX,) + CXX_FLAGS).encode())
        target = _BUILD_DIR / ('libnd_jp2_t1_%s.so' % h.hexdigest()[:16])
        t0 = time.perf_counter()
        built = not target.exists()
        if built:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build(cxx, target)
        lib = ctypes.CDLL(str(target))
        fn = lib.nd_jp2_t1_decode_batch
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int64, p, p, p, ctypes.c_int]
        _info.update(path=str(target), built=built, compiler=cxx,
                     seconds=time.perf_counter() - t0)
        _lib = lib
        return lib


def build_info():
    """Where the library came from: path, compiler, whether this process
    built it and the seconds the build (or load) took."""
    library()
    return dict(_info)


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
