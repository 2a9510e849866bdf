"""Streaming probe: the ``stream_probe`` CUDA kernel
(``csrc/stream_probe.cu``), ``x + 1`` over a (M, 1024) float32 tensor
with its row slabs staged through shared memory by TMA bulk copies, and
its plain version.

Replaces ``bench.py`` ``_measure_dma_through``, the TPU benchmark's
ceiling for streaming kernels that stage their data (double-buffered
DMA of row slabs into VMEM). Its rate, 2 x bytes / time, is the
bandwidth such a kernel can reach on the card; ``chip_smoke.py`` reports
it beside ``torch.add(x, 1)`` and the data sheet's 3.35 TB/s.

``stream_plus_one`` runs the kernel for a CUDA tensor and the plain
version for a CPU tensor; for any other device it raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

__all__ = ['stream_plus_one', 'stream_plus_one_plain', 'COLS', 'launches']

COLS = 1024            # kCols in csrc/stream_probe.cu

launches = 0           # kernel launches since import (or reset)


def reset_launches():
    global launches
    launches = 0


def stream_plus_one_plain(x):
    """Plain PyTorch version: ``x + 1``."""
    return x + 1


@functools.lru_cache(maxsize=None)
def _grid(device_index):
    """The kernel's persistent grid on one device (one or two blocks per
    SM, from its occupancy), queried once: the query and the
    shared-memory attribute cost host time that ``torch.add`` does not
    pay."""
    per_sm = ctypes.c_int(0)
    fn = _build.function('nd_stream_probe_setup', 'p')
    _build.check('nd_stream_probe_setup', fn(ctypes.addressof(per_sm)))
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm.value * sms


def stream_plus_one(x):
    """``x + 1`` for a contiguous (M, 1024) float32 tensor whose data
    starts on a 16-byte boundary; raises on anything else."""
    if x.dtype != torch.float32:
        raise TypeError('stream_plus_one takes float32, not %s' % x.dtype)
    if x.ndim != 2 or x.shape[1] != COLS:
        raise ValueError('stream_plus_one takes (M, %d), not %r'
                         % (COLS, tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError('stream_plus_one needs a contiguous tensor')
    if x.device.type == 'cpu':
        return stream_plus_one_plain(x)
    if x.device.type != 'cuda':
        raise ValueError('stream_plus_one runs on cuda or cpu tensors, not '
                         '%s' % x.device)
    if x.data_ptr() % 16:
        raise ValueError('stream_plus_one needs 16-byte aligned data')
    out = torch.empty_like(x)
    fn = _build.function('nd_stream_plus_one_f32', 'ppqip')
    with torch.cuda.device(x.device):
        blocks = _grid(torch.cuda.current_device())
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], blocks, stream)
    _build.bump(globals(), 'launches')
    _build.check('nd_stream_plus_one_f32', err)
    return out
