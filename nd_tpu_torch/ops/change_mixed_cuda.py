"""The omnibus scan of gathered series at the scan's own precision: the
``omnibus_mixed`` CUDA kernel (``csrc/omnibus_mixed.cu``) and its plain
PyTorch version.

Replaces the XLA program of ``nd_tpu/ops/change.py`` ``change_detection``
(``stat_dtype='mixed'``, ``'float64'`` or ``'float32'``), which the
reference's exact mode runs on its compacted suspects and, where no
kernel serves the series length, on the whole grid. The plain version
(``ops.change.change_detection_plain``) launches about 40 small
operations per time step per round and syncs the host once per round;
the kernel runs one thread per series, all rounds in registers. Its
decisions are bit-equal to the plain version on the card for 'mixed' and
'float64' (the same operations in the same order; see the source).

Input is a contiguous ``(N, k, 4)`` float32 or float64 batch of series
[C11, C12.re, C12.im, C22]; output the ``(ceil(k/31), N)`` int32
bit-packed flag planes of ``ops.change.pack_flags`` (bit t%31 of plane
t//31), so the exact mode scatters them straight into its planes.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .change import change_detection_plain, decision_tables, pack_flags, \
    stat_types

__all__ = ['mixed_scan', 'mixed_scan_plain', 'launches']

launches = 0           # kernel launches since import (or reset)


def reset_launches():
    global launches
    launches = 0


def mixed_scan_plain(rows, alpha, n, stat_dtype='mixed'):
    """Plain PyTorch version: ``change_detection_plain`` over the rows
    as one (1, N) grid, packed. Returns the (P, N) int32 planes."""
    flags = change_detection_plain(rows[None], alpha, n, stat_dtype)[0]
    return pack_flags(flags)


@functools.lru_cache(maxsize=64)
def _device_table(k, n, alpha, ldtype, device):
    """(use_folded, the decision table on the card in the log type),
    cached so that a call makes no host-to-device copy."""
    use_folded, table = decision_tables(k, n, alpha, ldtype)
    return use_folded, torch.tensor(table, dtype=ldtype, device=device)


def mixed_scan(rows, alpha, n, stat_dtype='mixed'):
    """The ``omnibus_mixed`` kernel over a contiguous (N, k, 4) float32
    or float64 CUDA tensor: returns the (P, N) int32 flag planes.

    Precision: 'mixed' sums the channels in the input's dtype and runs
    the determinant/log/decision math in float64; 'float64' and
    'float32' run everything in that type (the input is converted
    first where its dtype differs). Raises on anything but a CUDA
    tensor, on another dtype, shape or a non-contiguous tensor; the
    plain version is :func:`mixed_scan_plain`.
    """
    if not isinstance(rows, torch.Tensor) or rows.device.type != 'cuda':
        raise ValueError('mixed_scan runs on CUDA tensors; the plain '
                         'version is mixed_scan_plain')
    if rows.dtype not in (torch.float32, torch.float64):
        raise TypeError('mixed_scan takes float32 or float64 rows, not %s'
                        % rows.dtype)
    if rows.ndim != 3 or rows.shape[2] != 4 or rows.shape[1] < 1:
        raise ValueError('rows must be (N, k, 4) with k >= 1, not %r'
                         % (tuple(rows.shape),))
    if not rows.is_contiguous():
        raise ValueError('mixed_scan needs contiguous rows')
    sdtype, ldtype = stat_types(stat_dtype, rows.dtype)
    nrows, k, _ = rows.shape
    rows = rows.to(sdtype)
    if rows.data_ptr() % 16:
        rows = rows.clone()          # the kernel loads 16-byte steps
    planes = torch.empty(((k + 30) // 31, nrows), dtype=torch.int32,
                         device=rows.device)
    if nrows == 0:
        return planes
    use_folded, table = _device_table(int(k), float(n), float(alpha),
                                      ldtype, rows.device)
    fn = _build.function('nd_omnibus_mixed', 'ppqiiipidp')
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), planes.data_ptr(), nrows, k,
                 int(sdtype == torch.float64), int(ldtype == torch.float64),
                 table.data_ptr(), int(use_folded), float(n), stream)
    global launches
    launches += 1
    _build.check('nd_omnibus_mixed', err)
    return planes
