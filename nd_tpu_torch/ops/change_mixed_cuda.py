"""The omnibus scan at the scan's own precision: the ``omnibus_mixed``
CUDA kernels (``csrc/omnibus_mixed.cu``) and their plain PyTorch
versions, through two entry points.

Replaces the XLA program of ``nd_tpu/ops/change.py`` ``change_detection``
(``stat_dtype='mixed'``, ``'float64'`` or ``'float32'``), which the
reference's exact mode runs on its compacted suspects and, where no
kernel serves the series length, on the whole grid.

  - :func:`rescan`: the exact mode's rescan. It takes the margins of
    the float32 kernel and the ``(npix, k, 4)`` cube itself; the pixels
    whose margin is not above ``margin_eps`` (NaN included) are selected
    on the card into a queue whose count stays in device memory, and
    the 'mixed' scan of each writes its flag planes straight into the
    ``(P, npix)`` planes. No host sync, no gather, no scatter.
  - :func:`mixed_scan`: every row of a contiguous ``(N, k, 4)`` batch
    (the full-grid route), returning the ``(ceil(k/31), N)`` int32
    planes of ``ops.change.pack_flags``.

The plain versions (:func:`rescan_plain`, :func:`mixed_scan_plain`) run
``ops.change.change_detection_plain``, which launches about 40 small
operations per time step per round and syncs the host once per round.
The kernel scans one series per warp: the lanes compute the per-step
terms in parallel, lanes 0-4 carry the running sums strictly left to
right, and every lane tests one window of a 32-step chunk. A warp keeps
its series in shared memory or, where that is too small (k above about
1400 steps of float64 sums), in a device workspace: any k is served. Its decisions
are bit-equal to the plain version on the card for 'mixed' and
'float64' (the same operations in the same order; see the source).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .change import change_detection_plain, decision_tables, pack_flags, \
    stat_types

SMEM_MAX = 232448      # shared memory a block may use (H100)
WARPS = 4              # kWarps: series a block of the kernel scans at once

__all__ = ['mixed_scan', 'mixed_scan_plain', 'rescan', 'rescan_plain',
           'rescan_smem', 'launches']

launches = 0           # kernel launches since import (or reset)


def reset_launches():
    global launches
    launches = 0


def mixed_scan_plain(rows, alpha, n, stat_dtype='mixed'):
    """Plain PyTorch version: ``change_detection_plain`` over the rows
    as one (1, N) grid, packed. Returns the (P, N) int32 planes."""
    flags = change_detection_plain(rows[None], alpha, n, stat_dtype)[0]
    return pack_flags(flags)


def rescan_plain(values, margin, packed, alpha, n, margin_eps,
                 stat_dtype='mixed'):
    """Plain version of :func:`rescan`: the pixels whose margin is not
    above ``margin_eps`` (NaN included) are gathered, scanned by
    :func:`mixed_scan_plain` and their planes scattered into ``packed``
    in place. Returns their number as a 1-element int32 tensor."""
    idx = torch.nonzero(~(margin.reshape(-1) > margin_eps)).reshape(-1)
    if idx.numel():
        planes = packed.view(packed.shape[0], -1)
        planes[:, idx] = mixed_scan_plain(values.index_select(0, idx),
                                          alpha, n, stat_dtype)
    return torch.tensor([idx.numel()], dtype=torch.int32,
                        device=values.device)


@functools.lru_cache(maxsize=64)
def _device_table(k, n, alpha, ldtype, device):
    """(use_folded, the decision table on the card in the log type),
    cached so that a call makes no host-to-device copy."""
    use_folded, table = decision_tables(k, n, alpha, ldtype)
    return use_folded, torch.tensor(table, dtype=ldtype, device=device)


@functools.lru_cache(maxsize=256)
def rescan_smem(k, sdtype, ldtype):
    """Shared-memory bytes of a block of the scan kernel
    (``nd_omnibus_mixed_smem`` in csrc/omnibus_mixed.cu): for each of
    its ``WARPS`` series the per-step logs (k of the log type), the
    chunk's log prefixes (32 of the log type), the channels (4 x k of
    the sum type), the channel prefixes (4 x 33 of the sum type) and
    the sign words (4 bytes per 32 steps), rounded up to 16 bytes.
    Past ``SMEM_MAX`` (k above 1415 steps of float64 sums, 2376 of
    float32 sums with float64 logs) a block keeps them in as many bytes
    of device memory instead (the kernel's workspace route)."""
    per_warp = ((k + 32) * ldtype.itemsize + 4 * (k + 33) * sdtype.itemsize
                + 4 * (-(-k // 32)))
    return WARPS * (-(-per_warp // 16) * 16)


@functools.lru_cache(maxsize=None)
def _grid(k, sum_f64, log_f64, device_index):
    """The scan kernel's persistent grid (blocks) for k steps on the
    current device, asked of the library once per (k, types, device)."""
    fn = _build.function('nd_omnibus_mixed_grid', 'iii')
    fn.restype = ctypes.c_longlong
    blocks = fn(k, sum_f64, log_f64)
    if blocks < 1:
        raise RuntimeError('nd_omnibus_mixed_grid: CUDA error for k=%d' % k)
    return blocks


def _check_rows(rows, name):
    if not isinstance(rows, torch.Tensor) or rows.device.type not in (
            'cuda', 'cpu'):
        raise ValueError('%s runs on cuda or cpu tensors' % name)
    if rows.dtype not in (torch.float32, torch.float64):
        raise TypeError('%s takes float32 or float64 rows, not %s'
                        % (name, rows.dtype))
    if rows.ndim != 3 or rows.shape[2] != 4 or rows.shape[1] < 1:
        raise ValueError('rows must be (N, k, 4) with k >= 1, not %r'
                         % (tuple(rows.shape),))
    if not rows.is_contiguous():
        raise ValueError('%s needs contiguous rows' % name)


def _launch(rows, planes, alpha, n, stat_dtype, margin=None, margin_eps=0.0):
    """The scan kernel over every row into ``planes``, or with ``margin``
    over the rows whose margin is not above ``margin_eps``, selected on
    the card; then returns their count (a 1-element int32 tensor)."""
    sdtype, ldtype = stat_types(stat_dtype, rows.dtype)
    nrows, k, _ = rows.shape
    rows = rows.to(sdtype)
    if rows.data_ptr() % 16:
        rows = rows.clone()          # the kernel loads 16-byte steps
    use_folded, table = _device_table(int(k), float(n), float(alpha),
                                      ldtype, rows.device)
    types = (int(sdtype == torch.float64), int(ldtype == torch.float64))
    queue = count = None
    if margin is not None:       # the suspects' rows, and their count
        queue = torch.empty(max(nrows, 1), dtype=torch.int32,
                            device=rows.device)
        count = torch.empty(1, dtype=torch.int32, device=rows.device)
    fn = _build.function('nd_omnibus_mixed', 'ppfpppqiiipidqpp')
    with torch.cuda.device(rows.device):
        blocks = _grid(k, *types, torch.cuda.current_device())
        work = None           # the series' scratch, where smem is too small
        if rescan_smem(k, sdtype, ldtype) > SMEM_MAX:
            work = torch.empty(blocks * rescan_smem(k, sdtype, ldtype),
                               dtype=torch.uint8, device=rows.device)
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(),
                 None if margin is None else margin.data_ptr(),
                 float(margin_eps),
                 None if queue is None else queue.data_ptr(),
                 None if count is None else count.data_ptr(),
                 planes.data_ptr(), nrows, k, *types, table.data_ptr(),
                 int(use_folded), float(n), blocks,
                 None if work is None else work.data_ptr(), stream)
    _build.bump(globals(), 'launches')
    _build.check('nd_omnibus_mixed', err)
    return count


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
    _check_rows(rows, 'mixed_scan')
    nrows, k, _ = rows.shape
    planes = torch.empty(((k + 30) // 31, nrows), dtype=torch.int32,
                         device=rows.device)
    if nrows:
        _launch(rows, planes, alpha, n, stat_dtype)
    return planes


def rescan(values, margin, packed, alpha, n, margin_eps,
           stat_dtype='mixed'):
    """The exact mode's rescan: the scan at ``stat_dtype`` of every pixel
    of the contiguous ``(npix, k, 4)`` ``values`` whose ``margin`` (npix
    float32) is not above ``margin_eps`` (NaN included), written into
    the ``(P, ...)`` int32 ``packed`` planes in place. Returns the number
    of those pixels as a 1-element int32 tensor on ``values``' device,
    so that nothing waits for it unless the caller reads it.

    A CUDA tensor runs the selection and the scan kernels; a CPU tensor
    the plain version, :func:`rescan_plain`."""
    _check_rows(values, 'rescan')
    npix, k, _ = values.shape
    if margin.numel() != npix or packed.shape[0] != (k + 30) // 31 \
            or packed[0].numel() != npix:
        raise ValueError('rescan: margin (npix,) and packed (P, npix) must '
                         'match values (npix, k, 4)')
    if margin.dtype != torch.float32 or packed.dtype != torch.int32 \
            or not margin.is_contiguous() or not packed.is_contiguous():
        raise ValueError('rescan takes contiguous float32 margins and int32 '
                         'planes')
    if values.device.type == 'cpu':
        return rescan_plain(values, margin, packed, alpha, n, margin_eps,
                            stat_dtype)
    return _launch(values, packed, alpha, n, stat_dtype, margin, margin_eps)
