"""Fast (float32) omnibus change-point scan: the ``omnibus`` CUDA kernel
(``csrc/omnibus.cu``) and its plain PyTorch version.

Replaces ``nd_tpu/ops/change_pallas.py`` ``change_detection_pallas``
(``_kernel``, ``_mlog``). Outputs are the bit-packed int32 flag planes
(bit t%31 of plane t//31) and, with ``return_margin``, each pixel's
smallest decision margin net of the f32 error bound — the input of the
exact mode's rescan (``ops.change.change_detection_exact``). On the H100
the kernel is bound by device-memory bytes with f32 arithmetic close
behind: a block of threads owns consecutive pixels and stages their
series through shared memory with coalesced copies; one thread runs one
pixel's restart rounds and stops when the pixel is done. ``_round_plan``
picks the block's pixels and whether the series stays resident or
streams its chunks. See the source for the design.

``change_detection_fast`` runs the kernel for a CUDA tensor and the
plain version for a CPU tensor; for any other device it raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..core.variable import as_tensor
from .change import _P, omnibus_rho, omnibus_thresholds

__all__ = ['change_detection_fast', 'omnibus_plain', 'unpack_flags',
           'omnibus_tables', 'supports_rescan', 'round_smem',
           'round_plan_candidates', 'MAX_K', 'K_MAX', 'K_RESCAN_MAX',
           'launches']

MAX_K = 256            # kMaxK in csrc/omnibus.cu
SMEM_MAX = 232448      # kSmemMax: shared memory a block may use (H100)
STATIC_SMEM = 2064     # kStatic: the kernel's tables and anchors
# Series lengths the exact mode sends to the round kernel; longer ones
# take the sequential scan (ops/change_scan_cuda.py) up to K_RESCAN_MAX
# (its kMaxK), and the float64 'mixed' scan beyond.
K_MAX = 48
K_RESCAN_MAX = 256
# The longest series the round kernel keeps resident (the whole series
# staged once); longer ones stream their chunks each round. From the
# round plan sweep (nd_tpu_torch/scan_sweep.py round): resident blocks of
# 128 won at k = 16, 20 and 28, streamed ones from k = 32 on.
RESIDENT_K = 28

launches = 0           # kernel launches since import (or reset)


def reset_launches():
    global launches
    launches = 0


def _round_cap(k):
    """Restart rounds for the exact mode's capped pass: ``max(4, k//4)``
    (at most k-1). A pixel consumes one round per detected change point;
    one still active at the cap gets margin -inf and its full row is
    rescanned exactly."""
    return min(k - 1, max(4, k // 4))


def supports_rescan(k, n, alpha):
    """True when a kernel serves the exact mode at series length ``k``:
    the round kernel for k <= ``K_MAX``, the sequential scan for
    ``K_MAX`` < k <= ``K_RESCAN_MAX`` when its folded threshold tables
    are feasible for (n, alpha) (the tables are cached). Otherwise the
    caller takes the float64 'mixed' scan: a choice made from the
    parameters before any launch."""
    if k > K_RESCAN_MAX:
        return False
    if k > K_MAX:
        from .change_scan_cuda import scan_tables
        return scan_tables(int(k), int(n), float(alpha)) is not None
    return True


def omnibus_tables(k, n, alpha):
    """(c_tab, s_tab) of :func:`_tables` for this (k, n, alpha), as
    copies (the solve is cached)."""
    c_tab, s_tab = _tables(int(k), float(n), float(alpha))
    return c_tab.copy(), s_tab.copy()


@functools.lru_cache(maxsize=64)
def _tables(k, n, alpha):
    """Folded per-window-length immediates (host float64, stored f32).

    The decision z > thr(j), with rho(j) > 0, is s < C(j) for
    s = n log_prod - n j ln det_sum and
    C(j) = -thr(j)/(2 rho(j)) - n P j ln j; the margin is
    |s - C(j)| S(j) with S(j) = 2 rho(j)/max(|thr(j)|, 1). Lengths
    without a finite threshold get C = -inf (never hits), S = 0."""
    thresholds = omnibus_thresholds(k, n, float(alpha))
    nf = float(n)
    with np.errstate(divide='ignore', invalid='ignore'):
        rho = omnibus_rho(np.arange(k + 1), nf)
    c_tab = np.full(k + 1, -np.inf, np.float32)
    s_tab = np.zeros(k + 1, np.float32)
    for j in range(2, k + 1):
        if np.isfinite(thresholds[j]):
            c_tab[j] = np.float32(-thresholds[j] / (2 * rho[j])
                                  - nf * _P * j * np.log(j))
            s_tab[j] = np.float32(2 * rho[j] / max(abs(thresholds[j]), 1.0))
    return c_tab, s_tab


def _mlog(x):
    """Accurate f32 natural log (about 1 ulp), the kernel's ``mlog``:
    x = m 2^e by bit twiddling, m centred in [sqrt(1/2), sqrt(2)),
    ln m = 2 atanh(t), t = (m-1)/(m+1), with a short odd polynomial.
    Non-normal inputs defer to ``torch.log``."""
    f32 = torch.float32

    def c(v):
        return torch.tensor(v, dtype=f32, device=x.device)

    xi = x.view(torch.int32)
    e = ((xi >> 23) & 0x1FF) - 127
    m = ((xi & 0x007FFFFF) | 0x3F800000).view(f32)
    big = m > c(1.4142135)
    m = torch.where(big, m * c(0.5), m)
    ef = (e + big.to(torch.int32)).to(f32)
    t = (m - c(1.0)) / (m + c(1.0))
    t2 = t * t
    p = c(1 / 9.0)
    p = p * t2 + c(1 / 7.0)
    p = p * t2 + c(1 / 5.0)
    p = p * t2 + c(1 / 3.0)
    p = p * t2 + c(1.0)
    res = ef * c(0.693359375) + (c(2.0) * t * p
                                 + ef * c(-2.121944400546905e-04))
    normal = (x >= c(1.17549435e-38)) & (x < c(np.inf))
    return torch.where(normal, res, torch.log(x))


def omnibus_plain(values, c_tab, s_tab, nf, rounds, with_margin):
    """Plain PyTorch version of the kernel over a (y, x, k, 4) float32
    tensor: the same round scan, per-pixel state held as (y, x) planes.
    Returns the (P, y, x) int32 packed planes and the (y, x) margin (or
    None)."""
    ny, nx, k, _ = values.shape
    dev = values.device
    f32 = torch.float32

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    u64 = c(64 * 1.2e-7)
    log_err = c(1e-5)
    inf = c(np.inf)
    nf_t = c(nf)
    ctab = torch.as_tensor(c_tab, device=dev)
    stab = torch.as_tensor(s_tab, device=dev)
    nplanes = (k + 30) // 31
    packed = torch.zeros((nplanes, ny, nx), dtype=torch.int32, device=dev)
    margin = torch.full((ny, nx), np.inf, dtype=f32, device=dev)
    l = torch.zeros((ny, nx), dtype=torch.int64, device=dev)
    active = torch.full((ny, nx), k > 1, dtype=torch.bool, device=dev)

    ch = [values[..., t, :] for t in range(k)]
    per_t = []
    for t in range(k):
        c11, c12r, c12i, c22 = (ch[t][..., i] for i in range(4))
        det = c11 * c22 - c12r * c12r - c12i * c12i
        item = {'det_neg': (det < 0).to(f32), 'ld': _mlog(torch.abs(det))}
        if with_margin:
            prods = torch.abs(c11 * c22) + c12r * c12r + c12i * c12i
            item['cond'] = torch.minimum(
                prods / torch.maximum(torch.abs(det), c(1e-37)), c(1e18))
            item['unc'] = (torch.abs(det) < u64 * prods).to(f32)
        per_t.append(item)

    zero = c(0.0)
    for _ in range(rounds):
        if not bool(active.any()):
            break
        s = {key: torch.zeros((ny, nx), dtype=f32, device=dev)
             for key in ('c11', 'c12r', 'c12i', 'c22', 'ld', 'neg', 'cond',
                         'unc')}
        round_margin = torch.full((ny, nx), np.inf, dtype=f32, device=dev)
        t_first = torch.full((ny, nx), -1, dtype=torch.int64, device=dev)
        hit_last = torch.zeros((ny, nx), dtype=torch.bool, device=dev)
        for t in range(k):
            m = t >= l
            for i, key in enumerate(('c11', 'c12r', 'c12i', 'c22')):
                s[key] = s[key] + torch.where(m, ch[t][..., i], zero)
            s['ld'] = s['ld'] + torch.where(m, per_t[t]['ld'], zero)
            s['neg'] = s['neg'] + torch.where(m, per_t[t]['det_neg'], zero)
            if with_margin:
                s['cond'] = s['cond'] + torch.where(m, per_t[t]['cond'],
                                                    zero)
                s['unc'] = s['unc'] + torch.where(m, per_t[t]['unc'], zero)
            if t == 0:
                continue
            valid = t >= l + 1
            jt_i = (t - l + 1).clamp(0, k)
            jt = jt_i.to(f32)
            dos = s['c11'] * s['c22'] - s['c12r'] * s['c12r'] \
                - s['c12i'] * s['c12i']
            odd_neg = (s['neg'] - c(2.0) * torch.floor(s['neg'] * c(0.5))) \
                > c(0.5)
            log_prod = torch.where(odd_neg, c(np.nan), s['ld'])
            stat = nf_t * log_prod - (nf_t * jt) * _mlog(dos)
            c_t = ctab[jt_i]
            hit = (stat < c_t) & valid
            t_first = torch.where(hit & (t_first < 0),
                                  torch.full_like(t_first, t), t_first)
            if t == k - 1:
                hit_last = hit
            if with_margin:
                det_prods = torch.abs(s['c11'] * s['c22']) \
                    + s['c12r'] * s['c12r'] + s['c12i'] * s['c12i']
                cond_sum = torch.minimum(
                    det_prods / torch.maximum(torch.abs(dos), c(1e-37)),
                    c(1e18))
                serr = nf_t * ((s['cond'] + jt * cond_sum) * u64
                               + (jt + c(1.0)) * log_err)
                sign_unc = (s['unc'] > c(0.5)) \
                    | (torch.abs(dos) < u64 * det_prods)
                rel = (torch.abs(stat - c_t) - serr) * stab[jt_i]
                rel = torch.where(torch.isfinite(stat), rel,
                                  torch.where(sign_unc, -inf, inf))
                rel = torch.where(valid & torch.isfinite(c_t), rel, inf)
                round_margin = torch.fmin(round_margin, rel)
        if with_margin:
            margin = torch.where(active, torch.fmin(margin, round_margin),
                                 margin)
        active = active & hit_last
        pos = torch.maximum(t_first, l + 1)
        for pp in range(nplanes):
            inplane = (pos >= 31 * pp) & (pos < 31 * (pp + 1))
            bit = torch.bitwise_left_shift(
                torch.ones_like(packed[pp]),
                (pos - 31 * pp).clamp(0, 30).to(torch.int32))
            packed[pp] = packed[pp] | torch.where(active & inplane, bit,
                                                  torch.zeros_like(bit))
        l = torch.where(active, pos, l)
        active = active & (l < k - 1)
    if not with_margin:
        return packed, None
    if rounds < k - 1:
        margin = torch.where(active, -inf, margin)
    return packed, margin


@functools.lru_cache(maxsize=64)
def _bits(nb, device):
    """1 << t for t < nb as int32 on ``device``, cached: unpacking is two
    elementwise kernels a plane and no host-to-device copy."""
    return torch.tensor([1 << t for t in range(nb)], dtype=torch.int32,
                        device=device)


def unpack_flags(packed, k):
    """(P, ..., y, x) int32 bit-packed planes -> (..., y, x, k) bool
    (bit t%31 of plane t//31 = flag at time t): per plane one AND with
    the plane's bits and one compare written into its slice of the
    output."""
    out = torch.empty(packed.shape[1:] + (k,), dtype=torch.bool,
                      device=packed.device)
    for pp in range((k + 30) // 31):
        nb = min(31, k - 31 * pp)
        torch.ne(packed[pp][..., None] & _bits(nb, packed.device), 0,
                 out=out[..., 31 * pp:31 * pp + nb])
    return out


# ---- the kernel's plan ------------------------------------------------------

_THREADS = (32, 64, 128, 256)   # pixels (threads) of a block
_CHUNK_STEPS = (3, 7, 15, 31)   # T of the streamed mode


def round_smem(threads, T, nbuf):
    """Dynamic shared-memory bytes of a block (``round_smem`` in
    csrc/omnibus.cu): ``nbuf`` chunk buffers of ``threads`` rows at a
    stride of ``T | 1`` 16-byte steps. The tables add ``STATIC_SMEM``
    bytes of static shared memory."""
    return nbuf * threads * (T | 1) * 16


def _round(k, npix, threads, T, nbuf):
    T = min(T, k)
    nbuf = min(nbuf, -(-k // T))
    return dict(threads=threads, T=T, nbuf=nbuf, resident=nbuf * T >= k,
                smem=round_smem(threads, T, nbuf),
                blocks=-(-npix // threads))


@functools.lru_cache(maxsize=512)
def round_plan_candidates(k, npix):
    """Every plan of the sweep that fits the shared memory: resident
    (the whole series in one chunk) and, where the series has more than
    one chunk, streamed (chunks of 3, 7, 15 or 31 steps through 2 or 3
    buffers), at 32 to 256 pixels a block. Returns a tuple of plan
    dicts."""
    plans = {}
    limit = SMEM_MAX - STATIC_SMEM
    for threads in _THREADS:
        shapes = [(k, 1)] + [(T, nbuf) for T in _CHUNK_STEPS
                             for nbuf in (2, 3) if T < k]
        for T, nbuf in shapes:
            p = _round(k, npix, threads, T, nbuf)
            key = (threads, p['T'], p['nbuf'])
            if p['smem'] <= limit and key not in plans:
                plans[key] = p
    return tuple(plans.values())


@functools.lru_cache(maxsize=512)
def _round_plan(k, npix):
    """The kernel's plan for ``npix`` series of ``k`` steps: a dict with
    ``threads`` (the block's pixels), ``T`` (steps per chunk), ``nbuf``
    (chunk buffers), ``resident``, ``smem`` (dynamic bytes) and
    ``blocks``. Series of up to RESIDENT_K steps stay resident in blocks
    of 128 pixels; longer ones stream chunks of 7 steps through three
    buffers in blocks of 128. Cached per (k, npix)."""
    if k <= RESIDENT_K:
        return _round(k, npix, 128, k, 1)
    return _round(k, npix, 128, 7, 3)


@functools.lru_cache(maxsize=None)
def _setup(device_index):
    """Raise the kernel's dynamic shared-memory limit on one device,
    once."""
    with torch.cuda.device(device_index):
        _build.check('nd_omnibus_setup',
                     _build.function('nd_omnibus_setup', '')())


@functools.lru_cache(maxsize=64)
def _device_tables(k, n, alpha, device):
    """(C, S) of :func:`_tables` on the card as float32, cached so that
    a call copies nothing to the device."""
    c_tab, s_tab = _tables(k, n, alpha)
    return (torch.tensor(c_tab, device=device),
            torch.tensor(s_tab, device=device))


def _launch(values, k, n, alpha, rounds, with_margin, plan):
    ny, nx = values.shape[:2]
    npix = ny * nx
    dev = values.device
    if values.data_ptr() % 16:
        values = values.clone()      # the kernel loads 16-byte steps
    if plan is None:
        plan = _round_plan(k, npix)
    _setup(dev.index if dev.index is not None
           else torch.cuda.current_device())
    c_dev, s_dev = _device_tables(int(k), float(n), float(alpha), dev)
    packed = torch.empty(((k + 30) // 31, ny, nx), dtype=torch.int32,
                         device=dev)
    margin = torch.empty((ny, nx), dtype=torch.float32, device=dev) \
        if with_margin else None
    fn = _build.function('nd_omnibus_f32', 'pppqiiiippfip')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values.data_ptr(), packed.data_ptr(),
                 margin.data_ptr() if with_margin else None, npix, k,
                 plan['threads'], plan['T'], plan['nbuf'],
                 c_dev.data_ptr(), s_dev.data_ptr(),
                 float(n), rounds, stream)
    _build.bump(globals(), 'launches')
    _build.check('nd_omnibus_f32', err)
    return packed, margin


def change_detection_fast(values, alpha, n=1, return_margin=False,
                          return_packed=False, max_rounds=None, device=None,
                          plan=None):
    """Fast (f32) omnibus change detection: values (y, x, time, 4) ->
    (y, x, time) bool, or with ``return_packed`` the (P, y, x) int32
    planes; with ``return_margin`` also the (y, x) float32 margins.

    ``max_rounds`` caps the restart rounds; a pixel still active at the
    cap has incomplete flags and gets margin -inf, so a cap below k-1
    requires ``return_margin`` (the caller must rescan those pixels).
    Float64 input is cast to float32 for the scan. Non-tensor ``values``
    land on ``device`` (default ``cuda``). ``plan`` forces one of
    :func:`round_plan_candidates` on the card (tests and the plan
    sweep); by default :func:`_round_plan` picks it.
    """
    values = as_tensor(values, device)
    if values.ndim != 4 or values.shape[3] != 4:
        raise ValueError('values must be (y, x, time, 4)')
    ny, nx, k, _ = values.shape
    if not 1 <= k <= MAX_K:
        raise ValueError('series length %d outside 1..%d' % (k, MAX_K))
    rounds = k - 1 if max_rounds is None else int(min(k - 1, max_rounds))
    if rounds < k - 1 and not return_margin:
        raise ValueError('max_rounds < k-1 caps the scan before every '
                         'pixel can finish; return_margin=True is '
                         'required')
    values = values.to(torch.float32).contiguous()
    if values.device.type == 'cpu':
        packed, margin = omnibus_plain(values, *omnibus_tables(k, n, alpha),
                                       float(n), rounds, return_margin)
    elif values.device.type == 'cuda':
        packed, margin = _launch(values, k, n, alpha, rounds, return_margin,
                                 plan)
    else:
        raise ValueError('change_detection_fast runs on cuda or cpu '
                         'tensors, not %s' % values.device)
    result = packed if return_packed else unpack_flags(packed, k)
    return (result, margin) if return_margin else result
