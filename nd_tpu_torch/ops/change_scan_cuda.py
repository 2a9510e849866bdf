"""Long-series omnibus change-point scan: the ``omnibus_scan`` CUDA
kernel (``csrc/omnibus_scan.cu``) and its plain PyTorch version.

Replaces ``nd_tpu/ops/change_scan_pallas.py`` ``change_detection_scan``
(``_scan_kernel``, ``scan_tables``). The round kernel
(``ops/change_cuda.py``) re-evaluates every window from the current
anchor each restart round; this scan has no rounds. The restart chain
advances monotonically in time, so three O(k) passes give the same
decisions:

  pass A (forward)   the ungated tentative restart chain, with running
                     sums that reset at each detected change; the
                     interior thresholds come from a host-fitted
                     polynomial in sqrt(j), whose f32 evaluation error
                     is measured on the host and charged to the margin;
  pass B (backward)  every anchor's global test (the window [t, k-1])
                     from suffix sums, with exact float64 thresholds;
  pass C (forward)   commits the tentative flags under the scan's gate:
                     flag i+1 is kept iff the global tests of anchors
                     0, t_1, ..., t_i all reject.

Outputs are the bit-packed int32 flag planes (bit t%31 of plane t//31)
and each pixel's smallest decision margin net of the f32 error bound;
the exact mode (``ops.change.change_detection_exact``) rescans the
pixels whose margin is not above its eps. On the H100 the kernel's
bound is device-memory bytes, with f32 arithmetic close behind: one
thread per pixel, O(k) work, each block's series staged through shared
memory in chunks of T steps; the kernel runs pass A first, so that B
tests only the anchors C can commit. ``_scan_plan`` picks the block's
pixels, T and the ring of chunk buffers. See the source for the
design.

``scan_kernel`` (and ``change_detection_scan`` through it) runs the
kernel for a CUDA tensor and the plain version for a CPU tensor; for
any other device it raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..core.variable import as_tensor
from .change import _P, omnibus_rho, omnibus_thresholds
from .change_cuda import _mlog, unpack_flags

__all__ = ['change_detection_scan', 'scan_kernel', 'scan_plain',
           'scan_tables', 'scan_smem', 'plan_candidates', 'K_SCAN_MAX',
           'SMEM_MAX', 'launches']

K_SCAN_MAX = 256       # kMaxK in csrc/omnibus_scan.cu
SMEM_MAX = 232448      # kSmemMax: shared memory a block may use (H100)
SMS = 132              # streaming multiprocessors of the H100 SXM
SNAPSHOTS = 8          # kSnap in csrc/omnibus_scan.cu
_U64 = 64 * 1.2e-7     # f32 rounding with the margin safety factor
_LOG_ERR = 1e-5        # absolute _mlog error bound (per evaluation)

launches = 0           # kernel launches since import (or reset)


def reset_launches():
    global launches
    launches = 0


def _horner_f32(coefs, z):
    """Evaluate ``sum coefs[i] * z**i`` highest order first."""
    acc = coefs[-1]
    for c in coefs[-2::-1]:
        acc = acc * z + c
    return acc


def _sim_f32(coefs, z):
    """Host replica of the kernel's f32 Horner evaluation at the (already
    scaled) f32 variable ``z``: every product and sum rounds to f32."""
    acc = np.float32(coefs[-1])
    z = np.float32(z)
    for c in coefs[-2::-1]:
        acc = np.float32(np.float32(acc * z) + np.float32(c))
    return acc


@functools.lru_cache(maxsize=64)
def scan_tables(k, n, alpha):
    """Host-side threshold preparation for the scan (float64 numpy).

    The interior decision is rearranged so that the only j-dependent
    threshold is the flat ratio F2(j) = thr(j)/(2 rho(j)):

        z > thr  <=>  s' < -F2(j),   s' = n log_prod - n j log(det_sum/j^2)

    F2 is fitted in w = sqrt(j) for j >= 6; j in [2, 5] use exact
    one-hot immediates for the threshold and the margin scale. On the
    fitted range S(j) = 2 rho/max(thr, 1) = 1/F2, since thr >= 1 there
    (enforced).

    Returns ``None`` when the folded form is infeasible (non-finite
    thresholds, rho <= 0, too few lengths to fit, or thr < 1 on the
    fitted range); the callers take the float64 'mixed' scan then.
    Otherwise a dict with ``f2_coefs`` (lowest order first, in
    z = za sqrt(j) + zb), ``f2_small`` / ``s_small`` (j = 2..5),
    ``f2_rel_err`` (bound on the f32 evaluation's relative error over
    every integer j in [2, k], x4 safety), ``za`` / ``zb``, and
    ``cg_tab`` / ``sg_tab`` (exact folded threshold and margin scale of
    the global tests per window length; -inf / 0 where the threshold is
    not finite).
    """
    thr = omnibus_thresholds(k, n, float(alpha))
    with np.errstate(divide='ignore', invalid='ignore'):
        rho = omnibus_rho(np.arange(k + 1), n)
    js = np.arange(2, k + 1, dtype=np.float64)
    if not np.all(np.isfinite(thr[2:])) or not np.all(rho[2:] > 0):
        return None
    f2_exact = thr[2:] / (2 * rho[2:])
    s_exact = 2 * rho[2:] / np.maximum(np.abs(thr[2:]), 1.0)

    j0 = min(6, k)
    f2_small = tuple(float(v) for v in f2_exact[:j0 - 2])
    s_small = tuple(float(v) * (1.0 - 2.0 ** -20)
                    for v in s_exact[:j0 - 2])
    jf = np.arange(j0, k + 1, dtype=np.float64)
    if len(jf) < 2:
        return None
    if thr[j0:].min() < 1.0:
        return None
    vals = f2_exact[j0 - 2:]
    w = np.sqrt(jf)
    za = np.float32(2.0 / (w[-1] - w[0]))
    zb = np.float32(-1.0 - 2.0 * w[0] / (w[-1] - w[0]))
    z = 2 * (w - w[0]) / (w[-1] - w[0]) - 1

    def sim(coefs, j):
        wv = np.float32(np.sqrt(np.float32(j)))
        return _sim_f32(coefs, np.float32(wv * za + zb))

    best = None
    for deg in range(4, min(14, len(jf) - 1) + 1):
        cf = np.polynomial.polynomial.polyfit(z, vals, deg)
        got = np.array([sim(cf, j) for j in jf], np.float64)
        if got.min() <= 0:
            continue
        err = np.abs(got / vals - 1.0).max()
        if err <= 2e-5:
            best = (cf, err)        # the smallest adequate degree
            break
        if best is None or err < best[1]:
            best = (cf, err)
    if best is None:
        return None
    f2_coefs, fit_err = best
    f2_rel_err = 4.0 * float(fit_err) + 1e-6

    cg = np.full(k + 1, -np.inf)
    sg = np.zeros(k + 1)
    cg[2:] = (-thr[2:] / (2 * rho[2:])
              - n * _P * js * np.log(js))
    sg[2:] = 2 * rho[2:] / np.maximum(np.abs(thr[2:]), 1.0)
    return {
        'f2_coefs': tuple(float(c) for c in f2_coefs),
        'f2_small': f2_small,
        's_small': s_small,
        'f2_rel_err': f2_rel_err,
        'za': float(za),
        'zb': float(zb),
        'cg_tab': tuple(float(c) for c in cg),
        'sg_tab': tuple(float(c) for c in sg),
    }


def scan_plain(values, tabs, nf):
    """Plain PyTorch version of the kernel over a contiguous (y, x, k, 4)
    float32 tensor: passes A, B and C with per-pixel state held as
    (y, x) planes. Returns the (P, y, x) int32 packed planes and the
    (y, x) float32 margin."""
    ny, nx, k, _ = values.shape
    dev = values.device
    f32 = torch.float32

    def c(v):
        return torch.tensor(v, dtype=f32, device=dev)

    inf = c(np.inf)
    nan = c(np.nan)
    one = c(1.0)
    u64, inv_u64, log_err = c(_U64), c(1.0 / _U64), c(_LOG_ERR)
    nf_t = c(nf)
    coefs = [c(v) for v in tabs['f2_coefs']]
    f2_err = c(tabs['f2_rel_err'])
    f2_infl = c(1.0 + tabs['f2_rel_err'])
    za, zb = c(tabs['za']), c(tabs['zb'])

    def det_terms(x11, x12r, x12i, x22):
        det = x11 * x22 - x12r * x12r - x12i * x12i
        prods = torch.abs(x11 * x22) + x12r * x12r + x12i * x12i
        return det, prods

    # per-step log|det| and the sign-packed element conditioning
    chans, logdet, cond, neg = [], [], [], []
    for t in range(k):
        ch = tuple(values[:, :, t, i] for i in range(4))
        det, prods = det_terms(*ch)
        cnd = torch.minimum(prods / torch.maximum(torch.abs(det), c(1e-37)),
                            c(1e18))
        csd = torch.where(det < 0, -cnd, cnd)
        chans.append(ch)
        logdet.append(_mlog(torch.abs(det)))
        cond.append(torch.abs(csd))
        neg.append((csd < 0).to(f32))

    def window_stat(a11, a12r, a12i, a22, alog, aneg, acond, j, averaged):
        det_sum, det_prods = det_terms(a11, a12r, a12i, a22)
        odd = (aneg - c(2.0) * torch.floor(aneg * c(0.5))) > c(0.5)
        log_prod = torch.where(odd, nan, alog)
        if averaged:
            invj = one / j
            s = nf_t * log_prod - (nf_t * j) * _mlog(det_sum * invj * invj)
        else:
            s = nf_t * log_prod - (nf_t * j) * _mlog(det_sum)
        cond_sum = torch.minimum(
            det_prods / torch.maximum(torch.abs(det_sum), c(1e-37)),
            c(1e18))
        serr = nf_t * ((acond + j * cond_sum) * u64 + (j + one) * log_err)
        sign_unc = (acond > inv_u64) | (torch.abs(det_sum) < u64 * det_prods)
        return s, serr, sign_unc

    def rel_of(s, cth, serr, scale, sign_unc):
        rel = (torch.abs(s - cth) - serr) * scale
        return torch.where(torch.isfinite(s), rel,
                           torch.where(sign_unc, -inf, inf))

    def start(t):
        return [*chans[t], logdet[t], neg[t], cond[t]]

    # ---- pass A: tentative restart chain (forward) ----
    run = start(0)
    rj = torch.ones((ny, nx), dtype=f32, device=dev)
    tent = [None] * k
    rel_a = [None] * k
    for t in range(1, k):
        x = start(t)
        a = [ri + xi for ri, xi in zip(run, x)]
        j = rj + one
        s, serr, sign_unc = window_stat(*a, j, True)
        f2v = _horner_f32(coefs, torch.sqrt(j) * za + zb)
        scale = one / (f2v * f2_infl)
        for jj, (v, sv) in enumerate(zip(tabs['f2_small'], tabs['s_small'])):
            is_j = j == c(float(jj + 2))
            f2v = torch.where(is_j, c(v), f2v)
            scale = torch.where(is_j, c(sv), scale)
        cth = -f2v
        hit = s < cth
        tent[t] = hit
        rel_a[t] = rel_of(s, cth, serr, scale, sign_unc) - f2_err
        run = [torch.where(hit, xi, ai) for xi, ai in zip(x, a)]
        rj = torch.where(hit, one, j)

    # ---- pass B: global tests per anchor (backward, static j) ----
    run = start(k - 1)
    ghit = [None] * k
    rel_b = [None] * k
    ghit[k - 1] = torch.zeros((ny, nx), dtype=torch.bool, device=dev)
    rel_b[k - 1] = torch.full((ny, nx), np.inf, dtype=f32, device=dev)
    for t in range(k - 2, -1, -1):
        run = [ri + xi for ri, xi in zip(run, start(t))]
        jg = k - t
        cg = tabs['cg_tab'][jg]
        if not np.isfinite(cg):                 # never rejects
            ghit[t] = torch.zeros_like(ghit[k - 1])
            rel_b[t] = torch.full_like(rel_b[k - 1], np.inf)
            continue
        s, serr, sign_unc = window_stat(*run, c(float(jg)), False)
        ghit[t] = s < c(cg)
        rel_b[t] = rel_of(s, c(cg), serr, c(tabs['sg_tab'][jg]), sign_unc)

    # ---- pass C: commit under the cumulative global gate ----
    nplanes = (k + 30) // 31
    packed = torch.zeros((nplanes, ny, nx), dtype=torch.int32, device=dev)
    margin = rel_b[0]
    alive = ghit[0]
    for t in range(1, k):
        margin = torch.minimum(margin, torch.where(alive, rel_a[t], inf))
        commit = alive & tent[t]
        packed[t // 31] += commit.to(torch.int32) << (t % 31)
        margin = torch.minimum(margin, torch.where(commit, rel_b[t], inf))
        alive = torch.where(commit, ghit[t], alive)
    return packed, margin


def _check_length(k):
    if k < 3:
        raise ValueError('the scan needs k >= 3')
    if k > K_SCAN_MAX:
        raise ValueError('series too long for the scan (k=%d > %d)'
                         % (k, K_SCAN_MAX))


def change_detection_scan(values, alpha, n=1, return_packed=False,
                          device=None):
    """Long-series omnibus change detection with decision margins.

    Same decision semantics as :func:`ops.change.change_detection` with
    float32 statistics and polynomial interior thresholds, whose fit
    error is charged to the margin: a pixel whose margin is above the
    caller's eps carries the float64 'mixed' decisions.

    values: (y, x, time, 4) -> ``(flags_or_packed, margin)``: flags
    (y, x, time) bool, or the (P, y, x) int32 planes with
    ``return_packed``, and the (y, x) float32 margin. Float64 input is
    cast to float32. Raises ``ValueError`` for k < 3, k > ``K_SCAN_MAX``
    or an (n, alpha) whose folded thresholds are infeasible
    (:func:`scan_tables` returns None). Non-tensor ``values`` land on
    ``device`` (default ``cuda``).
    """
    values = as_tensor(values, device)
    if values.ndim != 4 or values.shape[3] != 4:
        raise ValueError('values must be (y, x, time, 4)')
    ny, nx, k, _ = values.shape
    _check_length(k)
    tabs = scan_tables(int(k), int(n), float(alpha))
    if tabs is None:
        raise ValueError('folded thresholds infeasible for (k=%d, n=%s, '
                         'alpha=%s)' % (k, n, alpha))
    packed, margin = scan_kernel(values.to(torch.float32).contiguous(),
                                 tabs, float(n))
    result = packed if return_packed else unpack_flags(packed, k)
    return result, margin


def scan_kernel(values, tabs, nf, plan=None):
    """The scan of a contiguous (y, x, k, 4) float32 tensor with the
    tables of :func:`scan_tables` (``nf`` looks): the (P, y, x) int32
    packed planes and the (y, x) float32 margin. A CUDA tensor launches
    the kernel with ``plan`` (one of :func:`plan_candidates`, for tests
    and the plan sweep) or :func:`_scan_plan`; a CPU tensor takes
    :func:`scan_plain`; any other device raises."""
    if values.ndim != 4 or values.shape[3] != 4:
        raise ValueError('values must be (y, x, time, 4)')
    if values.dtype != torch.float32:
        raise TypeError('the scan takes float32, not %s' % values.dtype)
    if not values.is_contiguous():
        raise ValueError('the scan takes a contiguous tensor')
    _check_length(values.shape[2])
    if values.device.type == 'cpu':
        return scan_plain(values, tabs, nf)
    if values.device.type != 'cuda':
        raise ValueError('the scan runs on cuda or cpu tensors, not %s'
                         % values.device)
    return _launch(values, tabs, nf, plan)


# ---- the kernel's plan ------------------------------------------------------

_THREADS = (32, 64, 128, 256)   # pixels (threads) of a block
_CHUNK_STEPS = (3, 5, 7, 15, 31)  # T, and k itself (one chunk)
_ONE_WAVE = SMS * 10 * 128      # pixels resident at once in 128-pixel blocks


def scan_smem(k, threads, T, nbuf):
    """Shared-memory bytes of a block (``scan_smem`` in
    csrc/omnibus_scan.cu): ``nbuf`` chunk buffers of ``threads`` rows at
    a stride of ``T | 1`` 16-byte steps (odd, so a warp's reads of one
    step are free of bank conflicts), the interior thresholds of window
    lengths 0 .. k+1 (16 bytes each) and ``SNAPSHOTS`` floats a pixel
    (pass A's running minimum at its first tentative hits)."""
    return (nbuf * threads * (T | 1) * 16 + (k + 2) * 16
            + SNAPSHOTS * threads * 4)


def _plan(k, npix, threads, T, nbuf):
    T = min(T, k)
    nbuf = min(nbuf, -(-k // T))
    return dict(threads=threads, T=T, nbuf=nbuf,
                smem=scan_smem(k, threads, T, nbuf),
                blocks=-(-npix // threads))


@functools.lru_cache(maxsize=512)
def plan_candidates(k, npix):
    """Every plan of the sweep that fits ``SMEM_MAX``: ``threads`` pixels
    per block, chunks of ``T`` steps (3 to 31 or the whole series), a
    ring of 2 or 3 buffers or one per chunk (the series read from device
    memory once). Returns a tuple of plan dicts."""
    plans = {}
    for threads in _THREADS:
        for T in _CHUNK_STEPS + (k,):
            for nbuf in (2, 3, k):
                p = _plan(k, npix, threads, T, nbuf)
                key = (threads, p['T'], p['nbuf'])
                if p['smem'] <= SMEM_MAX and key not in plans:
                    plans[key] = p
    return tuple(plans.values())


@functools.lru_cache(maxsize=512)
def _scan_plan(k, npix):
    """The kernel's plan for ``npix`` series of ``k`` steps: a dict with
    ``threads`` (the block's pixels, one thread each), ``T`` (steps per
    chunk), ``nbuf`` (chunk buffers), ``smem`` (bytes) and ``blocks``.

    The rule is the forced-plan sweep's (``python -m
    nd_tpu_torch.scan_sweep``; PERF.md, PR 5) on the H100: chunks of 7
    steps through a double buffer at every k it ran (16 to 256; fewer
    steps pay more barriers, more buffers or whole series cost
    residency), 128-pixel blocks where the image fits in about one wave
    of them (10 blocks an SM), 64-pixel blocks for larger images, and
    fewer pixels a block where that leaves under two blocks an SM.
    Cached per (k, npix)."""
    threads = 128 if npix <= _ONE_WAVE else 64
    while threads > 32 and -(-npix // threads) < 2 * SMS:
        threads //= 2
    return _plan(k, npix, threads, 7, 2)


@functools.lru_cache(maxsize=None)
def _setup(device_index):
    """Raise the kernels' dynamic shared-memory limit on one device, once."""
    with torch.cuda.device(device_index):
        _build.check('nd_omnibus_scan_setup',
                     _build.function('nd_omnibus_scan_setup', '')())


_arrays = {}           # id(tables) -> (tables, their float64 arrays)


def _table_arrays(tabs):
    """The tables as float64 arrays for the C entry point, made once per
    :func:`scan_tables` result (hashing its tuples costs more host time
    than building them costs once)."""
    with _build.state_lock:
        hit = _arrays.get(id(tabs))
        if hit is None or hit[0] is not tabs:
            if len(_arrays) >= 64:
                _arrays.clear()
            hit = (tabs, tuple(np.asarray(tabs[name], np.float64)
                               for name in ('f2_coefs', 'f2_small',
                                            's_small', 'cg_tab', 'sg_tab')))
            _arrays[id(tabs)] = hit
    return hit[1]


def _launch(values, tabs, nf, plan=None):
    if values.data_ptr() % 16:
        values = values.clone()      # the kernel loads 16-byte steps
    ny, nx, k, _ = values.shape
    npix = ny * nx
    dev = values.device
    if plan is None:
        plan = _scan_plan(k, npix)
    _setup(dev.index if dev.index is not None
           else torch.cuda.current_device())
    packed = torch.empty(((k + 30) // 31, ny, nx), dtype=torch.int32,
                         device=dev)
    margin = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    coefs, small, s_small, cg, sg = _table_arrays(tabs)
    fn = _build.function('nd_omnibus_scan_f32', 'pppqiiiipippippdddddp')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values.data_ptr(), packed.data_ptr(), margin.data_ptr(),
                 npix, k, plan['threads'], plan['T'], plan['nbuf'],
                 coefs.ctypes.data, len(coefs),
                 small.ctypes.data, s_small.ctypes.data, len(small),
                 cg.ctypes.data, sg.ctypes.data, tabs['f2_rel_err'],
                 1.0 + tabs['f2_rel_err'], tabs['za'], tabs['zb'], nf,
                 stream)
    _build.bump(globals(), 'launches')
    _build.check('nd_omnibus_scan_f32', err)
    return packed, margin
