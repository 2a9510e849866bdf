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
pixels whose margin is not above its eps. On the H100 the kernel is
bound by arithmetic: one thread per pixel, O(k) work. See the source for
the design.

``change_detection_scan`` runs the kernel for a CUDA tensor and the
plain version for a CPU tensor; for any other device it raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..core.variable import as_tensor
from .change import _P, omnibus_rho, omnibus_thresholds
from .change_cuda import _mlog, unpack_flags

__all__ = ['change_detection_scan', 'scan_plain', 'scan_tables',
           'K_SCAN_MAX', 'launches']

K_SCAN_MAX = 256       # kMaxK in csrc/omnibus_scan.cu
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
    values = values.to(torch.float32).contiguous()
    if values.device.type == 'cpu':
        packed, margin = scan_plain(values, tabs, float(n))
    elif values.device.type == 'cuda':
        packed, margin = _launch(values, tabs, float(n))
    else:
        raise ValueError('change_detection_scan runs on cuda or cpu '
                         'tensors, not %s' % values.device)
    result = packed if return_packed else unpack_flags(packed, k)
    return result, margin


def _launch(values, tabs, nf):
    if values.data_ptr() % 16:
        values = values.clone()      # the kernel loads 16-byte steps
    ny, nx, k, _ = values.shape
    npix = ny * nx
    dev = values.device
    packed = torch.empty(((k + 30) // 31, ny, nx), dtype=torch.int32,
                         device=dev)
    margin = torch.empty((ny, nx), dtype=torch.float32, device=dev)
    rel_b = torch.empty((k, npix), dtype=torch.float32, device=dev)
    coefs = np.asarray(tabs['f2_coefs'], np.float64)
    small = np.asarray(tabs['f2_small'], np.float64)
    s_small = np.asarray(tabs['s_small'], np.float64)
    cg = np.asarray(tabs['cg_tab'], np.float64)
    sg = np.asarray(tabs['sg_tab'], np.float64)
    fn = _build.function('nd_omnibus_scan_f32', 'ppppqipippippdddddp')
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(values.data_ptr(), packed.data_ptr(), margin.data_ptr(),
                 rel_b.data_ptr(), npix, k, coefs.ctypes.data, len(coefs),
                 small.ctypes.data, s_small.ctypes.data, len(small),
                 cg.ctypes.data, sg.ctypes.data, tabs['f2_rel_err'],
                 1.0 + tabs['f2_rel_err'], tabs['za'], tabs['zb'], nf,
                 stream)
    global launches
    launches += 1
    _build.check('nd_omnibus_scan_f32', err)
    return packed, margin
