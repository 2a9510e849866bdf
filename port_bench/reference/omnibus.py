"""The complex-Wishart omnibus change test in plain PyTorch.

Conradsen, Nielsen and Skriver (2016), IEEE TGRS 54(5): the test of
equal covariance over a window of ``j`` dual-pol (p = 2) covariance
matrices with ``n`` looks, ``-2 rho ln Q`` against the two-term chi-square
approximation, decided as ``P(z) > alpha`` (``OmnibusTest``'s reading of
``alpha``). Each pixel's series is scanned from the anchor ``l = 0``: the
first window ``[l, t]`` (``t >= l + 1``) whose test rejects sets the
change point ``t``, and the scan restarts there while the whole rest of
the series ``[l, k - 1]`` rejects.

Precision, as ``OmnibusTest`` states it: the multilook in float32, the
channel sums of a window in the input's float32, added strictly left to
right, and the determinants' logs, the statistic and the decision in
float64 (the 'mixed' scan). One step below each, the control: the
multilook in bfloat16, the sums, the statistic and the decision in
float32 (``looks=torch.bfloat16, stat='float32'``).

This is a frozen copy of the port's plain versions (the boxcar passes,
the threshold bisection, the scan) with nothing imported from the port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['multilook', 'thresholds', 'decision_table', 'scan',
           'change_map', 'VARIABLES']

VARIABLES = ('C11', 'C12__re', 'C12__im', 'C22')
_P = 2.0            # dual-pol covariance matrices are 2 x 2


def _symmetric_pad(x, axis, p):
    """Pad ``axis`` by ``p`` on both sides, the edge sample repeated
    (scipy.ndimage 'reflect')."""
    n = x.shape[axis]
    idx = list(range(p - 1, -1, -1)) + list(range(n)) \
        + list(range(n - 1, n - 1 - p, -1))
    return x.index_select(axis, torch.tensor(idx, device=x.device))


def multilook(variables, ml, dtype=torch.float32):
    """The ``ml x ml`` boxcar over (y, x) of each (y, x, time) variable:
    the rows summed left to right and scaled once by ``1/ml**2`` rounded
    to ``dtype``, then the columns summed left to right (the add order
    ``BoxcarFilter`` states for float32), in ``dtype``. Returns (y, x,
    time, 4)."""
    p = (ml - 1) // 2
    scale = torch.tensor(1.0 / ml ** 2, dtype=dtype)
    out = []
    for v in VARIABLES:
        x = _symmetric_pad(_symmetric_pad(variables[v].to(dtype), 0, p),
                           1, p)
        ny = x.shape[0] - ml + 1
        acc = x.narrow(0, 0, ny)
        for u in range(1, ml):
            acc = acc + x.narrow(0, u, ny)
        acc = acc * scale.to(acc.device)
        nx = acc.shape[1] - ml + 1
        col = acc.narrow(1, 0, nx)
        for u in range(1, ml):
            col = col + acc.narrow(1, u, nx)
        out.append(col)
    return torch.stack(out, -1)


def _rho(j, n):
    j = np.asarray(j, np.float64)
    return 1 - (2 * _P ** 2 - 1) / (6 * (j - 1) * _P) * (j / n - 1 / (n * j))


def thresholds(k, n, alpha):
    """z-thresholds per window length j (index 0..k; +inf below 2): the
    z with ``P(z) = alpha``, by bisection in float64 on the host."""
    from scipy.stats import chi2
    out = np.full(k + 1, np.inf)
    for j in range(2, k + 1):
        rho = float(_rho(j, n))
        f = (j - 1) * _P ** 2
        omega2 = (_P ** 2 * (_P ** 2 - 1) / (24 * rho ** 2)
                  * (j / n ** 2 - 1 / (n * j) ** 2)
                  - _P ** 2 * (j - 1) / 4 * (1 - 1 / rho) ** 2)

        def prob(z):
            p1 = chi2.cdf(z, f)
            return p1 + omega2 * (chi2.cdf(z, f + 4) - p1)

        lo, hi = 0.0, 1.0
        while prob(hi) <= alpha and hi < 1e12:
            hi *= 2
        if prob(hi) <= alpha:
            continue
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if prob(mid) > alpha:
                hi = mid
            else:
                lo = mid
        out[j] = hi
    return out


def decision_table(k, n, alpha, folded):
    """(folded, table). Folded (float64, rho > 0 wherever a threshold is
    finite): reject where ``n log_prod - n j ln det_sum < C(j)``,
    ``C(j) = -z*(j) / (2 rho(j)) - n p j ln j``; otherwise the table is
    the z-thresholds and the statistic is evaluated whole."""
    z = thresholds(k, n, alpha)
    if not folded:
        return False, z
    with np.errstate(divide='ignore', invalid='ignore'):
        rho = _rho(np.arange(k + 1), n)
    table = np.full(k + 1, -np.inf)
    for j in range(2, k + 1):
        if np.isfinite(z[j]):
            if rho[j] <= 0:
                return False, z
            table[j] = -z[j] / (2 * rho[j]) - n * _P * j * np.log(j)
    return True, table


def scan(values, alpha, n, stat='mixed'):
    """Change points of a (y, x, time, 4) cube: (y, x, time) bool."""
    sdtype = values.dtype if stat == 'mixed' else torch.float32
    ldtype = torch.float64 if stat == 'mixed' else torch.float32
    ny, nx, k, _ = values.shape
    dev = values.device
    nf = float(n)
    chans = [values[..., c].to(sdtype) for c in range(4)]
    dets = chans[0] * chans[3] - chans[1] * chans[1] - chans[2] * chans[2]
    logdet_t = torch.log(torch.abs(dets).to(ldtype))
    neg_t = (dets < 0).to(sdtype)
    folded, table = decision_table(k, nf, float(alpha),
                                   ldtype == torch.float64)
    tab = torch.tensor(table, dtype=ldtype, device=dev)

    l = torch.zeros((ny, nx), dtype=torch.int64, device=dev)
    active = torch.ones((ny, nx), dtype=torch.bool, device=dev)
    result = torch.zeros((ny, nx, k), dtype=torch.bool, device=dev)
    zero_s = torch.zeros((), dtype=sdtype, device=dev)
    zero_l = torch.zeros((), dtype=ldtype, device=dev)
    for _ in range(max(k - 1, 0)):
        if not bool(active.any()):
            break
        sums = [torch.zeros((ny, nx), dtype=sdtype, device=dev)
                for _ in range(5)]
        sld = torch.zeros((ny, nx), dtype=ldtype, device=dev)
        t_first = torch.full((ny, nx), k, dtype=torch.int64, device=dev)
        hit_last = None
        for t in range(k):
            m = t >= l
            for c in range(4):
                sums[c] = sums[c] + torch.where(m, chans[c][..., t], zero_s)
            sums[4] = sums[4] + torch.where(m, neg_t[..., t], zero_s)
            sld = sld + torch.where(m, logdet_t[..., t], zero_l)
            if t == 0:
                continue
            c11, c12r, c12i, c22 = (s.to(ldtype) for s in sums[:4])
            odd = (sums[4].to(torch.int32) % 2) == 1
            j_i = t - l + 1
            j = j_i.to(ldtype)
            det_sum = c11 * c22 - c12r * c12r - c12i * c12i
            log_prod = torch.where(odd, torch.full_like(sld, np.nan), sld)
            row = tab[j_i.clamp(0, k)]
            if folded:
                hit = nf * log_prod - (nf * j) * torch.log(det_sum) < row
            else:
                logq = nf * (_P * j * torch.log(j) + log_prod
                             - j * torch.log(det_sum))
                rho = 1 - (2 * _P ** 2 - 1) / (6 * (j - 1) * _P) \
                    * (j / nf - 1 / (nf * j))
                hit = -2 * rho * logq > row
            hit = hit & (t >= l + 1)
            t_first = torch.where(hit & (t_first == k),
                                  torch.full_like(t_first, t), t_first)
            if t == k - 1:
                hit_last = hit
        if hit_last is None:
            break
        active = active & hit_last
        any_hit = t_first < k
        pos = torch.maximum(torch.where(any_hit, t_first,
                                        torch.full_like(t_first, k - 1)),
                            l + 1)
        upd = torch.zeros_like(result)
        upd.scatter_(2, pos.clamp_max(k - 1)[..., None],
                     (active & any_hit)[..., None])
        result = result | upd
        l = torch.where(active, pos, l)
        active = active & (l < k - 1)
    return result


def change_map(variables, ml, alpha, stat='mixed', looks=torch.float32):
    """``OmnibusTest(ml, alpha)`` of a dict of (y, x, time) float32
    variables: the multilook in ``looks``, then the scan with
    ``n = ml**2`` looks and ``stat`` statistics."""
    return scan(multilook(variables, ml, looks), alpha, ml ** 2, stat)
