"""Complex-Wishart omnibus change detection (Conradsen et al. 2016).

Counterpart of ``nd_tpu/ops/change.py``. Every pixel's series is
scanned for change points: per restart anchor ``l``, running sums of
the series from ``l`` give the statistics of every window [l, t]; the
chi-square decision ``P(z) > alpha`` is a z-threshold compare per window
length, with the thresholds solved on the host in float64; each active
pixel jumps to its first significant change point.

Two routes:

  - :func:`change_detection`: the scan with 'mixed' (channel sums in the
    input precision, determinant/log/decision in float64 — the exact
    reference decisions), float32 or float64 statistics. On a CUDA
    tensor it runs the ``omnibus_mixed`` kernel
    (``ops/change_mixed_cuda.py``), or for float32 statistics at
    k <= 48 the round kernel ``omnibus``, as the reference sends them to
    its fused kernel; on a CPU tensor it runs the plain version,
    :func:`change_detection_plain`;
  - :func:`change_detection_exact`: a float32 kernel reports each
    pixel's decision margin — the round kernel ``omnibus``
    (``ops/change_cuda.py``) for k <= 48, the sequential scan
    ``omnibus_scan`` (``ops/change_scan_cuda.py``) for 48 < k <= 256;
    the pixels whose margin is not above ``margin_eps`` (NaN included)
    are rescanned with the float64 'mixed' scan, selected on the card
    and written straight into the packed flags
    (``ops/change_mixed_cuda.py`` ``rescan``). Longer series take the
    'mixed' scan whole. The decisions equal the 'mixed' scan's;
    :func:`change_detection_hybrid` is the exact mode with numpy
    delivery (the bool map crosses to the host).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.variable import as_tensor
from ..tracing import count, span
from .stats import chi2_cdf

__all__ = ['omnibus_probabilities', 'omnibus_rho', 'omnibus_thresholds',
           'decision_tables',
           'change_detection', 'change_detection_plain',
           'change_detection_exact', 'change_detection_hybrid',
           'pack_flags', 'omnibus_z']

_P = 2.0  # dual-pol covariance matrices are 2x2


def omnibus_rho(j, n):
    """rho coefficient per window length (host-side, float64)."""
    j = np.asarray(j, np.float64)
    return 1 - (2 * _P ** 2 - 1) / (6 * (j - 1) * _P) \
        * (j / n - 1 / (n * j))


def omnibus_z(ts, n, device=None):
    """-2 rho logQ statistic over a full (k, 4) series, for testing and
    inspection (the JAX package's ``omnibus_z``)."""
    ts = as_tensor(ts, device)
    k = ts.shape[0]
    dets = ts[:, 0] * ts[:, 3] - ts[:, 1] ** 2 - ts[:, 2] ** 2
    sums = ts.sum(0)
    det_of_sum = sums[0] * sums[3] - sums[1] ** 2 - sums[2] ** 2
    log_prod = torch.log(dets.abs()).sum()
    log_prod = torch.where(torch.prod(torch.sign(dets)) > 0, log_prod,
                           float('nan'))
    logQ = n * (_P * k * np.log(float(k)) + log_prod
                - k * torch.log(det_of_sum))
    return -2 * float(omnibus_rho(k, n)) * logQ


def _window_probability(csum, logdet, negcnt, j, n, dtype):
    """Omnibus probability for windows of length ``j`` given interval
    sums. All arguments broadcast; ``j`` is a float or a tensor. The
    coefficients of a scalar ``j`` are 0-d CPU tensors of ``dtype``, so
    they round as the JAX package's 0-d arrays do and ride into the
    device's kernels as scalars."""
    c11, c12r, c12i, c22 = csum
    det_of_sum = c11 * c22 - c12r ** 2 - c12i ** 2
    k = torch.as_tensor(j, dtype=dtype)
    log_prod = torch.where(negcnt % 2 == 0, logdet, float('nan'))
    logQ = n * (_P * k * torch.log(k) + log_prod
                - k * torch.log(det_of_sum))
    rho = 1 - (2 * _P ** 2 - 1) / (6 * (k - 1) * _P) \
        * (k / n - 1 / (n * k))
    z = -2 * rho * logQ
    f = (k - 1) * _P ** 2
    omega2 = (_P ** 2 * (_P ** 2 - 1) / (24 * rho ** 2)
              * (k / n ** 2 - 1 / (n * k) ** 2)
              - _P ** 2 * (k - 1) / 4 * (1 - 1 / rho) ** 2)
    P1 = chi2_cdf(z, f)
    P2 = chi2_cdf(z, f + 4)
    return P1 + omega2 * (P2 - P1)


def omnibus_probabilities(values, n=1, device=None):
    """Omnibus probability of the full series per pixel.

    values: (..., time, 4) -> probability (...,), in ``values``' dtype
    and on its device (numpy input lands on ``device``, by default
    ``cuda``). A negative product of determinants, or a negative
    determinant of the sum, gives NaN, as in the JAX package.
    """
    values = as_tensor(values, device)
    k = values.shape[-2]
    dets = (values[..., 0] * values[..., 3]
            - values[..., 1] ** 2 - values[..., 2] ** 2)
    csum = tuple(values[..., c].sum(dim=-1) for c in range(4))
    logdet = torch.log(dets.abs()).sum(dim=-1)
    negcnt = (dets < 0).to(torch.int32).sum(dim=-1)
    return _window_probability(csum, logdet, negcnt, float(k), float(n),
                               values.dtype)


def omnibus_thresholds(k, n, alpha):
    """Per-window-length z-thresholds equivalent to ``P(z) > alpha``.

    P(z) = P1 + omega2 (P2 - P1) depends on the pixel only through z,
    so ``P(z) > alpha`` is ``z > z*(j)`` with z*(j) solved once on the
    host by bisection in float64. Returns an array of length k+1;
    entries j < 2 are +inf. Solved once per (k, n, alpha) and cached:
    the bisection costs about as much host time as a whole scan of a
    megapixel cube on the card.
    """
    return _thresholds(int(k), float(n), float(alpha)).copy()


@functools.lru_cache(maxsize=64)
def _thresholds(k, n, alpha):
    from scipy.stats import chi2 as _chi2
    out = np.full(k + 1, np.inf)
    for j in range(2, k + 1):
        rho = float(omnibus_rho(j, n))
        f = (j - 1) * _P ** 2
        omega2 = (_P ** 2 * (_P ** 2 - 1) / (24 * rho ** 2)
                  * (j / n ** 2 - 1 / (n * j) ** 2)
                  - _P ** 2 * (j - 1) / 4 * (1 - 1 / rho) ** 2)

        def prob(z):
            p1 = _chi2.cdf(z, f)
            p2 = _chi2.cdf(z, f + 4)
            return p1 + omega2 * (p2 - p1)

        lo, hi = 0.0, 1.0
        while prob(hi) <= alpha and hi < 1e12:
            hi *= 2
        if prob(hi) <= alpha:
            out[j] = np.inf
            continue
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if prob(mid) > alpha:
                hi = mid
            else:
                lo = mid
        out[j] = hi
    return out


_DTYPES = {'float32': torch.float32, 'float64': torch.float64,
           torch.float32: torch.float32, torch.float64: torch.float64}


def stat_types(stat_dtype, dtype):
    """(sum dtype, log dtype) of the scan for ``stat_dtype`` and input
    ``dtype``: 'mixed' sums in the input precision and runs the
    determinant/log/decision math in float64; 'float32' and 'float64'
    run everything in that type."""
    if stat_dtype == 'mixed':
        return dtype, torch.float64
    if stat_dtype in _DTYPES:
        return _DTYPES[stat_dtype], _DTYPES[stat_dtype]
    raise ValueError('stat_dtype must be mixed, float32 or float64, not %r'
                     % (stat_dtype,))


def decision_tables(k, n, alpha, log_dtype):
    """Per-window-length decision tables of the scan, shared by the plain
    version and the ``omnibus_mixed`` kernel: ``(use_folded, table)``
    with ``table`` a read-only float64 array of length k+1 indexed by
    the window length j.

    Folded (float64 log type, and rho(j) > 0 wherever the threshold is
    finite): the decision z > thr(j) is
    ``n log_prod - n j ln det_sum < C(j)``,
    ``C(j) = -thr(j)/(2 rho(j)) - n P j ln j`` (-inf: never hits).
    Otherwise the table is the z-thresholds themselves (+inf: never
    hits) and the caller evaluates z. Solved on the host in float64 and
    cached per (k, n, alpha, log dtype)."""
    return _decision_tables(int(k), float(n), float(alpha),
                            log_dtype == torch.float64)


@functools.lru_cache(maxsize=64)
def _decision_tables(k, n, alpha, log_f64):
    z_thresh = _thresholds(k, n, alpha)
    with np.errstate(divide='ignore', invalid='ignore'):
        rho_tab = omnibus_rho(np.arange(k + 1), n)
    folded = np.full(k + 1, -np.inf)
    use_folded = log_f64
    for j in range(2, k + 1):
        if np.isfinite(z_thresh[j]):
            if rho_tab[j] <= 0:
                use_folded = False
                break
            folded[j] = (-z_thresh[j] / (2 * rho_tab[j])
                         - n * _P * j * np.log(j))
    table = folded if use_folded else z_thresh.copy()
    table.flags.writeable = False
    return use_folded, table


def change_detection(values, alpha, n=1, stat_dtype='mixed', device=None):
    """Iterative omnibus change-point detection.

    Parameters
    ----------
    values : torch.Tensor, shape (y, x, time, 4)
        Covariance channels [C11, C12.re, C12.im, C22] per time step
        (already multilooked with ``n`` looks).
    alpha : float
        Decision threshold on the chi-square probability.
    n : int
        Number of looks.
    stat_dtype : 'mixed', 'float32' or 'float64', optional
        Statistic precision. 'mixed' (default) accumulates the channel
        sums in the input precision and runs the determinant/log/
        decision math in float64 — the exact reference decisions. The
        running sums accumulate strictly left to right (one addition
        per time step), so the decisions are a function of each pixel's
        series alone, whatever the batch shape or device.
    device : torch.device or str, optional
        Where non-tensor ``values`` land (default ``cuda``); a tensor
        stays on its device.

    On a CUDA tensor the scan is the ``omnibus_mixed`` kernel, except
    that float32 statistics at k <= ``change_cuda.K_MAX`` take the round
    kernel (uncapped, no margins), as the reference sends them to its
    fused kernel on its accelerator. On a CPU tensor it is the plain
    version, :func:`change_detection_plain`; any other device raises.

    Returns
    -------
    bool tensor, shape (y, x, time), on ``values``' device
    """
    values = as_tensor(values, device)
    if not values.is_floating_point():
        values = values.to(torch.float32)
    _, ldtype = stat_types(stat_dtype, values.dtype)
    if values.ndim != 4 or values.shape[3] != 4:
        raise ValueError('values must be (y, x, time, 4)')
    if values.device.type == 'cpu':
        return change_detection_plain(values, alpha, n, stat_dtype)
    if values.device.type != 'cuda':
        raise ValueError('change_detection runs on cuda or cpu tensors, '
                         'not %s' % values.device)
    from .change_cuda import K_MAX, change_detection_fast, unpack_flags
    from .change_mixed_cuda import mixed_scan
    ny, nx, k, _ = values.shape
    if ldtype == torch.float32 and k <= K_MAX:
        return change_detection_fast(values, alpha, n=n)
    planes = mixed_scan(values.reshape(ny * nx, k, 4).contiguous(), alpha,
                        n, stat_dtype)
    return unpack_flags(planes.view(-1, ny, nx), k)


def change_detection_plain(values, alpha, n=1, stat_dtype='mixed'):
    """The scan in PyTorch operations over a (y, x, time, 4) float
    tensor, on its device: the plain version of the ``omnibus_mixed``
    kernel, and the route of :func:`change_detection` for CPU tensors.
    Per restart round, running sums from the anchor l (strictly left to
    right) give every window's statistic; each active pixel jumps to
    its first significant change point. Returns (y, x, time) bool."""
    sdtype, ldtype = stat_types(stat_dtype, values.dtype)
    ny, nx, k, _ = values.shape
    dev = values.device
    nf = float(n)

    chans = [values[..., c].to(sdtype) for c in range(4)]   # (y, x, k)
    dets = chans[0] * chans[3] - chans[1] * chans[1] - chans[2] * chans[2]
    logdet_t = torch.log(torch.abs(dets).to(ldtype))
    neg_t = (dets < 0).to(sdtype)

    # per-length table indexed by window length j (0..k)
    use_folded, table = decision_tables(k, n, alpha, ldtype)
    tab = torch.tensor(table, dtype=ldtype, device=dev)

    l = torch.zeros((ny, nx), dtype=torch.int64, device=dev)
    active = torch.ones((ny, nx), dtype=torch.bool, device=dev)
    result = torch.zeros((ny, nx, k), dtype=torch.bool, device=dev)
    zero_s = torch.zeros((), dtype=sdtype, device=dev)
    zero_l = torch.zeros((), dtype=ldtype, device=dev)
    big = torch.full((), k, dtype=torch.int64, device=dev)
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
            odd_neg = (sums[4].to(torch.int32) % 2) == 1
            jt_i = t - l + 1
            jt = jt_i.to(ldtype)
            det_of_sum = c11 * c22 - c12r * c12r - c12i * c12i
            log_prod = torch.where(odd_neg, torch.full_like(sld, np.nan),
                                   sld)
            j_idx = jt_i.clamp(0, k)
            if use_folded:
                stat = nf * log_prod - (nf * jt) * torch.log(det_of_sum)
                hit = stat < tab[j_idx]
            else:
                logq = nf * (_P * jt * torch.log(jt) + log_prod
                             - jt * torch.log(det_of_sum))
                rho_t = 1 - (2 * _P ** 2 - 1) / (6 * (jt - 1) * _P) \
                    * (jt / nf - 1 / (nf * jt))
                z = -2 * rho_t * logq
                hit = z > tab[j_idx]
            hit = hit & (t >= l + 1)                      # j >= 2
            t_first = torch.where(hit & (t_first == k),
                                  torch.full_like(t_first, t), t_first)
            if t == k - 1:
                hit_last = hit
        if hit_last is None:
            break
        # global test over ts[l:] is the t = k-1 window
        active = active & hit_last
        any_hit = t_first < big
        pos = torch.where(any_hit, t_first, big - 1)
        pos = torch.maximum(pos, l + 1)
        set_mask = active & any_hit
        upd = torch.zeros_like(result)
        upd.scatter_(2, pos.clamp_max(k - 1)[..., None], set_mask[..., None])
        result = result | upd
        l = torch.where(active, pos, l)
        active = active & (l < k - 1)
    return result


def pack_flags(flags):
    """(..., k) bool -> (ceil(k/31), ...) int32 bit-packed planes (bit
    t%31 of plane t//31 = flag at time t)."""
    k = flags.shape[-1]
    planes = []
    for pp in range((k + 30) // 31):
        nb = min(31, k - 31 * pp)
        weights = torch.as_tensor(2 ** np.arange(nb), dtype=torch.int32,
                                  device=flags.device)
        planes.append((flags[..., 31 * pp:31 * pp + nb].to(torch.int32)
                       * weights).sum(-1, dtype=torch.int32))
    return torch.stack(planes)


def _exact_packed(values, alpha, n, margin_eps):
    """Kernel pass with margins + float64 'mixed' rescan of the suspect
    pixels. Series up to ``K_MAX`` take the round kernel with the round
    cap, longer ones the sequential scan (no rounds, polynomial interior
    thresholds whose fit error rides the margins). The rescan selects
    the suspects on the card and writes into the planes (no host sync).
    Returns the (P, y, x) int32 packed planes and the suspect count as a
    1-element int32 tensor on ``values``' device."""
    from .change_cuda import K_MAX, _round_cap, change_detection_fast
    from .change_mixed_cuda import rescan
    ny, nx, k, _ = values.shape
    with span('omnibus.kernel'):
        if k <= K_MAX:
            packed, margin = change_detection_fast(
                values, alpha, n=n, return_margin=True, return_packed=True,
                max_rounds=_round_cap(k))
        else:
            from .change_scan_cuda import change_detection_scan
            packed, margin = change_detection_scan(values, alpha, n=n,
                                                   return_packed=True)
    with span('omnibus.rescan'):
        suspects = rescan(values.reshape(ny * nx, k, 4), margin, packed,
                          alpha, n, margin_eps)
    return packed, suspects


def change_detection_exact(values, alpha, n=1, margin_eps=1e-4,
                           capacity=None, return_count=False, device=None):
    """Exact change detection: the decisions of ``change_detection(...,
    stat_dtype='mixed')`` at about the kernels' cost.

    A kernel reports each pixel's smallest relative decision margin,
    already net of a conservative f32 error bound (determinant
    conditioning with a 64x safety factor on unit roundoff, plus 1e-5
    per log evaluation, plus the long-series scan's threshold fit
    error). Series of up to 48 steps take the round kernel, which caps
    the restart rounds at ``max(4, k // 4)`` and gives still-active
    pixels margin -inf; series of 49 to 256 steps take the sequential
    scan. Pixels whose margin is not above ``margin_eps`` — the only
    ones whose f32 decisions could differ from float64, NaN included —
    are rescanned with the float64 'mixed' scan, reading the input in
    its own dtype: on a CUDA tensor the ``omnibus_mixed`` kernels select
    them on the card and write their flags straight into the planes, so
    the host waits for nothing (the count is read back only with
    ``return_count``).

    Series longer than 256 steps, and (n, alpha) whose folded scan
    thresholds are infeasible, take the full-grid float64 'mixed' scan
    instead (``change_cuda.supports_rescan``; on a CUDA tensor the
    ``omnibus_mixed`` kernel over every pixel), as the reference does;
    every pixel then counts as rescanned.

    This is the logic of the reference's ``change_detection_exact`` and
    ``change_detection_hybrid`` alike. Every suspect is rescanned: their
    fixed-capacity compaction and its overflow branch (a full-grid
    'mixed' rerun) existed for jit's static shapes and are not needed
    here. The decisions are the same.

    Returns a (y, x, time) bool tensor on ``values``' device (and the
    suspect count with ``return_count``). Non-tensor ``values`` land on
    ``device`` (default ``cuda``). ``capacity`` is accepted for the
    reference's signature and unused: every suspect is rescanned.
    """
    from .change_cuda import supports_rescan, unpack_flags
    del capacity
    values = as_tensor(values, device)
    if not values.is_floating_point():
        values = values.to(torch.float32)
    ny, nx, k, _ = values.shape
    count('omnibus.pixels', ny * nx)
    if not supports_rescan(k, n, alpha):
        count('omnibus.rescanned', ny * nx)
        flags = change_detection(values, alpha, n=n, stat_dtype='mixed')
        return (flags, ny * nx) if return_count else flags
    packed, suspects = _exact_packed(values.contiguous(), alpha, n,
                                     margin_eps)
    count('omnibus.rescanned', suspects)
    with span('omnibus.unpack'):
        flags = unpack_flags(packed, k)
    return (flags, int(suspects)) if return_count else flags


def change_detection_hybrid(values, alpha, n=1, margin_eps=1e-4,
                            nthreads=0, values_host=None,
                            return_device=False, capacity=None,
                            device=None):
    """The exact mode with the JAX package's delivery: numpy in, a numpy
    (y, x, time) bool map out (``OmnibusTest``'s route for host-resident
    input there).

    The decisions are :func:`change_detection_exact`'s (a float32 kernel
    with margins, then the float64 rescan of the near-margin pixels on
    ``values``' device), copied to the host as a bool array; with
    ``return_device`` the bool tensor stays on the device instead.

    ``nthreads``, ``values_host`` and ``capacity`` are accepted for the
    JAX package's signature and unused: its ``ND_TPU_X64=0`` route (the
    suspects patched on the host by the native float64 kernel, when JAX
    runs without float64) does not exist in the port, which has no
    global x64 switch and always rescans in float64 on the device; and
    every suspect is rescanned, so there is no capacity. Non-tensor
    ``values`` land on ``device`` (default ``cuda``).
    """
    del nthreads, values_host, capacity
    flags = change_detection_exact(values, alpha, n=n, margin_eps=margin_eps,
                                   device=device)
    return flags if return_device else flags.cpu().numpy()
