"""Non-local means denoising.

Counterpart of ``nd_tpu/ops/nlmeans.py``: 'reflect' (edge-excluding)
boundary, weight ``exp(-max(dsq/dsq_norm - 2 sigma^2, 0)/h^2)`` with
``dsq_norm = nvars * prod(2f+1)``, self-weight = max weight (or the
``n_eff`` effective-sample-size solution).

On a CUDA tensor every window runs through the ``nlmeans`` CUDA kernel
(``ops/nlmeans_cuda.py``): spatial windows (``r[2] = f[2] = 0``) through
``nlmeans_spatial``, temporal and full 3-D windows through
``nlmeans_3d``. ``nlmeans_plain`` is the plain version, in the kernel's
order: one pass per unordered offset pair with shifted squared
differences, separable ``(2f+1)`` patch sums and both directions of the
pair added from one weight plane.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.variable import as_tensor
from ..tracing import span
from .conv import pad_reflect

__all__ = ['nlmeans', 'nlmeans_plain', 'find_weight_vectorized']


def find_weight_vectorized(weight_sum, sq_weight_sum, n):
    """Self-weight w such that the effective sample size equals n.

    Pixels with no solution (n - 1 > weight_sum^2 / sq_weight_sum)
    yield NaN instead of raising.
    """
    disc = (n * weight_sum * weight_sum - n * n * sq_weight_sum
            + n * sq_weight_sum)
    return (weight_sum + torch.sqrt(disc)) / (n - 1)


def _check_pads(shape, r, f):
    for i in range(3):
        pad = r[i] + f[i]
        if pad >= shape[i] and pad > 0:
            raise ValueError(
                'r + f (%d) must be smaller than dim %d size (%d)'
                % (pad, i, shape[i]))


def _block(x, start, size):
    return x[start[0]:start[0] + size[0], start[1]:start[1] + size[1],
             start[2]:start[2] + size[2]]


def _box(x, k, axis):
    """Sum of ``k`` consecutive samples along ``axis`` ('valid'), added
    left to right: the kernel's patch-sum order."""
    n = x.shape[axis] - k + 1
    acc = x.narrow(axis, 0, n)
    for u in range(1, k):
        acc = acc + x.narrow(axis, u, n)
    return acc


def nlmeans_plain(arr, r, f, sigma, h, n_eff=-1.0):
    """Plain PyTorch NLMeans of a ``(d0, d1, d2, var)`` tensor with a
    3-d window (``r``/``f`` per axis), in the kernel's order: each
    unordered offset pair ``D > 0`` (row-major over (d0, d1, d2)) once,
    its squared differences summed over the variables, the patch sum as
    separable passes over d2, then d0, then d1, one weight per
    D-extended position, then the forward weight (pair ``(o, o+D)``)
    and the backward one (``(o-D, o)``) added at each output."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    D = tuple(arr.shape[:3])
    nvars = arr.shape[3]
    _check_pads(D, r, f)
    pad = tuple(ri + fi for ri, fi in zip(r, f))
    # numpy 'reflect' (edge excluded) is scipy's 'mirror'
    P = pad_reflect(arr, [(p, p) for p in pad] + [(0, 0)], mode='mirror')
    half = [off for off in itertools.product(
        *[range(-ri, ri + 1) for ri in r]) if off > (0, 0, 0)]
    if not half:
        return arr

    dtype, dev = arr.dtype, arr.device
    dsq_norm = torch.tensor(float(nvars * np.prod([2 * fi + 1 for fi in f])),
                            dtype=dtype, device=dev)
    two_sigma2 = torch.tensor(2.0 * float(sigma) ** 2, dtype=dtype,
                              device=dev)
    inv_h2 = torch.tensor(1.0 / float(h) ** 2, dtype=dtype, device=dev)

    center = _block(P, pad, D)
    wsum = torch.zeros(D, dtype=dtype, device=dev)
    wsq = torch.zeros_like(wsum)
    wmax = torch.zeros_like(wsum)
    out = torch.zeros_like(center)
    for d in half:
        # left pixels q of the pairs (q, q+D): o (forward) and o-D
        # (backward), per axis [lo, lo + D + |d|) with lo = -max(d, 0),
        # widened by f for the patch
        lo = tuple(-max(di, 0) for di in d)
        ext = tuple(n + abs(di) for n, di in zip(D, d))
        start = tuple(p + l - fi for p, l, fi in zip(pad, lo, f))
        size = tuple(e + 2 * fi for e, fi in zip(ext, f))
        diff = _block(P, start, size) - _block(
            P, tuple(s + di for s, di in zip(start, d)), size)
        sq = diff[..., 0] * diff[..., 0]
        for v in range(1, nvars):
            sq = sq + diff[..., v] * diff[..., v]
        patch = _box(_box(_box(sq, 2 * f[2] + 1, 2), 2 * f[0] + 1, 0),
                     2 * f[1] + 1, 1)
        w_ext = torch.exp(-torch.clamp_min(patch / dsq_norm - two_sigma2, 0)
                          * inv_h2)
        for sgn in (1, -1):
            # forward: q = o; backward: q = o - D
            s0 = tuple(-l - (0 if sgn > 0 else di) for l, di in zip(lo, d))
            w = _block(w_ext, s0, D)
            vals = _block(P, tuple(p + sgn * di for p, di in zip(pad, d)),
                          D)
            wsum = wsum + w
            if n_eff >= 0:
                wsq = wsq + w * w
            else:
                wmax = torch.maximum(wmax, w)
            out = out + w[..., None] * vals

    if n_eff < 0:
        w_self = torch.where(wmax == 0, torch.ones_like(wmax), wmax)
    else:
        w_self = find_weight_vectorized(
            wsum, wsq, torch.tensor(float(n_eff), dtype=dtype, device=dev))
    total = wsum + w_self
    return (out + w_self[..., None] * center) / total[..., None]


def nlmeans(arr, r, f, sigma, h, n_eff=-1.0, device=None):
    """Non-local means over a 4-D ``(d0, d1, d2, var)`` tensor.

    Parameters
    ----------
    arr : torch.Tensor, shape (d0, d1, d2, nvars)
        Filtering runs over the first three dims jointly across all
        variables; set ``r[i] = 0`` to skip a dim.
    r : sequence of 3 ints
        Neighborhood radius per dim.
    f : sequence of 3 ints
        Patch radius per dim.
    sigma, h : float
        Noise standard deviation and filtering strength.
    n_eff : float, optional
        Effective sample size; -1 disables (default).
    device : torch.device or str, optional
        Where non-tensor ``arr`` lands (default ``cuda``); a tensor stays
        on its device.

    Dtypes: float32 and float64 are filtered as they are; float16 and
    bfloat16 are filtered in float32 and returned in their own dtype
    (the reference filters float16 in float16, so the two agree to
    float16 rounding); integer input is filtered in float32.
    """
    arr = as_tensor(arr, device)
    if arr.ndim != 4:
        raise ValueError('nlmeans expects a 4-D (d0, d1, d2, var) array')
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    if not arr.is_floating_point():
        arr = arr.to(torch.float32)
    _check_pads(arr.shape[:3], r, f)
    if r == (0, 0, 0):
        return arr               # degenerate neighborhood: identity
    from .nlmeans_cuda import nlmeans_3d, nlmeans_spatial
    with span('data.nlmeans_contiguous'):
        arr = arr.contiguous()
    if r[2] == 0 and f[2] == 0:
        return nlmeans_spatial(arr, r[:2], f[:2], sigma, h, n_eff)
    return nlmeans_3d(arr, r, f, sigma, h, n_eff)
