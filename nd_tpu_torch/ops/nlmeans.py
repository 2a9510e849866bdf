"""Non-local means denoising.

Counterpart of ``nd_tpu/ops/nlmeans.py``: 'reflect' (edge-excluding)
boundary, weight ``exp(-max(dsq/dsq_norm - 2 sigma^2, 0)/h^2)`` with
``dsq_norm = nvars * prod(2f+1)``, self-weight = max weight (or the
``n_eff`` effective-sample-size solution).

On a CUDA tensor every window runs through the ``nlmeans`` CUDA kernel
(``ops/nlmeans_cuda.py``): spatial windows (``r[2] = f[2] = 0``) through
``nlmeans_spatial``, temporal and full 3-D windows through
``nlmeans_3d``. ``nlmeans_plain`` is the plain version: one pass per
neighbourhood offset with shifted squared differences and ``(2f+1)``
patch box sums.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

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


def nlmeans_plain(arr, r, f, sigma, h, n_eff=-1.0):
    """Plain PyTorch NLMeans of a ``(d0, d1, d2, var)`` tensor with a
    3-d window (``r``/``f`` per axis). Sums run in a fixed order: the
    squared differences over the variables, then the patch window in
    row-major order — the kernel's order."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    D = tuple(arr.shape[:3])
    nvars = arr.shape[3]
    _check_pads(D, r, f)
    pad = tuple(ri + fi for ri, fi in zip(r, f))
    # numpy 'reflect' (edge excluded) is scipy's 'mirror'
    P = pad_reflect(arr, [(p, p) for p in pad] + [(0, 0)], mode='mirror')
    offsets = [off for off in itertools.product(
        *[range(-ri, ri + 1) for ri in r]) if off != (0, 0, 0)]
    if not offsets:
        return arr

    def block(start, size):
        return P[start[0]:start[0] + size[0],
                 start[1]:start[1] + size[1],
                 start[2]:start[2] + size[2]]

    dtype, dev = arr.dtype, arr.device
    dsq_norm = torch.tensor(float(nvars * np.prod([2 * fi + 1 for fi in f])),
                            dtype=dtype, device=dev)
    two_sigma2 = torch.tensor(2.0 * float(sigma) ** 2, dtype=dtype,
                              device=dev)
    inv_h2 = torch.tensor(1.0 / float(h) ** 2, dtype=dtype, device=dev)
    base_lo = tuple(pi - fi for pi, fi in zip(pad, f))
    ext = tuple(d + 2 * fi for d, fi in zip(D, f))
    A1 = block(base_lo, ext)
    window = list(itertools.product(*[range(2 * fi + 1) for fi in f]))

    center = block(pad, D)
    wsum = torch.zeros(D, dtype=dtype, device=dev)
    wsq = torch.zeros_like(wsum)
    wmax = torch.zeros_like(wsum)
    out = torch.zeros_like(center)
    for off in offsets:
        A2 = block(tuple(b + o for b, o in zip(base_lo, off)), ext)
        d = A1 - A2
        sq = d[..., 0] * d[..., 0]
        for v in range(1, nvars):
            sq = sq + d[..., v] * d[..., v]
        patch = None
        for u in window:
            term = sq[u[0]:u[0] + D[0], u[1]:u[1] + D[1],
                      u[2]:u[2] + D[2]]
            patch = term if patch is None else patch + term
        dsq = patch / dsq_norm
        w = torch.exp(-torch.clamp_min(dsq - two_sigma2, 0) * inv_h2)
        vals = block(tuple(p + o for p, o in zip(pad, off)), D)
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


def nlmeans(arr, r, f, sigma, h, n_eff=-1.0):
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
    """
    arr = torch.as_tensor(arr)
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
    if r[2] == 0 and f[2] == 0:
        return nlmeans_spatial(arr.contiguous(), r[:2], f[:2], sigma, h,
                               n_eff)
    return nlmeans_3d(arr.contiguous(), r, f, sigma, h, n_eff)
