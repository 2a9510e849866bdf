"""Non-local means as the textbook states it, in plain PyTorch.

Buades, Coll and Morel (2011), with the weight and self-weight that
``NLMeansFilter`` documents: every offset ``o`` of the search window
(all of them, in both directions, no pairing), the squared patch
distance summed over the variables and the patch, normalised by
``nvars * prod(2f + 1)``, the weight ``exp(-max(d - 2 sigma^2, 0) / h^2)``,
the self-weight the largest weight of the window (1 where all are 0),
and the boundary numpy's 'reflect' (edge excluded) on the filtered axes.

The cube is padded once and filtered in blocks of rows, so that a
reference in float64 fits beside the program's state.
"""

from __future__ import annotations

import itertools

import torch

__all__ = ['nlmeans', 'mirror_pad']


def mirror_pad(x, pads):
    """Pad the leading axes of ``x`` by ``pads`` (one int per axis) with
    the edge sample excluded (numpy 'reflect')."""
    for ax, p in enumerate(pads):
        if p == 0:
            continue
        n = x.shape[ax]
        if p >= n:
            raise ValueError('pad %d does not fit an axis of %d' % (p, n))
        idx = list(range(p, 0, -1)) + list(range(n)) \
            + list(range(n - 2, n - 2 - p, -1))
        x = x.index_select(ax, torch.tensor(idx, device=x.device))
    return x


def _box(x, width, axis):
    """Sums of ``width`` consecutive samples along ``axis`` ('valid')."""
    n = x.shape[axis] - width + 1
    acc = x.narrow(axis, 0, n)
    for u in range(1, width):
        acc = acc + x.narrow(axis, u, n)
    return acc


def nlmeans(cube, r, f, sigma, h, dtype=torch.float64, rows=None):
    """Filter a ``(d0, d1, d2, nvars)`` cube over its first three axes.

    ``r`` and ``f`` are the search and patch radii per axis (0: the axis
    is not filtered). Computed in ``dtype``; returns a tensor of that
    dtype. ``rows`` is the block height along d0 (default: about 2**25
    samples a block)."""
    r = tuple(int(v) for v in r)
    f = tuple(int(v) for v in f)
    d0, d1, d2, nv = cube.shape
    pad = tuple(ri + fi for ri, fi in zip(r, f))
    P = mirror_pad(cube.to(dtype), pad)
    offsets = [o for o in itertools.product(*[range(-ri, ri + 1)
                                              for ri in r]) if any(o)]
    norm = float(nv)
    for fi in f:
        norm *= 2 * fi + 1
    two_s2 = 2.0 * float(sigma) ** 2
    inv_h2 = 1.0 / float(h) ** 2
    if rows is None:
        rows = max(1, (1 << 25) // max(1, d1 * d2 * nv))
    out = torch.empty((d0, d1, d2, nv), dtype=dtype, device=cube.device)
    for a in range(0, d0, rows):
        b = min(d0, a + rows)
        blk = P[a:b + 2 * pad[0]]
        n = (b - a, d1, d2)
        # the patch centres of the outputs, widened by f for the patch
        lo = tuple(p - fi for p, fi in zip(pad, f))
        wide = tuple(ni + 2 * fi for ni, fi in zip(n, f))

        def at(start, size):
            return blk[start[0]:start[0] + size[0],
                       start[1]:start[1] + size[1],
                       start[2]:start[2] + size[2]]

        centre_patch = at(lo, wide)
        centre = at(pad, n)
        wsum = torch.zeros(n, dtype=dtype, device=cube.device)
        wmax = torch.zeros_like(wsum)
        acc = torch.zeros(n + (nv,), dtype=dtype, device=cube.device)
        for o in offsets:
            other = at(tuple(s + oi for s, oi in zip(lo, o)), wide)
            diff = centre_patch - other
            dist = (diff * diff).sum(-1)
            for ax in range(3):
                dist = _box(dist, 2 * f[ax] + 1, ax)
            w = torch.exp(-torch.clamp_min(dist / norm - two_s2, 0.0)
                          * inv_h2)
            wsum += w
            wmax = torch.maximum(wmax, w)
            acc += w[..., None] * at(tuple(p + oi for p, oi in zip(pad, o)),
                                     n)
        w_self = torch.where(wmax == 0, torch.ones_like(wmax), wmax)
        out[a:b] = (acc + w_self[..., None] * centre) \
            / (wsum + w_self)[..., None]
    return out


def window(params, dims):
    """Per-axis (r, f) over ``dims`` of ``NLMeansFilter(**params)``: the
    search radius on its ``dims`` (0 elsewhere) and the patch radius
    ``f`` on each searched axis, as the filter documents them."""
    on = list(params['dims'])
    r = params['r']
    r = list(r) if isinstance(r, (list, tuple)) else [r] * len(on)
    r3 = tuple(int(r[on.index(d)]) if d in on else 0 for d in dims)
    f3 = tuple(int(params['f']) if ri > 0 else 0 for ri in r3)
    return r3, f3
