"""Generator 'wishart_patches': tiles of a dual-pol covariance stack,
stationary complex-Wishart speckle with step changes in sparse patches,
drawn on the device from the seed.

Each pixel and date is the sample covariance of ``enl`` looks of a
zero-mean complex Gaussian dual-pol pair with covariance ``Sigma``
(the configuration's ``speckle``: the two channels' backscatter in dB
and their coherence), drawn by the Bartlett decomposition, which holds
for looks that are not whole numbers: ``C = A T T^H A^H / L`` with
``A`` the Cholesky factor of ``Sigma``, ``T`` lower triangular,
``T11^2 ~ Gamma(L)``, ``T22^2 ~ Gamma(L - 1)``, ``T21 ~ CN(0, 1)``.
Pixels are independent.

Patches of ``patch x patch`` pixels on a grid of the tile,
``round(changed_share * cells)`` of them, each change
``changes_per_patch`` times (a number drawn per patch from the mix's
range): at a date of its own drawn from 1 .. k-1, ``Sigma`` is
multiplied by a factor whose size in dB is drawn log-uniformly from the
mix's ``step_db`` range, up or down with equal chance. Every seed gives
the same number of patches; their places, dates and steps differ.

The Dataset carries the tile's coordinates on the configuration's
``grid``: ``y`` and ``x`` in metres of its ``crs`` (``attrs['crs']``),
the tile ``index`` placed beside the one before, and ``time`` at the
grid's revisit from its first date.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.scene import Scene, tile_seed

__all__ = ['make', 'patch_count', 'coordinates']


def patch_count(ny, nx, patch, share):
    return int(round(share * (ny // patch) * (nx // patch)))


def coordinates(config, index):
    """{dim: numpy coordinate} of tile ``index`` on the configuration's
    grid: cell centres, ``y`` from north to south."""
    g = config['grid']
    ny, nx, k = (int(config[d]) for d in config['dims'])
    step = float(g['spacing'])
    y = float(g['y0']) - (np.arange(ny) + 0.5) * step
    x = float(g['x0']) + (index * nx + np.arange(nx) + 0.5) * step
    t = (np.datetime64(g['t0'], 'D')
         + np.arange(k) * np.timedelta64(int(g['revisit_days']), 'D'))
    return dict(zip(config['dims'], (y, x, t.astype('datetime64[ns]'))))


def _speckle(config, g, shape, device, dtype):
    """(C11, C12 re, C12 im, C22) of stationary speckle."""
    sp = config['speckle']
    looks = float(sp['enl'])
    s11, s22 = (10.0 ** (float(db) / 10.0) for db in sp['sigma_db'])
    rho = float(sp['coherence'])
    a11 = math.sqrt(s11)
    a21 = rho * math.sqrt(s22)
    a22 = math.sqrt(s22 * (1.0 - rho * rho))
    conc = torch.full(shape, looks, device=device, dtype=dtype)
    b11 = a11 * torch._standard_gamma(conc, generator=g).sqrt_()
    t22 = torch._standard_gamma(conc.sub_(1.0), generator=g).sqrt_()
    del conc
    t21r = torch.randn(shape, generator=g, device=device, dtype=dtype)
    t21i = torch.randn(shape, generator=g, device=device, dtype=dtype)
    t21r *= math.sqrt(0.5)
    t21i *= math.sqrt(0.5)
    # B = A T: b11 = a11 t11, b21 = a21 t11 + a22 t21, b22 = a22 t22
    b21r = (a21 / a11) * b11 + a22 * t21r
    del t21r
    b21i = a22 * t21i
    del t21i
    c11 = b11 * b11 / looks
    c12r = b11 * b21r / looks
    c12i = b11 * b21i / looks
    c12i.neg_()
    del b11
    t22 *= a22
    c22 = (b21r * b21r + b21i * b21i + t22 * t22) / looks
    return c11, c12r, c12i, c22


def make(config, traffic, seed, index, device):
    """Tile ``index`` of run ``seed`` on ``device``."""
    import nd_tpu_torch as ndt
    ny, nx, k = (int(config[d]) for d in config['dims'])
    dtype = getattr(torch, config['dtype'])
    g = torch.Generator(device=device)
    g.manual_seed(tile_seed(seed, index))
    chans = _speckle(config, g, (ny, nx, k), device, dtype)

    patch = int(traffic['patch'])
    gy, gx = ny // patch, nx // patch
    n = patch_count(ny, nx, patch, float(traffic['changed_share']))
    cells = torch.randperm(gy * gx, generator=g, device=device)[:n]
    lo, hi = (int(c) for c in traffic['changes_per_patch'])
    db_lo, db_hi = (math.log(float(d)) for d in traffic['step_db'])
    count = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    factor = torch.ones((n, k), dtype=torch.float64, device=device)
    for c in range(hi):
        date = torch.randint(1, k, (n,), generator=g, device=device)
        size = torch.exp(db_lo + (db_hi - db_lo) * torch.rand(
            (n,), generator=g, device=device, dtype=torch.float64))
        sign = torch.randint(0, 2, (n,), generator=g, device=device) * 2 - 1
        step = 10.0 ** (sign * size / 10.0)
        after = (torch.arange(k, device=device) >= date[:, None]) \
            & (c < count)[:, None]
        factor = torch.where(after, factor * step[:, None], factor)

    flat = torch.ones((gy * gx, k), dtype=dtype, device=device)
    flat[cells] = factor.to(dtype)
    scale = torch.ones((ny, nx, k), dtype=dtype, device=device)
    scale[:gy * patch, :gx * patch] = flat.view(gy, gx, k) \
        .repeat_interleave(patch, 0).repeat_interleave(patch, 1)
    for ch in chans:
        ch *= scale
    del scale
    inputs = dict(zip(config['variables'], chans))
    dims = tuple(config['dims'])
    ds = ndt.Dataset({v: (dims, t) for v, t in inputs.items()},
                     coords=coordinates(config, index),
                     attrs={'crs': config['grid']['crs']}, device=device)
    return Scene(inputs=inputs, dataset=ds)
