"""Statistical primitives on the tensors' device.

Counterpart of ``nd_tpu/ops/stats.py``: the chi-square CDF through the
regularized lower incomplete gamma function, ``torch.special.gammainc``
(on the card and on the CPU alike).

Accuracy differs from the JAX package's ``lax.igamma``: in float32
``gammainc`` is the closer to the exact value (about 3e-7 at the
chi-square shapes of a 12-date series, where ``lax.igamma`` errs by up
to 4e-6), in float64 the farther (about 4e-10 against 1e-14). Each
dtype is computed in itself.
"""

from __future__ import annotations

import torch

from ..core.variable import as_tensor

__all__ = ['chi2_cdf', 'gammainc_lower']


def gammainc_lower(a, x):
    """Regularized lower incomplete gamma P(a, x)."""
    return torch.special.gammainc(a, x)


def _on(value, like):
    """``value`` as a tensor of ``like``'s dtype and device; a number
    or a 0-d tensor held elsewhere becomes a fill on that device, so no
    host-to-device copy waits on the stream."""
    if isinstance(value, torch.Tensor):
        if value.device == like.device:
            return value.to(like.dtype)
        if value.dim() == 0:
            value = value.item()
        else:
            return value.to(like.device, like.dtype)
    return torch.full((), value, dtype=like.dtype, device=like.device)


def chi2_cdf(x, df, device=None):
    """CDF of the chi-square distribution with ``df`` degrees of freedom.

    chi2.cdf(x, df) = P(df/2, x/2) on ``x``'s device (numpy input lands
    on ``device``, by default ``cuda``). ``x < 0`` gives 0, NaN
    propagates, and integer ``x`` is computed in float64 (the JAX
    package runs with 64-bit types on).
    """
    x = as_tensor(x, device)
    if not x.is_floating_point():
        x = x.to(torch.float64)
    df = _on(df, x)
    out = torch.special.gammainc(df / 2.0, x.clamp_min(0.0) / 2.0)
    out = torch.where(x < 0, torch.zeros_like(out), out)
    return torch.where(torch.isnan(x), torch.full_like(out, float('nan')),
                       out)
