"""FFT-based image registration on the tensors' device.

Counterpart of ``nd_tpu/ops/fft.py`` on ``torch.fft``: phase
correlation with the single-step upsampled-DFT subpixel refinement
(Guizar-Sicairos et al. 2008), the Fourier shift, and the Catmull-Rom
translations that coregistration resamples with. Where the JAX package
sends the FFTs of a TPU to the host, the port keeps them on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.variable import as_tensor

__all__ = ['phase_cross_correlation', 'phase_cross_correlation_batch',
           'fourier_shift', 'translate', 'translate_batch']


def _real_float(x):
    """A real tensor in a float dtype FFTs take: float16/bfloat16 and
    integers become float32 and float64 respectively."""
    if x.is_floating_point():
        return x if x.dtype in (torch.float32, torch.float64) \
            else x.to(torch.float32)
    return x.to(torch.float64)


def _argmax_rc(A, ncols):
    """(row, col) float64 pair of each batch item's flat argmax."""
    flat = torch.argmax(A.reshape(A.shape[0], -1), dim=-1)
    return torch.stack([torch.div(flat, ncols, rounding_mode='floor'),
                        flat % ncols], dim=-1).to(torch.float64)


def phase_cross_correlation(src, ref, upsample_factor=1,
                            normalization='phase', device=None):
    """Estimate the translation between two images.

    Returns the (row, col) shift that must be applied to ``src`` to
    register it onto ``ref`` (skimage >= 0.19's convention and default
    ``normalization='phase'``: the cross-power spectrum is whitened
    before the inverse transform). Pass ``normalization=None`` for plain
    cross-correlation. Non-tensor input lands on ``device`` (default
    ``cuda``).
    """
    src = as_tensor(src, device)
    shifts = phase_cross_correlation_batch(
        src[None], as_tensor(ref, src.device),
        upsample_factor=upsample_factor, normalization=normalization)
    return shifts[0]


def phase_cross_correlation_batch(srcs, ref, upsample_factor=1,
                                  normalization='phase', device=None):
    """Register every image of ``srcs`` (B, H, W) onto one ``ref``
    (H, W) in one pass: one real FFT batch, one inverse, and one batched
    matrix DFT for the refinement.

    The cross-power spectrum of two real images is Hermitian, so the
    correlation surface comes back through one ``irfft2(., s=(H, W))``
    and the refinement's full spectrum is the half-spectrum's Hermitian
    completion (data movement, no second FFT). The spectra are taken in
    the input's precision (float32 -> complex64); the refinement's
    matrix DFT runs in complex128, as the JAX package's host path
    promotes it.

    Returns a (B, 2) float64 tensor of (row, col) shifts on the input's
    device.
    """
    srcs = _real_float(as_tensor(srcs, device))
    ref = _real_float(as_tensor(ref, srcs.device)).to(srcs.dtype)
    nb, H, W = srcs.shape
    src_f = torch.fft.rfft2(srcs)
    ref_f = torch.fft.rfft2(ref)
    ip = src_f * torch.conj(ref_f)[None]
    if normalization == 'phase':
        eps = float(torch.finfo(srcs.dtype).eps)
        ip = ip / torch.clamp(torch.abs(ip), min=100 * eps).to(ip.dtype)
    elif normalization is not None:
        raise ValueError('unknown normalization %r' % normalization)
    A = torch.abs(torch.fft.irfft2(ip, s=(H, W)))
    peak = _argmax_rc(A, W)
    # peaks past the middle wrap to negative shifts
    shifts = torch.stack([torch.where(p > int(np.fix(n / 2)), p - n, p)
                          for p, n in ((peak[:, 0], H), (peak[:, 1], W))],
                         dim=-1)

    if upsample_factor > 1:
        # refine around each integer peak with an upsampled DFT
        upf = float(upsample_factor)
        ups = int(np.ceil(upf * 1.5))
        dftshift = float(np.fix(ups / 2.0))
        shifts = torch.round(shifts * upf) / upf
        offsets = dftshift - shifts * upf                   # (B, 2)
        # full spectrum = Hermitian completion of the half-spectrum:
        #   full[h, w] = ip[h, w]                 for w < W//2+1
        #   full[h, w] = conj(ip[(-h) % H, W-w])  otherwise
        Wh = ip.shape[-1]
        tail = torch.conj(torch.flip(ip[:, :, 1:W - Wh + 1], dims=(-1,)))
        tail = torch.roll(torch.flip(tail, dims=(1,)), 1, dims=1)
        data = torch.conj(torch.cat([ip, tail], dim=-1)).to(
            torch.complex128)
        im2pi = 1j * 2 * np.pi
        u = torch.arange(ups, dtype=torch.float64, device=srcs.device)
        fw = torch.fft.fftfreq(W, upf, dtype=torch.float64,
                               device=srcs.device)
        fh = torch.fft.fftfreq(H, upf, dtype=torch.float64,
                               device=srcs.device)
        # contract the column axis: (B, ups_c, W) x (B, H, W)
        kw = torch.exp(-im2pi * ((u[None, :, None]
                                  - offsets[:, 1][:, None, None])
                                 * fw[None, None, :]))
        data = torch.matmul(data, kw.transpose(1, 2))      # (B, H, ups)
        # contract the row axis: (B, ups_r, H) x (B, H, ups_c)
        kh = torch.exp(-im2pi * ((u[None, :, None]
                                  - offsets[:, 0][:, None, None])
                                 * fh[None, None, :]))
        data = torch.matmul(kh, data)                      # (B, upr, upc)
        sub = _argmax_rc(torch.abs(data), ups) - dftshift
        shifts = shifts + sub / upf
    return shifts


def fourier_shift(img, shift, device=None):
    """Shift an image by (row, col) via the Fourier shift theorem: the
    spectrum in the image's precision, the float64 phase ramp applied
    in complex128 and a float64 result, as in ``nd_tpu``."""
    img = _real_float(as_tensor(img, device))
    f = torch.fft.fft2(img)
    fy = torch.fft.fftfreq(img.shape[0], dtype=torch.float64,
                           device=img.device)[:, None]
    fx = torch.fft.fftfreq(img.shape[1], dtype=torch.float64,
                           device=img.device)[None, :]
    phase = torch.exp(-2j * np.pi * (float(shift[0]) * fy
                                     + float(shift[1]) * fx))
    return torch.real(torch.fft.ifft2(f.to(torch.complex128) * phase))


def _shift_axis_cubic(imgs, shifts, axis):
    """Cubic (Catmull-Rom) shift of a batch along ``axis`` by per-image
    ``shifts`` (float64 tensor, (B,)): output[b, ..., i, ...] =
    sum_k tap_k(t_b) * input[b, ..., clip(i + n_b + k - 1), ...], the
    integer part ``n_b`` and fraction ``t_b`` of the clamped shift.
    Edge-clamped like ``nd_tpu``'s padded window; at |shift| past
    size + 1 every tap reads the border, so the clamp of the shift is
    saturation-exact."""
    b = imgs.shape[0]
    size = imgs.shape[axis]
    m = size + 2
    shifts = shifts.clamp(-(m - 1), m - 1)
    n_int = torch.floor(shifts)
    t = (shifts - n_int).reshape((b,) + (1,) * (imgs.ndim - 1))
    n_int = n_int.to(torch.int64)
    t2 = t * t
    t3 = t2 * t
    taps = ((-t3 + 2 * t2 - t) / 2,
            (3 * t3 - 5 * t2 + 2) / 2,
            (-3 * t3 + 4 * t2 + t) / 2,
            (t3 - t2) / 2)
    base = torch.arange(size, device=imgs.device)[None, :] \
        + n_int[:, None]                                    # (B, size)
    shape = [b] + [1] * (imgs.ndim - 1)
    shape[axis] = size
    out = torch.zeros_like(imgs)
    for k, w in enumerate(taps):
        idx = (base + (k - 1)).clamp(0, size - 1).reshape(shape)
        win = torch.gather(imgs, axis, idx.expand(imgs.shape))
        out = out + w.to(imgs.dtype) * win
    return out


def _translate_axis(img, shift, axis):
    """:func:`translate`'s shift of one image along ``axis``, as
    ``nd_tpu``'s static variant does it: the integer part first
    (edge-clamped), then the Catmull-Rom taps of the fraction over the
    shifted image (edge-clamped again), skipped for a whole shift."""
    size = img.shape[axis]
    shift = float(np.clip(shift, -(size + 1), size + 1))
    n = int(np.floor(shift))
    t = shift - n
    idx = (torch.arange(size, device=img.device) + n).clamp(0, size - 1)
    out = img.index_select(axis, idx)
    if t == 0.0:
        return out
    frac = torch.full((1,), t, dtype=torch.float64, device=img.device)
    return _shift_axis_cubic(out[None], frac, axis + 1)[0]


def translate_batch(imgs, translations, device=None):
    """Cubic-resample a batch of images by per-image translations.

    Parameters
    ----------
    imgs : tensor (B, H, W)
    translations : array (B, 2)
        Per-image (dx, dy), as in :func:`translate`:
        ``output[i, j] = input[i + dy, j + dx]``.

    A zero translation is an exact identity (the taps collapse to
    (0, 1, 0, 0)). Integer images are resampled in float32 and cast back
    (truncating). Non-tensor input lands on ``device`` (default
    ``cuda``).
    """
    imgs = as_tensor(imgs, device)
    in_dtype = imgs.dtype
    integer_in = not (imgs.is_floating_point() or imgs.is_complex())
    if integer_in:
        imgs = imgs.to(torch.float32)
    tr = torch.as_tensor(np.asarray(translations, np.float64)
                         if not isinstance(translations, torch.Tensor)
                         else translations,
                         dtype=torch.float64, device=imgs.device)
    out = _shift_axis_cubic(imgs, tr[:, 0], 2)
    out = _shift_axis_cubic(out, tr[:, 1], 1)
    return out.to(in_dtype) if integer_in else out


def translate(img, translation, method='cubic', device=None):
    """Resample ``img`` shifted by ``translation = (dx, dy)``:
    output[i, j] = input[i + dy, j + dx] (skimage's
    ``warp(img, AffineTransform(translation))``).

    'cubic' (default, Catmull-Rom) is a separable 4-tap filter;
    'bilinear'/'nearest' use the gather sampler, where out-of-frame and
    non-finite source pixels fill with 0.
    """
    img = as_tensor(img, device)
    if method == 'cubic':
        in_dtype = img.dtype
        if not (img.is_floating_point() or img.is_complex()):
            img = img.to(torch.float32)
        out = _translate_axis(img, float(translation[1]), img.ndim - 2)
        out = _translate_axis(out, float(translation[0]), img.ndim - 1)
        return out.to(in_dtype)
    from .interp import map_coordinates
    H, W = img.shape[-2:]
    ii = torch.arange(H, dtype=torch.float64,
                      device=img.device)[:, None] + float(translation[1])
    jj = torch.arange(W, dtype=torch.float64,
                      device=img.device)[None, :] + float(translation[0])
    rows = ii.expand(H, W)
    cols = jj.expand(H, W)
    out = map_coordinates(img, rows, cols, method=method, cval=np.nan)
    return torch.nan_to_num(out, nan=0.0)
