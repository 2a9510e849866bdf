"""N-dimensional convolution with scipy.ndimage edge handling.

Counterpart of ``nd_tpu/ops/conv.py``:

  - edge mode 'reflect' matches scipy.ndimage's default 'reflect'
    (numpy 'symmetric': the edge sample is repeated), 'mirror' excludes
    the edge, plus 'nearest', 'constant' and 'wrap';
  - the kernel is flipped before correlation (true convolution), exactly
    like ``scipy.ndimage.convolve``;
  - arbitrary subsets of axes are filtered; all other axes are batched.

Separable (rank-1) kernels run as 1-d tap passes through the
``sepconv`` kernels (``ops/conv_cuda.py``): a float32 filter over the
axes {0, 1, 2} — a single-variable (y, x, time) stack — takes the
three-axis kernel in one pass (time first, as the reference's fused TPU
route does); otherwise the passes run in axis order, two adjacent axes
per launch where both have at most ``conv_cuda.INLINE_TAPS`` taps (the
kernel's tap vectors passed by value), one axis per launch otherwise
(taps of any length: a halo along one axis always fits a tile).

Non-separable kernels run through the ``stencil`` kernel
(``ops/stencil_cuda.py``): the filtered axes, sorted with the kernel's
axes permuted to match, form a contiguous ``(outer, n0, n1, n2, inner)``
view where they are adjacent (no copy); non-adjacent axes are moved
together first (one copy in, one out). A kernel over four or more axes
is the sum, over its leading axis, of three-axis stencils of the array
padded along that axis (the same sum on the card and on the CPU).

Dtypes: float16 and bfloat16 input is filtered in float32 and returned
in its own dtype (the reference filters float16 in float16, so the two
agree to float16 rounding); integer input is filtered in float32, as in
the reference; float32, float64 and complex keep their dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.variable import as_tensor

__all__ = ['convolve', 'separable_convolve', 'gaussian_kernel1d',
           'uniform_sums', 'pad_reflect']

# Taps per axis the fused three-axis route admits (the reference's
# conv_pallas._MAX_TAPS); longer kernels take the sequential passes.
FUSED_MAX_TAPS = 16

_SCIPY_TO_NP_PAD = {
    'reflect': 'symmetric',   # scipy.ndimage 'reflect' repeats the edge
    'mirror': 'reflect',      # scipy.ndimage 'mirror' excludes the edge
    'nearest': 'edge',
    'wrap': 'wrap',
    'constant': 'constant',
}


def _edge_src(j, n, mode):
    """In-range source index replacing position ``j`` of an axis of
    ``n`` samples under the scipy boundary mode (None => constant
    fill). Positions farther out than one period fold periodically, as
    repeated numpy padding does."""
    if 0 <= j < n:
        return j
    if mode == 'reflect':        # symmetric: -1 -> 0, n -> n-1
        j %= 2 * n
        return j if j < n else 2 * n - 1 - j
    if mode == 'mirror':         # reflect101: -1 -> 1, n -> n-2
        if n == 1:
            return 0
        j %= 2 * n - 2
        return j if j < n else 2 * n - 2 - j
    if mode == 'nearest':
        return 0 if j < 0 else n - 1
    if mode == 'wrap':
        return j % n
    return None                  # 'constant'


def pad_reflect(arr, pad_width, mode='reflect', cval=0.0):
    """Pad a tensor with scipy.ndimage edge-mode names (the boundary is
    gathered by index, on the tensor's device)."""
    if mode not in _SCIPY_TO_NP_PAD:
        raise ValueError('unsupported boundary mode %r' % (mode,))
    out = arr
    for ax, (lo, hi) in enumerate(pad_width):
        if not lo and not hi:
            continue
        n = out.shape[ax]
        src = [_edge_src(j, n, mode) for j in range(-lo, n + hi)]
        idx = torch.as_tensor([0 if s is None else s for s in src],
                              device=out.device)
        out = out.index_select(ax, idx)
        if mode == 'constant':
            fill = torch.as_tensor([s is None for s in src],
                                   device=out.device)
            shape = [1] * out.ndim
            shape[ax] = -1
            out = torch.where(fill.reshape(shape),
                              torch.as_tensor(cval, dtype=out.dtype,
                                              device=out.device), out)
    return out


def _scalar(w, like):
    return torch.tensor(w, dtype=like.dtype, device=like.device)


def _shift_add_valid(arr, weights, axis):
    """'valid' correlation with a 1-d tap vector as shifted adds.

    Uniform taps are summed first and scaled once; weighted taps
    multiply each term. This is the plain version of the ``sepconv``
    kernel: the kernel keeps this add order."""
    weights = np.asarray(weights, np.float64)
    n_out = arr.shape[axis] - len(weights) + 1
    uniform = bool(np.allclose(weights, weights[0]))
    out = None
    for i, w in enumerate(weights.tolist()):
        term = arr.narrow(axis, i, n_out)
        if not uniform:
            term = term * _scalar(w, arr)
        out = term if out is None else out + term
    if uniform and weights[0] != 1.0:
        out = out * _scalar(float(weights[0]), arr)
    return out


def _separable_factors(kernel):
    """1-d factors of a separable (rank-1) kernel, or None.

    The factors reproduce the kernel's outer product; 2-d kernels are
    tested via SVD, higher ranks only for the uniform (boxcar) case.
    """
    k = np.asarray(kernel, np.float64)
    if k.ndim == 1:
        return [k]
    if np.allclose(k, k.flat[0]):
        facs = [np.ones(n) for n in k.shape]
        facs[0] = facs[0] * k.flat[0]
        return facs
    if k.ndim == 2:
        u, s, vt = np.linalg.svd(k)
        if len(s) > 1 and s[1] <= 1e-7 * max(s[0], 1e-300):
            return [u[:, 0] * np.sqrt(s[0]), vt[0] * np.sqrt(s[0])]
    return None


def _const_pass(cv, taps, np_dtype):
    """The value a tap pass gives over a constant run of ``cv`` — what a
    later pass reads outside the array in 'constant' mode, since the
    reference pads every axis before the first pass."""
    taps = np.asarray(taps, np.float64)
    uniform = bool(np.allclose(taps, taps[0]))
    c = np_dtype.type(cv)
    out = None
    for w in taps.tolist():
        term = c if uniform else c * np_dtype.type(w)
        out = term if out is None else np_dtype.type(out + term)
    if uniform and taps[0] != 1.0:
        out = np_dtype.type(out * np_dtype.type(taps[0]))
    return out


def _sep_pass(arr, ax, taps0, taps1, mode, cval):
    """One ``sepconv`` pass over axis ``ax`` (taps0) and, when taps1 is
    given, axis ``ax + 1`` — through a contiguous 4-d view. A one-axis
    pass is the view (1, outer, n, inner) filtered over n, with one tap
    of weight 1 (an exact copy) over the outer axis, so that a block's
    tile spans outer rows rather than a single one."""
    from .conv_cuda import sepconv2
    shape = arr.shape
    outer = int(np.prod(shape[:ax], dtype=np.int64))
    if taps1 is None:
        view = (1, outer, shape[ax],
                int(np.prod(shape[ax + 1:], dtype=np.int64)))
        taps0, taps1 = np.ones(1), taps0
    else:
        view = (outer, shape[ax], shape[ax + 1],
                int(np.prod(shape[ax + 2:], dtype=np.int64)))
    out = sepconv2(arr.contiguous().reshape(view), taps0, taps1,
                   mode=mode, cval=cval)
    return out.reshape(shape)


def _fused_three_axis(arr, pairs, mode, cval):
    """The reference's fused route (``try_fused_separable``) in its
    three-axis case: taps over exactly the axes {0, 1, 2}, at most
    ``FUSED_MAX_TAPS`` each. ``pairs`` are (axis, FLIPPED taps). Returns
    the result, or None for the passes in axis order (a two-axis filter
    keeps the two-axis kernel, whose y-then-x order the passes share)."""
    from .conv_cuda import sepconv3
    if arr.ndim < 3 or arr.numel() == 0:
        return None
    active = []
    scale = 1.0   # length-1 factors carry a uniform kernel's scale
    for ax, t in pairs:
        t = np.asarray(t, np.float64)
        if t.shape[0] > 1:
            active.append((int(ax), t))
        else:
            scale *= float(t[0])
    if sorted(ax for ax, _ in active) != [0, 1, 2] \
            or any(len(t) > FUSED_MAX_TAPS for _, t in active) \
            or any(len(t) // 2 > arr.shape[ax] for ax, t in active):
        return None
    if scale != 1.0:
        active[0] = (active[0][0], active[0][1] * scale)
    taps = dict(active)
    shape = arr.shape
    view = shape[:3] + (int(np.prod(shape[3:], dtype=np.int64)),)
    out = sepconv3(arr.contiguous().reshape(view), taps[0], taps[1],
                   taps[2], mode=mode, cval=cval)
    return out.reshape(shape)


def _stencil3(arr, kflip, axes, mode, cval):
    """The ``stencil`` kernel over one to three axes of ``arr`` with the
    FLIPPED kernel ``kflip`` (one dim per axis, in ``axes``' order)."""
    from .stencil_cuda import stencil
    order = np.argsort(axes)
    src = tuple(int(axes[i]) for i in order)
    kflip = np.transpose(kflip, order)
    front = tuple(range(len(src)))
    moved = src != tuple(range(src[0], src[0] + len(src)))
    if moved:     # the filtered axes gathered at the front
        arr = arr.movedim(src, front)
    first = 0 if moved else src[0]
    shape = arr.shape
    dims = shape[first:first + len(src)] + (1,) * (3 - len(src))
    view = (int(np.prod(shape[:first], dtype=np.int64)),) + tuple(dims) \
        + (int(np.prod(shape[first + len(src):], dtype=np.int64)),)
    out = stencil(arr.contiguous().reshape(view),
                  kflip.reshape(kflip.shape + (1,) * (3 - len(src))),
                  mode, cval).reshape(shape)
    return out.movedim(front, src).contiguous() if moved else out


def _stencil_nd(arr, kflip, axes, mode, cval):
    """A non-separable kernel: the ``stencil`` kernel over up to three
    axes; over more, the sum over the leading kernel axis of the stencils
    of ``arr`` padded along that axis (boundary by ``mode``) and shifted,
    in the order of that axis."""
    if len(axes) <= 3:
        return _stencil3(arr, kflip, axes, mode, cval)
    ax, k = axes[0], kflip.shape[0]
    pads = [(0, 0)] * arr.ndim
    pads[ax] = ((k - 1) // 2, k // 2)
    padded = pad_reflect(arr, pads, mode, cval)
    n = arr.shape[ax]
    out = None
    for a in range(k):
        part = _stencil_nd(padded.narrow(ax, a, n), kflip[a], axes[1:],
                           mode, cval)
        out = part if out is None else out + part
    return out


def convolve(arr, kernel, axes=None, mode='reflect', cval=0.0, device=None):
    """Convolve ``arr`` with ``kernel`` along ``axes``.

    Matches ``scipy.ndimage.convolve`` semantics (kernel flip, origin at
    ``size // 2``, default 'reflect' boundary). The result stays on
    ``arr``'s device, in its dtype (float16 and bfloat16 are filtered in
    float32); integer input comes back as float32.

    Parameters
    ----------
    arr : torch.Tensor
    kernel : array with ``len(axes)`` dims
    axes : tuple of int, optional
        Axes to filter (default: all).
    mode : str, optional
        scipy.ndimage boundary mode (default 'reflect').
    device : torch.device or str, optional
        Where non-tensor ``arr`` lands (default ``cuda``); a tensor stays
        on its device.
    """
    arr = as_tensor(arr, device)
    kernel = np.asarray(kernel)
    if axes is None:
        axes = tuple(range(arr.ndim))
    axes = tuple(int(a) % arr.ndim for a in axes)
    if kernel.ndim != len(axes):
        raise ValueError('kernel must have one dim per filtered axis')
    if mode not in _SCIPY_TO_NP_PAD:
        raise ValueError('unsupported boundary mode %r' % (mode,))

    if arr.is_complex():
        re = convolve(arr.real, kernel, axes, mode, cval)
        im = convolve(arr.imag, kernel, axes, mode, cval)
        return torch.complex(re, im)
    if not arr.is_floating_point():
        arr = arr.to(torch.float32)
    from .conv_cuda import INLINE_TAPS, LOW_PRECISION
    if arr.dtype in LOW_PRECISION:
        return convolve(arr.to(torch.float32), kernel, axes, mode,
                        cval).to(arr.dtype)

    kflip = np.flip(kernel, axis=tuple(range(kernel.ndim)))
    factors = _separable_factors(kflip)
    if factors is None:
        return _stencil_nd(arr, np.asarray(kflip, np.float64), axes, mode,
                           cval)

    passes = list(zip(axes, factors))
    if arr.dtype == torch.float32:
        fused = _fused_three_axis(arr, passes, mode, cval)
        if fused is not None:
            return fused
    np_dtype = np.dtype(str(arr.dtype).replace('torch.', ''))
    cv = np_dtype.type(cval)
    out = arr
    i = 0
    while i < len(passes):
        ax, fac = passes[i]
        if len(fac) == 1:
            out = out * _scalar(float(fac[0]), out)
            cv = np_dtype.type(cv * np_dtype.type(fac[0]))
            i += 1
            continue
        nxt = passes[i + 1] if i + 1 < len(passes) else None
        if nxt is not None and nxt[0] == ax + 1 and len(nxt[1]) > 1 \
                and max(len(fac), len(nxt[1])) <= INLINE_TAPS:
            out = _sep_pass(out, ax, fac, nxt[1], mode, float(cv))
            cv = _const_pass(_const_pass(cv, fac, np_dtype), nxt[1],
                             np_dtype)
            i += 2
        else:
            out = _sep_pass(out, ax, fac, None, mode, float(cv))
            cv = _const_pass(cv, fac, np_dtype)
            i += 1
    return out


def separable_convolve(arr, kernels, axes, mode='reflect', cval=0.0,
                       device=None):
    """Apply a sequence of 1-d kernels along the given axes (scipy
    ``convolve1d`` semantics per axis).

    A float32 tensor filtered over the axes {0, 1, 2} takes the fused
    three-axis kernel (time first), unless the mode is 'constant' with
    cval != 0: there each stage re-pads with cval, which only sequential
    passes give. Otherwise one ``convolve`` per axis, in the given
    order. Non-tensor ``arr`` lands on ``device`` (default ``cuda``).
    Dtypes as in :func:`convolve`.
    """
    arr = as_tensor(arr, device)
    from .conv_cuda import LOW_PRECISION
    if arr.dtype in LOW_PRECISION:
        return separable_convolve(arr.to(torch.float32), kernels, axes,
                                  mode, cval).to(arr.dtype)
    active = [(int(ax) % arr.ndim, np.asarray(k, np.float64))
              for ax, k in zip(axes, kernels) if np.shape(k)[0] > 1]
    if not active:
        return arr
    if arr.dtype == torch.float32 and (mode != 'constant' or cval == 0.0):
        fused = _fused_three_axis(
            arr, [(ax, np.flip(k)) for ax, k in active], mode, cval)
        if fused is not None:
            return fused
    out = arr
    for ax, k in active:
        out = convolve(out, k, axes=(ax,), mode=mode, cval=cval)
    return out


def gaussian_kernel1d(sigma, truncate=4.0, radius=None):
    """The exact 1-d kernel scipy.ndimage.gaussian_filter uses."""
    if radius is None:
        radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    if sigma == 0:
        phi = (x == 0).astype(np.float64)
    else:
        phi = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return phi / phi.sum()


def uniform_sums(arr, sizes, axes, device=None):
    """Sliding-window sums ('valid') of ``sizes[i]`` samples along each
    ``axes[i]``."""
    arr = as_tensor(arr, device)
    for ax, s in zip(axes, sizes):
        arr = arr.unfold(ax, int(s), 1).sum(-1)
    return arr
