"""Input/output helpers: so far only the complex (dis)assembly of
variables, ``nd_tpu/io/__init__.py``'s ``assemble_complex`` and
``disassemble_complex``. The readers and writers wait for ROADMAP
item 13."""

from __future__ import annotations

import re

import torch

from ..core import DataArray
from ..core.variable import Variable

__all__ = ['assemble_complex', 'disassemble_complex']


def disassemble_complex(ds, inplace=False):
    """Split complex variables into ``<name>__re`` / ``<name>__im``
    pairs (a DataArray becomes a one-variable Dataset first)."""
    if isinstance(ds, DataArray):
        ds = ds.to_dataset(name=ds.name or 'data')
    new_ds = ds if inplace else ds.copy(deep=False)
    for vn in list(new_ds._variables):
        var = new_ds._variables[vn]
        if not (isinstance(var.data, torch.Tensor) and var.data.is_complex()):
            continue
        new_ds._variables[vn + '__re'] = Variable(
            var.dims, var.data.real.contiguous(), dict(var.attrs))
        new_ds._variables[vn + '__im'] = Variable(
            var.dims, var.data.imag.contiguous(), dict(var.attrs))
        del new_ds._variables[vn]
    if not inplace:
        return new_ds


def assemble_complex(ds, inplace=False):
    """Reassemble ``*_real``/``__re`` + ``*_imag``/``__im`` variable pairs
    into complex variables (the inverse of :func:`disassemble_complex`)."""
    new_ds = ds if inplace else ds.copy(deep=False)
    endings = {'re': ['_real', '__re'], 'im': ['_imag', '__im']}
    matches = {}
    for part, end in endings.items():
        rex = re.compile('(?P<stem>.*)(?:{})$'.format('|'.join(end)))
        matches[part] = [m for m in map(rex.match, new_ds._variables)
                         if m is not None]
    stems = set(m.group('stem') for m in matches['re'] + matches['im'])
    for vn in sorted(stems):
        m_re = next((m for m in matches['re'] if m.group('stem') == vn),
                    None)
        m_im = next((m for m in matches['im'] if m.group('stem') == vn),
                    None)
        if m_re is None or m_im is None:
            continue
        re_var = new_ds._variables[m_re.group(0)]
        im_var = new_ds._variables[m_im.group(0)]
        if im_var.dims != re_var.dims:
            im_var = im_var.transpose(*re_var.dims)
        dtype = torch.promote_types(re_var.data.dtype, im_var.data.dtype)
        if not dtype.is_floating_point:
            dtype = torch.float64       # integer parts: complex128
        elif dtype not in (torch.float32, torch.float64):
            dtype = torch.float32       # half parts: complex64
        new_ds._variables[vn] = Variable(
            re_var.dims, torch.complex(re_var.data.to(dtype),
                                       im_var.data.to(dtype)),
            dict(re_var.attrs))
        del new_ds._variables[m_re.group(0)]
        del new_ds._variables[m_im.group(0)]
    if not inplace:
        return new_ds
