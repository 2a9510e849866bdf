"""Input/output helpers (only what the SAR change path needs so far)."""

from __future__ import annotations

import torch

from ..core import DataArray
from ..core.variable import Variable

__all__ = ['disassemble_complex']


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
