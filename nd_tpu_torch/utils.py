"""Helpers: ``as_tensor`` (where non-tensor input lands: ``cuda`` unless
the caller names a device), dims and shapes, variable selection, complex
detection and
the docstring and argument tooling that
:func:`nd_tpu_torch.algorithm.wrap_algorithm` uses.

Counterpart of the matching parts of ``nd_tpu/utils.py``.
"""

from __future__ import annotations

import inspect
import itertools
from collections import OrderedDict

import torch

from .core import DataArray, Dataset
from .core.dataarray import expand_variables_da
from .core.variable import as_tensor

__all__ = ['as_tensor', 'get_dims', 'get_shape', 'get_vars_for_dims',
           'expand_variables', 'is_complex',
           'parse_docstring', 'assemble_docstring', 'extract_arguments']


def get_shape(ds):
    """Shape of a Dataset/DataArray in coordinate order."""
    if isinstance(ds, DataArray):
        return ds.shape
    sizes = ds.sizes
    return tuple(sizes[d] for d in sizes)


def get_dims(ds):
    """The dimensions of ``ds`` in (insertion) order."""
    if isinstance(ds, DataArray):
        return ds.dims
    return tuple(ds.sizes)


def get_vars_for_dims(ds, dims, invert=False):
    """All variables in ``ds`` whose dims are a superset of ``dims``."""
    return [v for v in ds.data_vars
            if set(ds[v].dims).issuperset(set(dims)) != invert]


def expand_variables(da, dim='variable'):
    """Inverse of Dataset.to_array()."""
    return expand_variables_da(da, dim)


def _complex_data(data):
    return isinstance(data, torch.Tensor) and data.is_complex()


def is_complex(ds):
    """True if the Dataset/DataArray contains complex data."""
    if isinstance(ds, DataArray):
        return _complex_data(ds.data)
    if isinstance(ds, Dataset):
        return any(_complex_data(v.data) for v in ds._variables.values())
    raise ValueError('Not a Dataset or DataArray: {}'.format(repr(ds)))


# -------------------------------------------------------------------
# Docstring tooling (numpydoc section parser) for the functional
# wrappers.
# -------------------------------------------------------------------

def _margin(line):
    """Width of a line's leading whitespace."""
    return len(line) - len(line.lstrip())


def _is_dash_rule(line):
    """True for a numpydoc underline: dashes only (ignoring padding)."""
    body = line.strip()
    return bool(body) and set(body) == {'-'}


def parse_docstring(doc):
    """Parse a numpydoc docstring into an ordered mapping.

    Keys: ``'indent'`` (the stripped common indentation), ``None``
    (preamble lines before the first section), and one entry per
    section title mapping to a list of *blocks* — each block is the
    list of lines of one definition item (a new item begins at a line
    with no leading whitespace).
    """
    parsed = OrderedDict()
    if doc is None:
        return parsed

    raw = doc.split('\n')
    # Common indentation, measured over the body only: the first line
    # hugs the opening quotes and the closing line is artificial.
    interior = [_margin(ln) for ln in raw[1:-1] if ln.strip()] \
        if len(raw) >= 3 else []
    width = min(interior, default=0)
    lines = [ln[width:] if _margin(ln) >= width else ln for ln in raw]
    parsed['indent'] = width

    # A section header is a title line whose successor is a dash rule.
    header_at = [i for i in range(1, len(lines))
                 if _is_dash_rule(lines[i]) and lines[i - 1].strip()]

    if not header_at:
        parsed[None] = lines
        return parsed

    def _strip_trailing_blanks(chunk):
        while chunk and not chunk[-1].strip():
            chunk.pop()
        return chunk

    parsed[None] = _strip_trailing_blanks(lines[:header_at[0] - 1])
    for here, nxt in itertools.zip_longest(header_at, header_at[1:]):
        title = lines[here - 1].strip()
        end = len(lines) if nxt is None else nxt - 1
        body = _strip_trailing_blanks(lines[here + 1:end])
        # chunk into definition items in one pass: flush-left lines
        # (including blank ones) open a new item; indented lines
        # continue the current one
        blocks = []
        for ln in body:
            if _margin(ln) == 0:
                blocks.append([ln])
            elif blocks:
                blocks[-1].append(ln)
        parsed[title] = blocks
    return parsed


def assemble_docstring(parsed, sig=None):
    """Assemble a docstring from the parse_docstring() representation.

    With ``sig``, the ``Parameters`` blocks are re-ordered to follow
    the signature; blocks naming no known parameter keep their
    relative order after the known ones (sorted is stable).
    """
    parsed = parsed.copy()
    pad = ' ' * parsed.pop('indent', 0)

    if sig is not None and parsed.get('Parameters'):
        rank = {name: i for i, name in enumerate(sig.parameters)}

        def block_rank(block):
            described = block[0].partition(':')[0].strip(' *')
            return rank.get(described, len(rank))

        parsed['Parameters'] = sorted(parsed['Parameters'],
                                      key=block_rank)

    out = []
    for title, content in parsed.items():
        if not content:
            continue
        if isinstance(content[0], list):     # section: list of blocks
            body = itertools.chain.from_iterable(content)
        else:                                # preamble: plain lines
            body = content
        if title is not None:
            out += ['', pad + title, pad + '-' * len(title)]
        out += [(pad + ln).rstrip() for ln in body]
    return '\n'.join(out)


def extract_arguments(fn, args, kwargs):
    """Match ``args``/``kwargs`` to fn's named parameters; whatever
    does not fit lands in the ``'args'`` / ``'kwargs'`` entries of the
    returned dict (always present, even when empty). ``self`` is
    ignored so unbound methods can be passed directly.
    """
    params = [p for p in inspect.signature(fn).parameters.values()
              if p.name != 'self']
    named = [p for p in params
             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                           p.KEYWORD_ONLY)]
    out = OrderedDict()
    overflow_pos = []
    for i, value in enumerate(args):
        slot = named[i] if i < len(named) else None
        if slot is not None and slot.kind != slot.KEYWORD_ONLY:
            out[slot.name] = value
        else:
            overflow_pos.append(value)
    overflow_kw = {}
    by_name = {p.name: p for p in named}
    for key, value in kwargs.items():
        if key in out:
            raise TypeError('%s() got multiple values for %r'
                            % (getattr(fn, '__name__', fn), key))
        if key in by_name:
            out[key] = value
        else:
            overflow_kw[key] = value
    for p in named:
        if p.name not in out:
            if p.default is inspect.Parameter.empty:
                raise TypeError('%s() missing required argument: %r'
                                % (getattr(fn, '__name__', fn), p.name))
            out[p.name] = p.default
    out['args'] = tuple(overflow_pos)
    out['kwargs'] = overflow_kw
    return out
