"""Helpers: ``as_tensor`` (where non-tensor input lands: ``cuda`` unless
the caller names a device), dims and shapes, dependency checks, date
parsing, chunking and halo split/merge (``xr_split``/``xr_merge``), the
parallel chunk map (``parallel``), gufunc-style ``apply`` over
``torch.vmap``, variable selection, complex detection and the docstring
and argument tooling that :func:`nd_tpu_torch.algorithm.wrap_algorithm`
uses.

Counterpart of ``nd_tpu/utils.py``.
"""

from __future__ import annotations

import datetime
import functools
import importlib
import inspect
import itertools
import os
import re
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from functools import wraps

import numpy as np
import torch

from .core import DataArray, Dataset
from .core.dataarray import _STACK_ATTR, concat, expand_variables_da
from .core.variable import as_tensor, to_numpy

__all__ = ['as_tensor', 'get_dims', 'get_shape', 'get_vars_for_dims',
           'expand_variables', 'is_complex', 'ncpus', 'squeeze',
           'str2date', 'dict_product', 'chunks', 'array_chunks',
           'block_split', 'block_merge', 'xr_split', 'xr_merge',
           'parallel', 'select', 'apply', 'requires', 'check_requirements',
           'parse_docstring', 'assemble_docstring', 'extract_arguments']


# -------------------------------------------------------------------
# Dependency checks: the port owns the chi-square CDF and the warping
# natively ('gsl', 'gdal'); other names are probed as importable modules.
# -------------------------------------------------------------------
check_dependencies = {'gsl': True, 'gdal': True}


def check_requirements(dependency=()):
    def _check(dep):
        if dep in check_dependencies:
            return check_dependencies[dep]
        try:
            importlib.import_module(dep)
        except ImportError:
            return False
        return True

    if isinstance(dependency, (list, tuple)):
        return all(_check(d) for d in dependency)
    return _check(dependency)


def requires(dependency=()):
    """Declare that a class or function needs optional dependencies:
    calling it (instantiating a class) while one is missing raises
    ImportError. Decorated classes carry ``_requires`` and ``_skip``."""
    available = check_requirements(dependency)

    def decorator(obj):
        is_class = inspect.isclass(obj)
        target = obj.__init__ if is_class else obj

        @wraps(target)
        def guarded(*args, **kwargs):
            if not available:
                raise ImportError('missing dependencies {!r} (required by '
                                  '{})'.format(dependency,
                                               getattr(obj, '__name__', obj)))
            return target(*args, **kwargs)

        if not is_class:
            return guarded
        obj.__init__ = guarded
        obj._requires = dependency
        obj._skip = not available
        return obj

    return decorator


def ncpus():
    return os.cpu_count() or 1


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


def squeeze(obj):
    """The item of a length-1 array, else the object."""
    try:
        return obj.item()
    except (ValueError, AttributeError, RuntimeError):
        return obj


# forms that ISO 8601 does not cover, read with strptime: SNAP's
# BEAM-DIMAP headers (03-Jan-2023 10:00:00.000000), slashed year-first
# dates and month-name dates
_STRPTIME_FORMATS = ('%d-%b-%Y %H:%M:%S.%f', '%d-%b-%Y %H:%M:%S',
                     '%d-%b-%Y', '%Y/%m/%d %H:%M:%S.%f', '%Y/%m/%d %H:%M:%S',
                     '%Y/%m/%d', '%b %d %Y %H:%M:%S', '%b %d %Y')
# an ISO-like date whose fields after the year need not be zero-padded,
# as CF epochs write it ('1970-1-1 0:0:0', '... UTC')
_LOOSE_ISO = re.compile(
    r'(\d{4})-(\d{1,2})-(\d{1,2})(?:[ T](\d{1,2}):(\d{1,2})'
    r'(?::(\d{1,2})(?:\.(\d{1,6})\d*)?)?)?\s*(Z|UTC|GMT)?$')
# day and month in either order with one separator: pandas reads
# 03.01.2023 as 1 March, a European reader as 3 January
_AMBIGUOUS = re.compile(r'\d{1,2}([./-])\d{1,2}\1\d{2,4}$')


def str2date(string, fmt=None, tz=False):
    """Parse a date string to a datetime (tz-aware UTC with ``tz``).
    Without ``fmt`` the string is ISO 8601 (dates, times, offsets, 'Z';
    fields need not be zero-padded), SNAP's ``03-Jan-2023 10:00:00.000``,
    ``2023/01/03`` or ``Jan 3 2023``, read without pandas. A date whose
    day and month could be either way round (``03.01.2023``) raises."""
    if fmt is not None:
        date_object = datetime.datetime.strptime(string, fmt)
    else:
        date_object = _parse_date(string.strip())
    if tz:
        if date_object.tzinfo is None:
            date_object = date_object.replace(tzinfo=datetime.timezone.utc)
    elif date_object.tzinfo is not None:
        date_object = date_object.replace(tzinfo=None)
    return date_object


def _parse_date(string):
    try:
        return datetime.datetime.fromisoformat(string)
    except ValueError:
        pass
    m = _LOOSE_ISO.match(string)
    if m:
        y, mo, d, h, mi, sec, frac, utc = m.groups()
        return datetime.datetime(
            int(y), int(mo), int(d), int(h or 0), int(mi or 0),
            int(sec or 0), int((frac or '0').ljust(6, '0')),
            tzinfo=datetime.timezone.utc if utc else None)
    if _AMBIGUOUS.match(string):
        raise ValueError('ambiguous date %r: the day and the month could '
                         'be either way round; pass fmt=' % string)
    for form in _STRPTIME_FORMATS:
        try:
            return datetime.datetime.strptime(string, form)
        except ValueError:
            continue
    try:
        return np.datetime64(string, 'us').astype(datetime.datetime)
    except ValueError:
        raise ValueError('unrecognised date %r: not ISO 8601, nor one of '
                         'the forms %s' % (string, ', '.join(
                             _STRPTIME_FORMATS))) from None


def dict_product(d):
    """itertools.product over a dict of lists."""
    return (dict(zip(d, x)) for x in itertools.product(*d.values()))


def chunks(lst, n):
    """Yield successive n-sized chunks from ``lst``."""
    for i in range(0, len(lst), n):
        yield lst[i:i + n]


def array_chunks(array, n, axis=0, return_indices=False):
    """Chunk an array (or tensor) along ``axis``."""
    if axis >= array.ndim:
        raise ValueError('axis {:d} is out of range for given array.'
                         .format(axis))
    for i in range(0, array.shape[axis], n):
        indices = [slice(None)] * array.ndim
        indices[axis] = slice(i, i + n)
        if return_indices:
            yield indices, array[tuple(indices)]
        else:
            yield array[tuple(indices)]


def block_split(array, blocks):
    """Split an array into sub-arrays (first axis outermost)."""
    if array.ndim != len(blocks):
        raise ValueError("Length of 'blocks' must equal array "
                         "dimensionality.")
    result = [array]
    for axis, nblocks in enumerate(blocks):
        split = (lambda a: list(torch.tensor_split(a, nblocks, dim=axis))) \
            if isinstance(array, torch.Tensor) \
            else (lambda a: np.array_split(a, nblocks, axis=axis))
        result = [item for a in result for item in split(a)]
    return result


def block_merge(array_list, blocks):
    """Inverse of block_split: the flat list (first axis outermost)
    joined back into one array."""
    blocks = tuple(int(b) for b in blocks)
    if len(array_list) != int(np.prod(blocks)):
        raise ValueError('block_merge: got %d blocks but grid %r needs %d'
                         % (len(array_list), blocks, int(np.prod(blocks))))
    if not isinstance(array_list[0], torch.Tensor):
        grid = np.empty(blocks, dtype=object)
        for idx, arr in zip(np.ndindex(*blocks), array_list):
            grid[idx] = arr
        return np.block(grid.tolist())
    parts = list(array_list)
    for axis in reversed(range(len(blocks))):
        n = blocks[axis]
        parts = [torch.cat(parts[i:i + n], dim=axis)
                 for i in range(0, len(parts), n)]
    return parts[0]


def xr_split(ds, dim, chunks, buffer=0):
    """Split a Dataset or DataArray into overlapping chunks along ``dim``:
    balanced cores (sizes differ by at most one), each widened by
    ``buffer`` on the sides that have a neighbour. The chunk count is
    clamped so that every core is at least ``buffer + 1`` wide, so that
    :func:`xr_merge` can trim the halos."""
    n = ds.sizes[dim]
    max_chunks = max(1, n // (buffer + 1)) if buffer > 0 \
        else max(1, min(chunks, n))
    chunks = max(1, min(chunks, max_chunks))
    base, extra = divmod(n, chunks)
    sizes = [base + 1 if i < extra else base for i in range(chunks)]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    for i in range(chunks):
        low = int(max(starts[i] - buffer, 0))
        high = int(min(starts[i + 1] + buffer, n))
        yield ds.isel({dim: slice(low, high)})


def xr_merge(ds_list, dim, buffer=0):
    """Inverse of xr_split: trim ``buffer`` on every side that has a
    neighbour (none at the ends) and concatenate."""
    b, last = int(buffer), len(ds_list) - 1
    if b > 0 and last > 0:
        parts = [ds.isel({dim: slice(b if i else None,
                                     -b if i < last else None)})
                 for i, ds in enumerate(ds_list)]
    else:
        parts = list(ds_list)
    return concat(parts, dim=dim)


def _on_card(obj):
    tables = [obj._coords] + ([obj._variables] if isinstance(obj, Dataset)
                              else [{'': obj.variable}])
    return any(isinstance(v.data, torch.Tensor) and v.data.device.type
               != 'cpu' for t in tables for v in t.values())


def _invoke_chunk(fn, args, kwargs, part):
    """Module-level chunk applier (picklable for process pools)."""
    return fn(part, *args, **kwargs)


def parallel(fn, dim=None, chunks=None, chunksize=None, merge=True,
             buffer=0, use_threads=True, scheduler=None):
    """Parallelize a function taking a Dataset as first argument: split
    along ``dim`` (default 'y') into ``chunks`` (default: the CPU count)
    with a ``buffer`` halo, map, trim and concatenate.

    ``scheduler``: ``'threads'`` (default) runs the chunks on a thread
    pool, CUDA payloads included (each kernel wrapper launches on the
    caller's current stream; the launch counters and caches are locked);
    ``'processes'`` runs each chunk in a spawned worker process, for CPU
    payloads only (``fn`` and its arguments picklable, module-level; a
    script calls it under ``if __name__ == '__main__':``): a CUDA payload
    raises ValueError, since each worker would start its own CUDA
    context; ``'serial'`` maps in-line. ``use_threads=False`` is the
    older spelling of ``'serial'``.
    """
    if dim is None:
        dim = 'y'
    if chunks is None:
        chunks = ncpus()
    if scheduler is None:
        scheduler = 'threads' if use_threads else 'serial'
    if scheduler not in ('threads', 'processes', 'serial'):
        raise ValueError("scheduler must be 'threads', 'processes' or "
                         "'serial', got %r" % (scheduler,))

    def wrapper(ds, *args, **kwargs):
        if dim not in ds.sizes:
            raise ValueError("The dataset has no dimension '{}'."
                             .format(dim))
        if scheduler == 'processes' and _on_card(ds):
            raise ValueError(
                "scheduler='processes' takes CPU payloads only: each "
                'spawned worker would start its own CUDA context; use '
                "scheduler='threads' for tensors on the card")
        parts = list(xr_split(ds, dim=dim, chunks=chunks, buffer=buffer))
        call = functools.partial(_invoke_chunk, fn, args, kwargs)
        if scheduler == 'threads' and len(parts) > 1:
            with ThreadPoolExecutor(max_workers=len(parts)) as pool:
                output = list(pool.map(call, parts))
        elif scheduler == 'processes' and len(parts) > 1:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            with ProcessPoolExecutor(
                    max_workers=min(len(parts), ncpus()),
                    mp_context=mp.get_context('spawn')) as pool:
                output = list(pool.map(call, parts))
        else:
            output = [call(p) for p in parts]
        if merge:
            return xr_merge(output, dim=dim, buffer=buffer)
        return output

    return wrapper


def select(objects, fn, unlist=True, first=False):
    """The subset of ``objects`` (a list or dict) matching ``fn``."""
    filtered = objects
    if type(objects) is list:
        filtered = [obj for obj in filtered if fn(obj)]
    elif type(objects) is dict:
        filtered = {k: v for k, v in filtered.items() if fn(v)}
    if first:
        if len(filtered) == 0:
            return None
        if type(filtered) is list:
            return filtered[0]
        if type(filtered) is dict:
            return filtered[list(filtered.keys())[0]]
    elif unlist and len(filtered) == 1 and type(filtered) is list:
        return filtered[0]
    else:
        return filtered


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
# gufunc-style apply: torch.vmap over the stacked dimension, and the
# per-element host route (np.vectorize) for functions vmap cannot take.
# -------------------------------------------------------------------

# which route each apply call took (read by chip_smoke.py); under
# routes_lock, as njobs threads may call apply
routes = {'vmap': 0, 'host': 0}
routes_lock = threading.Lock()

# the messages of vmap's own incompatibility errors: .item() and
# data-dependent control flow, a batched tensor handed to numpy, a
# missing batching rule
_VMAP_INCOMPATIBLE = re.compile(
    r"vmap: It looks like|doesn't have storage|[Bb]atching rule")


def _parse_signature(sig):
    m = re.fullmatch(r'\((.*)\)->\((.*)\)', sig.replace(' ', ''))
    if m is None:
        raise ValueError('Invalid signature')
    return tuple(group.split(',') if group else [] for group in m.groups())


def apply(ds, fn, signature=None, njobs=1):
    """Apply a function that operates on a subset of dimensions.

    Parameters
    ----------
    ds : Dataset or DataArray
    fn : callable
        Takes a tensor whose dims follow ``signature`` (a numpy array on
        the host route).
    signature : str, optional
        e.g. ``'(time,var)->(time)'`` (the default). With ``var``, the
        variables are stacked into a dimension first.
    njobs : int, optional
        Kept for API parity; the vmap route is already data-parallel.

    ``fn`` runs under ``torch.vmap`` over the other dims stacked into
    one; only vmap's own incompatibility errors (``.item()``,
    data-dependent control flow, numpy on a batched tensor, a missing
    batching rule) send it to the per-element host route
    (``np.vectorize``); any other error propagates. ``routes`` counts the
    calls of each route. The result stays on the input's device.
    """
    signature = signature or '(time,var)->(time)'
    dims_in, dims_out = _parse_signature(signature)
    if dims_out and not set(dims_out).issubset(dims_in):
        raise ValueError('Invalid signature: All output dimensions must '
                         'also be input dimensions.')
    if isinstance(ds, Dataset) and 'var' in dims_in:
        ds = ds.to_array(dim='var')

    def _apply_da(da):
        removed = set(dims_in) - set(dims_out)
        output_dims = [d for d in da.dims if d not in removed]
        extra = tuple(d for d in da.dims if d not in dims_in)
        stacked = da.stack(z=extra).transpose('z', *dims_in)
        data = stacked.data
        try:
            out = torch.vmap(fn)(data)
            route = 'vmap'
        except (RuntimeError, TypeError, NotImplementedError) as err:
            if not _VMAP_INCOMPATIBLE.search(str(err)):
                raise
            out = np.vectorize(fn, signature=signature)(to_numpy(data))
            out = torch.as_tensor(np.asarray(out), device=data.device)
            route = 'host'
        with routes_lock:
            routes[route] += 1
        res_dims = ('z',) + tuple(dims_out)
        res = DataArray(out, dims=res_dims)
        res._coords = {k: v for k, v in stacked._coords.items()
                       if set(v.dims).issubset(set(res_dims))}
        res.attrs[_STACK_ATTR] = stacked.attrs[_STACK_ATTR]
        return res.unstack().transpose(*output_dims)

    if isinstance(ds, DataArray):
        result = _apply_da(ds)
    else:
        result = ds.map(_apply_da)
        live = set()
        for v in result._variables.values():
            live |= set(v.dims)
        result._coords = {k: v for k, v in result._coords.items()
                          if set(v.dims).issubset(live)}
    if isinstance(result, DataArray) and 'var' in result.dims:
        result = expand_variables(result, dim='var')
    return result


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
