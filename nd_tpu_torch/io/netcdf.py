"""netCDF read and write: netCDF-4 (HDF5) through ``h5py``; netCDF
classic read here and written through ``scipy.io.netcdf_file``.

Counterpart of ``nd_tpu/io/netcdf.py``, on the port's data model:
numeric variables land on ``device`` (``cuda`` unless the caller names
another), datetimes and strings stay numpy, and a CUDA dataset is
written with one host copy per variable.

  - Reading: a classic file (magic ``CDF``, versions 1 and 2) reads
    through the header parser and positional reads here
    (:func:`_classic_layout`, :func:`_read_classic_slab`), any other
    through ``h5py`` (dimension scales, phony dims, ``_FillValue``,
    ``missing_value``, scale and offset, gzip, bool stored as int8, 2-D
    and scalar coordinates). ``h5py`` is imported where it is used, so a
    machine without it still reads and writes classic files.
  - Writing (:func:`write_netcdf_file`): netCDF-4 where ``h5py``
    imports, as the JAX package writes; otherwise netCDF classic, 64-bit
    offset (CDF-2), uncompressed (:func:`_write_netcdf_classic`).
    :func:`writer` says which. Both write to ``<path>.part`` and rename.
  - CF time is decoded without pandas, on numpy ``datetime64[ns]``, with
    pandas' rounding of float offsets (:func:`_decode_cf_time`).
  - A lazy open (``chunks=``) makes the numeric data variables
    :class:`~nd_tpu_torch.io.lazy.LazyNetCDFArray` views on either route;
    each slab read runs the same CF decode. Classic slabs are read at
    their offsets, never through a memory mapping.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

from ..core import Dataset
from ..core.variable import Variable

_NOT_A_VARIABLE = b'This is a netCDF dimension but not a netCDF variable'

__all__ = ['open_netcdf_file', 'write_netcdf_file', 'writer']


def _h5py():
    """The ``h5py`` module, or None where it is not installed."""
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def writer():
    """The format :func:`write_netcdf_file` writes on this machine:
    ``'netCDF-4'`` where ``h5py`` imports, else ``'netCDF classic
    (CDF-2)'``."""
    return 'netCDF-4' if _h5py() is not None else 'netCDF classic (CDF-2)'


# ---------------------------------------------------------------------------
# CF time handling
# ---------------------------------------------------------------------------

# nanoseconds per CF unit
_UNIT_NS = {'nanoseconds': 1, 'microseconds': 1_000,
            'milliseconds': 1_000_000, 'seconds': 1_000_000_000,
            'minutes': 60_000_000_000, 'hours': 3_600_000_000_000,
            'days': 86_400_000_000_000, 'weeks': 604_800_000_000_000}
_INT64_MAX = np.iinfo(np.int64).max


def _parse_epoch(epoch):
    """A CF epoch string as ``datetime64[ns]`` (UTC where it carries an
    offset); raises ValueError if it does not parse."""
    import datetime
    from ..utils import str2date
    d = str2date(epoch, tz=True)
    d = d.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return np.datetime64(d, 'ns')


def _parse_time_units(units):
    """CF time units -> (nanoseconds per unit, epoch) or None."""
    m = re.match(
        r'(?i)\s*(nanoseconds|microseconds|milliseconds|seconds|minutes'
        r'|hours|days|weeks)\s+since\s+(.+)', str(units))
    if not m:
        return None
    unit_name, epoch = m.groups()
    try:
        epoch = _parse_epoch(epoch.strip())
    except (ValueError, OverflowError):
        # an unparseable epoch leaves the variable undecoded (with
        # its units attr) instead of failing the open
        return None
    return _UNIT_NS[unit_name.lower()], epoch


def _float_to_ns(values, per):
    """Float offsets in units of ``per`` nanoseconds as int64 ns, rounded
    as pandas' ``to_timedelta`` rounds them: the whole units times
    ``per``, plus the fraction (rounded to as many decimals as ``per``
    has digits, less one) times ``per``, each truncated toward zero."""
    base = values.astype(np.int64)
    frac = values - base
    p = len(str(per)) - 1
    if p:
        frac = np.round(frac, p)
    return base * per + (frac * per).astype(np.int64)


def _decode_cf_time(values, units, calendar=None):
    """CF time offsets as ``datetime64[ns]`` (NaN -> NaT), or None where
    the units are not CF time units."""
    parsed = _parse_time_units(units)
    if parsed is None:
        return None
    per, epoch = parsed
    vals = np.asarray(values)
    flat = vals.ravel()
    integer = np.issubdtype(flat.dtype, np.integer)
    flat = flat.astype(np.int64 if integer else np.float64)
    nat = np.zeros(flat.shape, bool) if integer else np.isnan(flat)
    if (~nat).any() and np.abs(flat[~nat]).max() > _INT64_MAX // per:
        raise OverflowError('time offsets in %r overflow datetime64[ns]'
                            % units)
    if integer:
        nanos = flat * per
    else:
        with np.errstate(invalid='ignore'):
            whole = flat.astype(np.int64)
            if per == 1 or not (nat | (flat == whole)).all():
                nanos = _float_to_ns(np.where(nat, 0.0, flat), per)
            else:
                nanos = np.where(nat, 0, whole) * per
    out = epoch + nanos.astype('timedelta64[ns]')
    out[nat] = np.datetime64('NaT')
    return out.reshape(vals.shape)


def _encode_cf_time(values):
    """int64 offsets from 1970: microseconds where that is exact, else
    nanoseconds (the netCDF-4 route)."""
    vals = np.asarray(values).astype('datetime64[ns]')
    epoch = np.datetime64('1970-01-01T00:00:00', 'ns')
    nanos = (vals - epoch).astype('timedelta64[ns]').astype(np.int64)
    if (nanos % 1000 == 0).all():
        # microsecond resolution suffices: stay compatible with readers
        # that don't know nanoseconds
        return nanos // 1000, 'microseconds since 1970-01-01 00:00:00'
    return nanos, 'nanoseconds since 1970-01-01 00:00:00'


def _encode_cf_time_classic(values, name):
    """float64 microseconds from 1970, NaT as NaN (the classic route,
    which has no int64). Raises where a value is not exact in float64."""
    vals = np.asarray(values).astype('datetime64[ns]')
    nat = np.isnat(vals)
    nanos = (vals - np.datetime64('1970-01-01T00:00:00', 'ns')) \
        .astype(np.int64)[~nat]
    if (nanos % 1000).any() or (np.abs(nanos // 1000) > 2 ** 53).any():
        raise ValueError(
            'netCDF classic has no int64: %r is stored as float64 '
            'microseconds since 1970, and a value of it is not exact '
            'there (sub-microsecond, or beyond 2**53 us)' % name)
    out = np.full(vals.shape, np.nan)
    out[~nat] = nanos // 1000
    return out, 'microseconds since 1970-01-01 00:00:00'


# ---------------------------------------------------------------------------
# attribute coercion
# ---------------------------------------------------------------------------

def _coerce_attr(value):
    """Make an attribute serializable."""
    from ..crs import CRS, Affine
    if isinstance(value, CRS):
        return value.to_proj4()
    if isinstance(value, Affine):
        return tuple(value)
    if isinstance(value, (list, tuple)) and value and \
            all(isinstance(v, (int, float, np.integer, np.floating))
                for v in value):
        return np.asarray(value)
    if isinstance(value, (str, bytes, int, float, np.integer, np.floating,
                          np.ndarray, np.bool_)):
        return value
    return str(value)


def _decode_attr(value):
    if isinstance(value, bytes):
        return value.decode('utf-8', 'replace')
    if isinstance(value, np.ndarray) and value.ndim == 1 \
            and value.size == 1:
        v = value[0]
        return v.decode() if isinstance(v, bytes) else v.item() \
            if hasattr(v, 'item') else v
    if isinstance(value, np.generic):
        v = value.item()
        return v.decode('utf-8', 'replace') if isinstance(v, bytes) else v
    return value


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _cf_transform(fill, missing, scale, offset, time_units, calendar,
                  to_bool):
    """The CF decode of one variable's values. CF order: sentinels
    compare against the RAW stored values (both _FillValue and the
    legacy missing_value convention), then unpack, then interpret time;
    masked entries of time variables become NaT. A declared sentinel
    makes the result float even where the file holds no fill."""
    def decode(data):
        mask = None
        for sentinel in (fill, missing):
            if sentinel is None:
                continue
            sv = np.asarray(sentinel).ravel()
            if sv.size and not (np.issubdtype(sv.dtype, np.floating)
                                and np.isnan(sv[0])):
                mm = data == sv[0]
                mask = mm if mask is None else (mask | mm)
        if scale is not None or offset is not None:
            data = data.astype('float64')
            if scale is not None:
                data = data * scale
            if offset is not None:
                data = data + offset
        if time_units is not None:
            decoded = _decode_cf_time(data, time_units, calendar)
        else:
            decoded = None
        if decoded is not None:
            data = decoded
            if mask is not None:
                data = data.copy()
                data[mask] = np.datetime64('NaT')
        elif mask is not None:
            if not np.issubdtype(data.dtype, np.floating):
                data = data.astype('float64')
            data = np.where(mask, np.nan, data)
        if to_bool:
            data = data.astype(bool)
        return data

    return decode


def _cf_decode_for(attrs, dtype_kind, with_bool=True):
    """Extract + consume the CF decode parameters from ``attrs`` and
    return the decode closure (or None when nothing applies). One
    implementation for the HDF5 and the classic readers."""
    fill = attrs.pop('_FillValue', None)
    missing = attrs.pop('missing_value', None)
    scale = attrs.pop('scale_factor', None)
    offset = attrs.pop('add_offset', None)
    units = attrs.get('units')
    cal = attrs.get('calendar')
    std_cal = cal is None or str(cal).lower() in (
        'standard', 'gregorian', 'proleptic_gregorian')
    # Non-standard calendars (360_day, noleap, ...) stay undecoded
    # with their attrs: silently wrong proleptic dates are worse.
    decode_time = bool(units) and std_cal and dtype_kind in 'iuf' \
        and _parse_time_units(units) is not None
    to_bool = with_bool and attrs.get('dtype') == 'bool'
    if decode_time:
        attrs.pop('units', None)
        attrs.pop('calendar', None)
    if to_bool:
        attrs.pop('dtype')
    if (fill is not None or missing is not None or scale is not None
            or offset is not None or decode_time or to_bool):
        return _cf_transform(fill, missing, scale, offset,
                             units if decode_time else None, cal, to_bool)
    return None


def _dataset(variables, coords, attrs, device):
    """A Dataset of numpy (dims, data, attrs) triples: numeric data as
    tensors on ``device``."""
    ds = Dataset(attrs=attrs)
    ds._coords = {k: Variable(d, v, a, device=device)
                  for k, (d, v, a) in coords.items()}
    ds._variables = {k: Variable(d, v, a, device=device)
                     for k, (d, v, a) in variables.items()}
    return ds


def _lazy_view(path, name, shape, stored_dtype, decode, where=None):
    """A lazy view of one variable (``where``: a classic variable's
    ``(begin, stride, shape, dtype)``); the decode is dtype-stable, so one
    synthetic element gives every slab's dtype without a read."""
    from .lazy import LazyNetCDFArray
    stored_dtype = np.dtype(stored_dtype).newbyteorder('=')
    dtype = stored_dtype if decode is None \
        else decode(np.ones(1, stored_dtype)).dtype
    return LazyNetCDFArray(str(path), name, shape, dtype, decode=decode,
                           classic=where)


def _promote_coords(variables, coords, names):
    """Move the variables named as CF coordinates to ``coords``, read:
    coordinates stay eager (they index everything else)."""
    for cname in names:
        if cname in variables:
            d, v, a = variables.pop(cname)
            coords[cname] = (d, np.asarray(v), a)
    for _, _, a in variables.values():
        a.pop('coordinates', None)


def open_netcdf_file(path, decode_cf=True, chunks=None, device=None):
    """Read a netCDF file (netCDF-4/HDF5 or classic) into a Dataset with
    its numeric data on ``device`` (default ``cuda``).

    With ``chunks`` (any value, ``{}`` included) the data variables that
    are not coordinates, have at least one dimension and a numeric type
    become lazy views (:class:`~nd_tpu_torch.io.lazy.LazyNetCDFArray`):
    nothing of them is read until they are used, and an ``isel`` reads
    only its own slab. Coordinates and strings stay eager."""
    with open(path, 'rb') as fh:
        magic = fh.read(3)
    if magic == b'CDF':
        # netCDF classic is not an HDF5 container: CDF-1/2 files are read
        # here without h5py (_classic_layout, _read_classic_slab), CDF-5
        # raises
        return _open_netcdf_classic(path, decode_cf=decode_cf,
                                    device=device, chunks=chunks)
    h5py = _h5py()
    if h5py is None:
        raise ImportError('h5py is required to read netCDF-4 (HDF5) files '
                          'such as %s' % path)
    with h5py.File(path, 'r') as f:
        dim_names = {}     # dataset-name -> dim name (for scales)
        coord_like = set()
        phony_count = [0]

        def is_scale(obj):
            return obj.attrs.get('CLASS') == b'DIMENSION_SCALE'

        # First pass: find dimension scales
        for name, obj in f.items():
            if isinstance(obj, h5py.Dataset) and is_scale(obj):
                dim_names[name] = name
                nc_name = obj.attrs.get('NAME', b'')
                if not (isinstance(nc_name, bytes)
                        and nc_name.startswith(_NOT_A_VARIABLE)):
                    coord_like.add(name)

        phony_by_size = {}

        def _phony(size):
            # one phony dim per distinct size (h5netcdf-style): equal-
            # shape scale-less variables share dims
            if size not in phony_by_size:
                phony_by_size[size] = 'phony_dim_%d' % phony_count[0]
                phony_count[0] += 1
            return phony_by_size[size]

        def _phony_unique(size, used):
            d = _phony(size)
            while d in used:        # square arrays need distinct dims
                d = 'phony_dim_%d' % phony_count[0]
                phony_count[0] += 1
            used.add(d)
            return d

        def dims_for(obj, name):
            used = set()
            if 'DIMENSION_LIST' in obj.attrs:
                out = []
                for i, refs in enumerate(obj.attrs['DIMENSION_LIST']):
                    if len(refs):
                        out.append(f[refs[0]].name.lstrip('/'))
                    else:
                        out.append(_phony_unique(obj.shape[i], used))
                return tuple(out)
            if name in dim_names:
                return (name,)
            return tuple(_phony_unique(s, used) for s in obj.shape)

        variables = {}
        coords = {}
        extra_coord_names = set()
        for name, obj in f.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            attrs = {k: _decode_attr(v) for k, v in obj.attrs.items()
                     if k not in ('CLASS', 'NAME', 'DIMENSION_LIST',
                                  'REFERENCE_LIST', '_Netcdf4Dimid',
                                  '_Netcdf4Coordinates')}
            dims = dims_for(obj, name)
            decode = _cf_decode_for(attrs, obj.dtype.kind) \
                if decode_cf else None
            if (chunks is not None and name not in coord_like
                    and obj.ndim >= 1 and obj.dtype.kind in 'iufc'):
                data = _lazy_view(path, obj.name, obj.shape, obj.dtype,
                                  decode)
            else:
                data = obj[()]
                if isinstance(data, (bytes, str)):
                    # scalar variable-length string datasets come back
                    # as plain python objects with no .dtype
                    data = np.asarray(data)
                if decode is not None:
                    data = decode(np.asarray(data))
                if data.dtype.kind in ('S', 'O'):
                    try:
                        data = np.char.decode(data.astype('S'), 'utf-8')
                    except (UnicodeDecodeError, TypeError, ValueError):
                        pass        # not text: keep the stored bytes

            if name in coord_like:
                coords[name] = (dims, data, attrs)
            else:
                cattr = attrs.get('coordinates')
                if cattr:
                    extra_coord_names.update(str(cattr).split())
                variables[name] = (dims, data, attrs)

        # variables referenced as CF "coordinates" (per-variable attrs
        # or the writer's group-level record) become coords
        group_coords = f.attrs.get('_nd_tpu_coordinates')
        if group_coords is not None:
            extra_coord_names.update(_decode_attr(group_coords).split())
        _promote_coords(variables, coords, extra_coord_names)
        gattrs = {k: _decode_attr(v) for k, v in f.attrs.items()
                  if not str(k).startswith('_nd_tpu')}
    return _dataset(variables, coords, gattrs, device)


def _open_netcdf_classic(path, decode_cf=True, device=None, chunks=None):
    """Read a netCDF classic (CDF-1/2) file, with the same CF conventions
    as the HDF5 path: fill / missing_value masking, scale/offset
    unpacking, standard-calendar time decode, dimension-named variables
    as coordinates, and CF ``coordinates`` attribute promotion. A bool
    stored as int8 stays int8 (with its ``dtype`` attr), as in the JAX
    package. With ``chunks`` the numeric data variables are lazy views
    that read their slabs at their offsets."""
    dim_sizes, gattrs, layout = _classic_layout(path)
    variables = {}
    coords = {}
    extra_coord_names = set()
    for name, dims, raw_attrs, dtype, shape, begin, stride in layout:
        attrs = {k: _decode_attr(val) for k, val in raw_attrs.items()}
        # a record (unlimited) dim takes its size from the records
        for d, n in zip(dims, shape):
            if dim_sizes.get(d) in (None, 0):
                dim_sizes[d] = n
        is_coord = name in dim_sizes and dims == (name,)
        decode = _cf_decode_for(attrs, dtype.kind, with_bool=False) \
            if decode_cf else None
        where = (begin, stride, shape, dtype)
        if chunks is not None and not is_coord and shape \
                and dtype.kind in 'iufc':
            data = _lazy_view(path, name, shape, dtype, decode, where)
        else:
            data = _read_classic_slab(path, *where,
                                      tuple(slice(0, n) for n in shape))
            if data.dtype.kind == 'S' and data.ndim >= 1:
                try:
                    data = np.char.decode(data, 'utf-8')
                except UnicodeDecodeError:
                    pass        # not text: keep the stored bytes
            if decode is not None:
                data = decode(data)
        if is_coord:
            coords[name] = (dims, data, attrs)
        else:
            cattr = attrs.get('coordinates')
            if cattr:
                extra_coord_names.update(str(cattr).split())
            variables[name] = (dims, data, attrs)
    _promote_coords(variables, coords, extra_coord_names)
    gattrs = {k: _decode_attr(val) for k, val in gattrs.items()}
    return _dataset(variables, coords, gattrs, device)


# The classic slab reader reads one block of whole rows where the bytes it
# reads beyond what a read per row would read cost less time than the row
# reads it saves: one read call costs about the time of reading, swapping
# and copying this many bytes. chip_smoke.py times both routes: O1 alone
# on first reads by window width, O3 in tile()'s thread pool, where a
# read call costs several times more; the constant follows the pool's
# cost, and PERF.md keeps the numbers.
_READ_CALL_BYTES = 100 << 10

# netCDF classic's external types (CDF-1 and CDF-2)
_CLASSIC_NC_TYPES = {1: np.dtype('>i1'), 2: np.dtype('S1'),
                     3: np.dtype('>i2'), 4: np.dtype('>i4'),
                     5: np.dtype('>f4'), 6: np.dtype('>f8')}


def _classic_layout(path):
    """The header of a netCDF classic file (CDF-1 or CDF-2), read without
    its data: ``(dims, global attrs, variables)``; dims map names to sizes
    (0 for the record dimension), each variable is ``(name, dims, attrs,
    stored dtype, shape, begin, stride)``, its data starting at byte
    ``begin`` with its first axis' elements ``stride`` bytes apart.
    Attribute values are what ``scipy.io.netcdf_file`` gives (numbers as
    big-endian arrays, one as a scalar; text as bytes)."""
    with open(path, 'rb') as fh:
        def read(n):
            raw = fh.read(n)
            if len(raw) != n:
                raise ValueError('%s: truncated netCDF classic header'
                                 % path)
            return raw

        def integer():
            return struct.unpack('>i', read(4))[0]

        def name():
            n = integer()
            raw = read(n)
            read(-n % 4)
            return raw.rstrip(b'\0').decode('latin1')

        def count(tag):
            if read(4) not in (b'\0\0\0\0', tag):
                raise ValueError('%s: not a netCDF classic header' % path)
            return integer()

        def nc_type():
            t = integer()
            if t not in _CLASSIC_NC_TYPES:
                raise ValueError('%s: netCDF type %d is not a CDF-1/2 type'
                                 % (path, t))
            return _CLASSIC_NC_TYPES[t]

        def attributes():
            out = {}
            for _ in range(count(b'\0\0\0\x0c')):
                key, dtype, n = name(), nc_type(), integer()
                raw = read(n * dtype.itemsize)
                read(-(n * dtype.itemsize) % 4)
                if dtype.kind == 'S':
                    out[key] = raw.rstrip(b'\0')
                else:
                    val = np.frombuffer(raw, dtype).copy()
                    out[key] = val[0] if val.shape == (1,) else val
            return out

        if read(3) != b'CDF':
            raise ValueError('%s is not a netCDF classic file' % path)
        version = read(1)[0]
        if version not in (1, 2):
            raise ValueError('%s: netCDF classic version %d is not read '
                             '(1 and 2 are)' % (path, version))
        numrecs = integer()
        dims = [(name(), integer()) for _ in range(count(b'\0\0\0\x0a'))]
        gattrs = attributes()
        variables = []
        for _ in range(count(b'\0\0\0\x0b')):
            vname = name()
            ids = [integer() for _ in range(integer())]
            vattrs = attributes()
            dtype = nc_type()
            vsize = integer()
            begin = struct.unpack('>i' if version == 1 else '>q',
                                  read(4 if version == 1 else 8))[0]
            record = bool(ids) and dims[ids[0]][1] == 0
            shape = tuple(numrecs if record and j == 0 else dims[i][1]
                          for j, i in enumerate(ids))
            variables.append((vname, tuple(dims[i][0] for i in ids), vattrs,
                              dtype, shape, begin, record, vsize))
    # a record holds every record variable's slab in turn, each padded to
    # 4 bytes, but for a lone record variable, unpadded
    recs = [v for v in variables if v[6]]
    if len(recs) == 1:
        recsize = int(np.prod(recs[0][4][1:], dtype=np.int64)) \
            * recs[0][3].itemsize
    else:
        recsize = sum(v[7] for v in recs)
    layout = [(vname, vdims, vattrs, dtype, shape, begin,
               recsize if record else
               int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize)
              for vname, vdims, vattrs, dtype, shape, begin, record, _
              in variables]
    return dict(dims), gattrs, layout


def _read_classic_slab(path, begin, stride, shape, dtype, key):
    """The slab ``key`` (one int or slice with a non-negative step per
    axis) of a classic variable, read at its offsets into the machine's
    byte order. Its first-axis elements ("rows") start ``stride`` bytes
    apart. Each row the key touches is read from the first to the last
    element its key touches on the second axis, unless the rows are
    contiguous and reading the block from the first to the last of them
    in one go costs less (:data:`_READ_CALL_BYTES`); record variables
    are always read a row at a time. Nothing is memory-mapped: where a
    mapping counts as resident whole (gVisor sandboxes), a slab read
    would pin the file."""
    if not shape:
        with open(path, 'rb', buffering=0) as fh:
            buf = np.empty(dtype.itemsize, np.uint8)
            _read_into(fh, begin, buf)
        return buf.view(dtype).astype(dtype.newbyteorder('=')).reshape(())
    k0 = key[0]
    rows = range(k0, k0 + 1) if isinstance(k0, int) \
        else range(*k0.indices(shape[0]))
    n1 = shape[1] if len(shape) > 1 else 1
    k1 = key[1] if len(shape) > 1 else slice(None)
    cols = range(k1, k1 + 1) if isinstance(k1, int) \
        else range(*k1.indices(n1))
    inner = int(np.prod(shape[2:], dtype=np.int64)) * dtype.itemsize
    row_bytes = n1 * inner
    c0 = cols[0] if len(cols) else 0
    width = cols[-1] + 1 - c0 if len(cols) else 0
    first = rows[0] if len(rows) else 0
    block = (rows[-1] - first + 1) * row_bytes if len(rows) else 0
    excess = block - len(rows) * width * inner
    with open(path, 'rb', buffering=0) as fh:
        if stride == row_bytes \
                and excess <= (len(rows) - 1) * _READ_CALL_BYTES:
            buf = np.empty(block, np.uint8)
            _read_into(fh, begin + first * stride, buf)
            out = buf.view(dtype).reshape((-1,) + tuple(shape[1:]))
            rel = (k0 - first if isinstance(k0, int)
                   else slice(0, len(out), rows.step),) + tuple(key[1:])
        else:
            buf = np.empty((len(rows), width * inner), np.uint8)
            for j, i in enumerate(rows):
                _read_into(fh, begin + i * stride + c0 * inner, buf[j])
            out = buf.reshape(-1).view(dtype).reshape(
                (len(rows),) + ((width,) if len(shape) > 1 else ())
                + tuple(shape[2:]))
            rel = (0 if isinstance(k0, int) else slice(None),)
            if len(shape) > 1:
                rel += (k1 - c0 if isinstance(k1, int)
                        else slice(0, width, cols.step),)
            rel += tuple(key[2:])
    if not dtype.isnative:
        out = out.byteswap(inplace=True).view(dtype.newbyteorder('='))
    return np.require(out[rel], requirements='C')     # 0-d stays 0-d


def _read_into(fh, offset, view):
    """Fill the uint8 array ``view`` from ``fh`` at ``offset``."""
    fh.seek(offset)
    mem = memoryview(view)
    done = 0
    while done < len(mem):
        n = fh.readinto(mem[done:])
        if not n:
            raise ValueError('%s ends before a variable\'s data does'
                             % fh.name)
        done += n


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _write_chunks(shape, itemsize, target=4 << 20):
    """HDF5 chunk shape for compressed writes: as close to the full
    array as fits ~``target`` bytes, splitting leading axes first
    (one zlib call per multi-MB chunk compresses several times faster
    than h5py's ~1 MB guess at identical ratios)."""
    if not shape or any(s == 0 for s in shape):
        return None
    chunk = list(shape)
    for i in range(len(chunk)):
        total = int(np.prod(chunk)) * itemsize
        if total <= target:
            break
        shrink = -(-total // target)           # ceil division
        chunk[i] = max(1, chunk[i] // shrink)
    return tuple(chunk)


def _prepare(var, classic_name=None):
    """One variable's host payload and serializable attrs (one copy of a
    CUDA tensor to the host); ``classic_name`` names the variable for the
    classic route's time encoding."""
    data = np.asarray(var.values)
    attrs = {k: _coerce_attr(v) for k, v in var.attrs.items()}
    if np.issubdtype(data.dtype, np.datetime64):
        if classic_name is None:
            data, units = _encode_cf_time(data)
        else:
            data, units = _encode_cf_time_classic(data, classic_name)
        attrs['units'] = units
        attrs['calendar'] = 'proleptic_gregorian'
    elif data.dtype == bool:
        data = data.astype(np.int8)
        attrs['dtype'] = 'bool'
    elif data.dtype.kind == 'U':
        data = data.astype('S')
    elif data.dtype.kind == 'O':
        data = np.asarray([str(x) for x in data.ravel()],
                          dtype='S').reshape(data.shape)
    if np.issubdtype(data.dtype, np.complexfloating):
        raise TypeError(
            'complex variables must be disassembled before writing '
            '(use nd_tpu_torch.io.to_netcdf)')
    return data, attrs


def write_netcdf_file(ds, path, compress=True, complevel=5,
                      encoding=None):
    """Write a Dataset to netCDF (atomic rename): netCDF-4 through h5py
    where it imports, else netCDF classic (see :func:`writer`; the
    classic format is uncompressed)."""
    h5py = _h5py()
    if h5py is None:
        return _write_netcdf_classic(ds, path)
    encoding = encoding or {}
    tmp = str(path) + '.part'

    with h5py.File(tmp, 'w') as f:
        # 1. dimension scales (coordinate variables first)
        created_dims = {}
        for dname, size in ds.sizes.items():
            if dname in ds._coords and ds._coords[dname].dims == (dname,):
                data, attrs = _prepare(ds._coords[dname])
                d = f.create_dataset(
                    dname, data=data,
                    compression='gzip' if compress else None,
                    compression_opts=complevel if compress else None)
                for k, v in attrs.items():
                    d.attrs[k] = v
                d.make_scale(dname)
            else:
                d = f.create_dataset(dname, shape=(size,), dtype='f4')
                # make_scale writes the NAME attr itself, so the
                # not-a-variable sentinel must go through it
                d.make_scale((_NOT_A_VARIABLE + b' %8d'
                              % size).decode('ascii'))
            created_dims[dname] = d

        # 2. non-dimension coordinates
        aux_coords = {}
        for cname, cvar in ds._coords.items():
            if cname in created_dims:
                continue
            data, attrs = _prepare(cvar)
            d = f.create_dataset(
                cname, data=data,
                compression='gzip' if compress and data.ndim else None,
                compression_opts=complevel if compress and data.ndim
                else None)
            for k, v in attrs.items():
                d.attrs[k] = v
            for i, dim in enumerate(cvar.dims):
                d.dims[i].attach_scale(created_dims[dim])
            aux_coords[cname] = cvar

        # 3. data variables
        for vname, var in ds._variables.items():
            data, attrs = _prepare(var)
            enc = encoding.get(vname, {})
            use_comp = enc.get('zlib', compress) and data.ndim > 0
            d = f.create_dataset(
                vname, data=data,
                compression='gzip' if use_comp else None,
                compression_opts=enc.get('complevel', complevel)
                if use_comp else None,
                chunks=_write_chunks(data.shape, data.dtype.itemsize)
                if use_comp else None)
            # CF coordinates attribute for aux coords covering this
            # var; scalar (0-d) coords attach to every variable
            cov = [c for c, cv in aux_coords.items()
                   if set(cv.dims).issubset(set(var.dims))]
            if cov:
                attrs.setdefault('coordinates', ' '.join(cov))
            for k, v in attrs.items():
                d.attrs[k] = v
            for i, dim in enumerate(var.dims):
                d.dims[i].attach_scale(created_dims[dim])

        for k, v in ds.attrs.items():
            if k.startswith('_nd_tpu'):
                continue
            f.attrs[k] = _coerce_attr(v)
        if aux_coords:
            # group-level record: aux coords whose dims no data
            # variable covers would otherwise read back as data
            f.attrs['_nd_tpu_coordinates'] = ' '.join(aux_coords)

    os.replace(tmp, path)


# the classic format's numeric types (scipy's netcdf_file writes these)
_CLASSIC_TYPES = ('i1', 'i2', 'i4', 'f4', 'f8')
# CDF-2 stores a fixed-size variable's byte count in 32 bits
_CLASSIC_VAR_LIMIT = 2 ** 32 - 4


def _classic_attr(name, value):
    """An attribute as the classic format holds it, with its value kept:
    text as UTF-8 bytes, floats as float64 (scipy would narrow a Python
    float to float32), bool and integers as int32."""
    value = _coerce_attr(value)
    if isinstance(value, str):
        return value.encode('utf-8')
    if isinstance(value, bytes):
        return value
    arr = np.asarray(value)
    if arr.dtype.kind in 'biu':
        if arr.size and (arr.min() < -2 ** 31 or arr.max() >= 2 ** 31):
            raise ValueError('attribute %r does not fit the classic '
                             "format's int32" % name)
        return arr.astype(np.int32)
    if arr.dtype.kind == 'f':
        return arr if arr.dtype == np.float32 else arr.astype(np.float64)
    raise TypeError('netCDF classic holds no %s attribute (%r)'
                    % (arr.dtype, name))


def _write_netcdf_classic(ds, path):
    """Write a Dataset to netCDF classic, 64-bit offset (CDF-2), through
    ``scipy.io.netcdf_file``, uncompressed, atomically (``.part`` then
    rename). Time is stored as float64 microseconds since 1970; the
    coordinates a variable carries are named in its CF ``coordinates``
    attribute. Raises, with the reason, on what CDF-2 cannot hold:
    int64, unsigned and string data, a variable of 4 GiB or more, and an
    aux coordinate that no data variable covers (classic files have no
    group-level record of it)."""
    from scipy.io import netcdf_file

    def prepared(name, var):
        data, attrs = _prepare(var, classic_name=name)
        if data.dtype.kind not in 'if' or \
                data.dtype.newbyteorder('>').str[1:] not in _CLASSIC_TYPES:
            raise TypeError(
                'netCDF classic has no %s variables (%r): its types are '
                'int8, int16, int32, float32 and float64; netCDF-4 (with '
                'h5py) holds them' % (data.dtype, name))
        if data.nbytes >= _CLASSIC_VAR_LIMIT:
            raise ValueError(
                '%r is %d bytes; a CDF-2 variable must be under 4 GiB'
                % (name, data.nbytes))
        return data, attrs

    # everything is converted and checked before the file is opened
    items = [(k, v, True) for k, v in ds._coords.items()] + \
        [(k, v, False) for k, v in ds._variables.items()]
    payloads = {k: prepared(k, v) for k, v, _ in items}
    aux = [k for k, v, is_coord in items if is_coord and v.dims != (k,)]
    for c in aux:
        cdims = set(ds._coords[c].dims)
        if not any(cdims <= set(v.dims) for v in ds._variables.values()):
            raise ValueError(
                'aux coordinate %r covers no data variable: netCDF '
                'classic records coordinates per variable only' % c)
    for k, v, is_coord in items:
        attrs = payloads[k][1]
        cov = [] if is_coord else \
            [c for c in aux if set(ds._coords[c].dims) <= set(v.dims)]
        if cov:
            attrs.setdefault('coordinates', ' '.join(cov))
        for a in attrs:
            attrs[a] = _classic_attr(a, attrs[a])
    gattrs = {a: _classic_attr(a, val) for a, val in ds.attrs.items()
              if not a.startswith('_nd_tpu')}

    tmp = str(path) + '.part'
    f = netcdf_file(tmp, 'w', version=2)
    try:
        for d, size in ds.sizes.items():
            f.createDimension(d, size)
        for k, v, _ in items:
            # popped: scipy keeps its own big-endian copy until close(),
            # so a slab read for this write (a lazy view's) is freed now
            data, attrs = payloads.pop(k)
            nv = f.createVariable(k, data.dtype, v.dims)
            nv[...] = data
            del data
            for a, val in attrs.items():
                setattr(nv, a, val)
        for a, val in gattrs.items():
            setattr(f, a, val)
        f.close()                       # writes the file
    except BaseException:
        f.close()
        os.remove(tmp)
        raise
    os.replace(tmp, path)
