"""Zarr parity of nd_tpu_torch.io with nd_tpu.io, exact: for the same
dataset and options the port's store holds nd_tpu's files byte for byte
(``.zmetadata`` as parsed JSON: it lists the members in the order
``os.walk`` visits two directories, which may differ), and each package
reads the other's store as its own (the cases of the JAX package's
``tests/test_zarr.py``)."""

import json
import os
import zlib

import numpy as np
import pytest

from nd_tpu.core import DataArray as JDataArray
from nd_tpu.core import Dataset as JDataset
from nd_tpu.io import open_zarr as jopen
from nd_tpu.io import to_zarr as jwrite
from nd_tpu_torch import io as tio
from nd_tpu_torch.core import DataArray, Dataset
from torch_io_helpers import same_dataset, tree_bytes


def _cube(rng):
    shape = (10, 12, 3)
    times = np.datetime64('2023-01-03', 'ns') \
        + np.arange(3) * np.timedelta64(12, 'D')
    c11 = rng.rand(*shape).astype(np.float32)
    c11[rng.rand(*shape) < 0.2] = np.nan
    return dict(data_vars={
        'C11': (('y', 'x', 'time'), c11),
        'C12': (('y', 'x', 'time'),
                (rng.rand(*shape) + 1j * rng.rand(*shape)).astype(np.complex64)),
        'C22': (('y', 'x', 'time'), rng.rand(*shape))},
        coords={'y': np.arange(10.0), 'x': np.arange(12.0), 'time': times},
        attrs={'crs': 'epsg:4326', 'transform': (1.0, 0.0, 0.0, 0.0, 1.0, 0.0),
               'flag': np.bool_(False), 'coordinates': 'a user note'})


def _mixed(rng):
    return dict(data_vars={
        'm': (('y', 'x'), rng.rand(4, 5) > 0.5),
        'i': (('y', 'x'), rng.randint(-9, 9, (4, 5)).astype(np.int16)),
        'u': (('y', 'x'), rng.randint(0, 9, (4, 5)).astype(np.uint16)),
        'n': (('y',), np.array(['a', 'bc', 'def', 'g']))},
        coords={'y': np.arange(4), 'x': np.arange(5),
                'lat': (('y', 'x'), rng.rand(4, 5)),
                'when': np.datetime64('2021-01-02T03:04:05', 'ns'),
                'label': (('x',), rng.rand(5))})


CASES = {'cube': _cube, 'mixed': _mixed}


def twins(make, seed=0):
    spec = make(np.random.RandomState(seed))
    return (JDataset(spec['data_vars'], coords=spec['coords'],
                     attrs=spec.get('attrs')),
            Dataset(spec['data_vars'], coords=spec['coords'],
                    attrs=spec.get('attrs'), device='cpu'))


def same_store(pt, pj):
    got, want = tree_bytes(pt), tree_bytes(pj)
    assert set(got) == set(want)
    for name in want:
        if name == '.zmetadata':
            assert json.loads(got[name]) == json.loads(want[name])
        else:
            assert got[name] == want[name], name


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('chunks', [None, {'y': 3, 'x': 5}])
@pytest.mark.parametrize('compress', [True, False])
def test_store_is_byte_equal_and_reads_both_ways(tmp_path, case, chunks,
                                                 compress):
    j, t = twins(CASES[case])
    pt, pj = str(tmp_path / 't.zarr'), str(tmp_path / 'j.zarr')
    assert tio.to_zarr(t, pt, chunks=chunks, compress=compress) == pt
    jwrite(j, pj, chunks=chunks, compress=compress)
    same_store(pt, pj)
    want = jopen(pj)
    same_dataset(tio.open_zarr(pt, device='cpu'), want)
    same_dataset(tio.open_zarr(pj, device='cpu'), want)
    same_dataset(jopen(pt), want)


def test_dataarray_input(tmp_path):
    rng = np.random.RandomState(1)
    vals = rng.rand(3, 4)
    j = JDataArray(vals, dims=('y', 'x'), name='v')
    t = DataArray(vals, dims=('y', 'x'), name='v', device='cpu')
    pt, pj = str(tmp_path / 't.zarr'), str(tmp_path / 'j.zarr')
    tio.to_zarr(t, pt)
    jwrite(j, pj)
    same_store(pt, pj)
    same_dataset(tio.open_zarr(pt, device='cpu'), jopen(pj))


def test_overwrite_removes_ghost_arrays(tmp_path):
    j, t = twins(_cube)
    p = str(tmp_path / 's.zarr')
    tio.to_zarr(t, p)
    tio.to_zarr(t.drop_vars(['C22']), p)
    assert not os.path.exists(os.path.join(p, 'C22'))
    same_dataset(tio.open_zarr(p, device='cpu'),
                 jopen(str(tmp_path / 's.zarr')))


def _foreign_store(path, fill, order='C', chunk=None):
    """A store as zarr-python writes it: no dims attribute, a missing
    chunk, '/'-nested chunk keys."""
    os.makedirs(os.path.join(path, 'a', '0'))
    with open(os.path.join(path, '.zgroup'), 'w') as fh:
        json.dump({'zarr_format': 2}, fh)
    meta = {'zarr_format': 2, 'shape': [4, 6], 'chunks': [2, 6],
            'dtype': '<f8', 'compressor': {'id': 'zlib', 'level': 1},
            'fill_value': fill, 'order': order, 'filters': None,
            'dimension_separator': '/'}
    with open(os.path.join(path, 'a', '.zarray'), 'w') as fh:
        json.dump(meta, fh)
    block = np.arange(12.0).reshape(2, 6) if chunk is None else chunk
    with open(os.path.join(path, 'a', '0', '0'), 'wb') as fh:
        fh.write(zlib.compress(block.tobytes()))
    return path


@pytest.mark.parametrize('fill', ['NaN', 7.5, None])
def test_foreign_store_with_missing_chunk(tmp_path, fill):
    p = _foreign_store(str(tmp_path / 'f.zarr'), fill)
    same_dataset(tio.open_zarr(p, device='cpu'), jopen(p))


def test_foreign_order_rejected(tmp_path):
    p = _foreign_store(str(tmp_path / 'f.zarr'), None, order='F')
    with pytest.raises(IOError, match='order'):
        tio.open_zarr(p, device='cpu')
