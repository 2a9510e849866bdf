"""Where nd_tpu_torch's entry points put numpy input: on the card by
default, as the JAX package puts it on its accelerator, and on the CPU
only when the caller passes ``device='cpu'``. Without a card the default
raises PyTorch's own error; nothing falls back to the CPU."""

import os
import tempfile

import numpy as np
import pytest
import torch

import nd_tpu_torch as ndt
from nd_tpu_torch.core import DataArray, Dataset, Variable, from_jax_dataset
from nd_tpu_torch.core.dataarray import concat, full_like, merge
from nd_tpu_torch.ops import change as tchange
from nd_tpu_torch.ops import change_cuda, change_scan_cuda
from nd_tpu_torch.ops import conv as tconv
from nd_tpu_torch.ops import fft as tfft
from nd_tpu_torch.ops import interp as tinterp
from nd_tpu_torch.ops import nlmeans as tnlmeans
from nd_tpu_torch.models import change_features, load_params
from nd_tpu_torch.ops.stats import chi2_cdf
from nd_tpu_torch.testing import create_mock_classes, generate_test_dataset
from nd_tpu_torch.utils import as_tensor
from torch_cubes import long_stack_cube, sar_cube


def _jax_dataset():
    from nd_tpu.core import Dataset as JDataset
    cube = sar_cube(6, 7, 4, seed=51, special=False)
    return JDataset({v: (('y', 'x', 'time'), cube[..., i])
                     for i, v in enumerate(('C11', 'C12__re', 'C12__im',
                                            'C22'))},
                    coords={'time': np.arange(4), 'x': np.arange(7.0)})


def _small():
    return np.random.RandomState(52).rand(6, 7, 3, 2).astype(np.float32)


# entry point -> a call with numpy input returning the tensors it made
ENTRY_POINTS = {
    'as_tensor': lambda **kw: [as_tensor(_small(), **kw)],
    'Variable': lambda **kw: [Variable(('y', 'x'), np.ones((2, 3)),
                                       **kw).data],
    'DataArray': lambda **kw: [DataArray(np.ones((2, 3)), dims=('y', 'x'),
                                         coords={'x': np.arange(3.0)},
                                         **kw).data],
    'Dataset': lambda **kw: (lambda ds: [ds['a'].data, ds['x'].data])(
        Dataset({'a': (('y', 'x'), np.ones((2, 3)))},
                coords={'x': np.arange(3.0)}, **kw)),
    'from_jax_dataset': lambda **kw: (lambda ds: [ds['C11'].data,
                                                  ds['x'].data])(
        from_jax_dataset(_jax_dataset(), **kw)),
    'nlmeans': lambda **kw: [tnlmeans.nlmeans(_small(), (1, 1, 0),
                                              (1, 1, 0), 1.0, 1.0, **kw)],
    'convolve': lambda **kw: [tconv.convolve(_small(), np.ones((3, 3)) / 9,
                                             axes=(0, 1), **kw)],
    'separable_convolve': lambda **kw: [tconv.separable_convolve(
        _small()[..., 0], [np.ones(3) / 3] * 3, (0, 1, 2), **kw)],
    'change_detection': lambda **kw: [tchange.change_detection(
        sar_cube(4, 5, 6, seed=53, special=False), 0.9, n=9, **kw)],
    'change_detection_exact': lambda **kw: [tchange.change_detection_exact(
        sar_cube(4, 5, 6, seed=54, special=False), 0.9, n=9, **kw)],
    'change_detection_fast': lambda **kw: [change_cuda.change_detection_fast(
        sar_cube(4, 5, 6, seed=55, special=False), 0.9, n=9, **kw)],
    'change_detection_scan': lambda **kw: list(
        change_scan_cuda.change_detection_scan(
            long_stack_cube(3, 4, 56, seed=56), 0.99, n=9, **kw)),
    'generate_test_dataset': lambda **kw: (lambda ds: [
        ds['C11'].data, ds['x'].data])(generate_test_dataset(
            dims={'y': 5, 'x': 6, 'time': 2}, **kw)),
    'phase_cross_correlation_batch': lambda **kw: [
        tfft.phase_cross_correlation_batch(_small()[..., 0, 0][None],
                                           _small()[..., 0, 0], 4, **kw)],
    'translate_batch': lambda **kw: [tfft.translate_batch(
        _small()[..., 0].transpose(2, 0, 1), np.zeros((3, 2)), **kw)],
    'translate': lambda **kw: [tfft.translate(_small()[..., 0, 0],
                                              (0.5, 1.0), **kw)],
    'chi2_cdf': lambda **kw: [chi2_cdf(np.array([0.5, 3.0]), 4, **kw)],
    'omnibus_probabilities': lambda **kw: [tchange.omnibus_probabilities(
        sar_cube(4, 5, 6, seed=58, special=False), n=9, **kw)],
    'change_features': lambda **kw: [change_features(
        sar_cube(4, 5, 6, seed=59, special=False), n=9, **kw)],
    'init_params': lambda **kw: list(
        ndt.SARChangePipeline().init_params(**kw).values()),
    'params_from_jax': lambda **kw: list(
        ndt.SARChangePipeline().params_from_jax(
            {'w': np.zeros((7, 2), np.float32),
             'b': np.zeros(2, np.float32)}, **kw).values()),
    'load_params': lambda **kw: _saved_and_loaded(**kw),
    'create_mock_classes': lambda **kw: (lambda ds, labels: [
        ds['C11'].data, labels.data])(*create_mock_classes(
            dims={'y': 4, 'x': 5, 'time': 2}, **kw)),
    # the data model's and utils' new entry points keep the device the
    # numpy input was put on
    'concat': lambda **kw: (lambda da: [da.data, da['x'].data])(
        concat([DataArray(np.ones((2, 3)), dims=('y', 'x'),
                          coords={'x': np.arange(3.0)}, **kw)] * 2, 'x')),
    'merge': lambda **kw: (lambda ds: [ds['a'].data, ds['b'].data])(merge([
        Dataset({'a': (('y',), np.ones(2))}, **kw),
        Dataset({'b': (('y',), np.zeros(2))}, **kw)])),
    'full_like': lambda **kw: [full_like(
        DataArray(np.ones((2, 3)), dims=('y', 'x'), **kw), 2.0).data],
    'utils.apply': lambda **kw: [ndt.utils.apply(
        DataArray(np.random.RandomState(60).rand(2, 3, 4),
                  dims=('y', 'x', 'time'), **kw),
        lambda s: s - s.mean(), signature='(time)->(time)').data],
    'parallel': lambda **kw: [ndt.utils.parallel(
        lambda part: part * 2, dim='y', chunks=2)(
            Dataset({'a': (('y', 'x'), np.ones((4, 3)))}, **kw))['a'].data],
    'open_dataset': lambda **kw: (lambda ds: [ds['a'].data, ds['x'].data])(
        ndt.open_dataset(_files()['nc'], **kw)),
    'open_netcdf': lambda **kw: (lambda ds: [ds['a'].data, ds['x'].data])(
        ndt.io.open_netcdf(_files()['nc'], **kw)),
    'open_rasterio': lambda **kw: (lambda da: [da.data, da['x'].data])(
        ndt.io.open_rasterio(_files()['tif'], **kw)),
    'open_zarr': lambda **kw: (lambda ds: [ds['a'].data, ds['x'].data])(
        ndt.io.open_zarr(_files()['zarr'], **kw)),
    'open_beam_dimap': lambda **kw: (lambda ds: [ds['Sigma0_VV'].data,
                                                 ds['lat'].data])(
        ndt.io.open_beam_dimap(_files()['dim'], **kw)),
    'map_coordinates': lambda **kw: [tinterp.map_coordinates(
        np.ones((3, 4)), np.array([[0.5, 1.0]]), np.array([[1.5, 2.0]]),
        **kw)],
    'matmul_resample': lambda **kw: [tinterp.matmul_resample(
        np.ones((3, 4), np.float32),
        *(tinterp.axis_weights(np.array([0.5, 1.5]), 3, 'bilinear')[:2]
          + tinterp.axis_weights(np.array([1.0, 2.5]), 4, 'bilinear')[:2]),
        np.ones(2, bool), np.ones(2, bool), np.nan, 4.0, **kw)],
    'footprint_resample': lambda **kw: [tinterp.footprint_resample(
        np.ones((4, 6)), *(tinterp.footprint_axis(np.array([0.5, 2.5]), 4,
                                                   2.0)
                           + tinterp.footprint_axis(np.array([1.0, 3.0]),
                                                    6, 2.0)),
        'med', np.nan, **kw)],
}

_FILES = {}


def _files():
    """One file per reader, written once per process by the port's
    writers (the BEAM-DIMAP product by the DIMAP tests' writer)."""
    if not _FILES:
        from test_torch_dimap import write_dimap
        tmp = tempfile.mkdtemp()
        ds = Dataset({'a': (('y', 'x'), np.ones((2, 3), np.float32))},
                     coords={'y': np.arange(2.0), 'x': np.arange(3.0)},
                     attrs={'crs': 'epsg:4326'}, device='cpu')
        _FILES.update(nc=os.path.join(tmp, 'a.nc'),
                      tif=os.path.join(tmp, 'a.tif'),
                      zarr=os.path.join(tmp, 'a.zarr'),
                      dim=write_dimap(os.path.join(tmp, 'product')))
        ndt.to_netcdf(ds, _FILES['nc'])
        ndt.io.to_geotiff(ds, _FILES['tif'])
        ndt.io.to_zarr(ds, _FILES['zarr'])
    return _FILES


def _saved_and_loaded(**kw):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'p.npz')
        np.savez(path, arr_0=np.ones(3), arr_1=np.zeros((2, 2)))
        return load_params(path, **kw)


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_device_cpu_is_honoured(name):
    tensors = ENTRY_POINTS[name](device='cpu')
    assert tensors and all(isinstance(t, torch.Tensor)
                           and t.device.type == 'cpu' for t in tensors)


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_numpy_input_does_not_stay_on_the_cpu(name):
    if torch.cuda.is_available():
        tensors = ENTRY_POINTS[name]()
        assert all(t.device.type == 'cuda' for t in tensors)
        return
    # this PyTorch has no CUDA: the default device raises its own error
    with pytest.raises((AssertionError, RuntimeError), match='CUDA'):
        ENTRY_POINTS[name]()


def test_tensors_stay_where_they_are():
    x = torch.from_numpy(_small())
    assert as_tensor(x) is x and as_tensor(x, device='meta') is x
    assert Variable(('y', 'x', 't', 'v'), x).data is x
    out = tnlmeans.nlmeans(x, (1, 1, 0), (1, 1, 0), 1.0, 1.0)
    assert out.device.type == 'cpu'


def test_non_numeric_coordinates_stay_numpy():
    times = np.array(['2020-01-01', '2020-01-13'], dtype='datetime64[ns]')
    ds = Dataset({'a': (('time',), torch.zeros(2))}, coords={'time': times})
    assert isinstance(ds['time'].data, np.ndarray)
    ds = from_jax_dataset(_jax_dataset(), device='cpu')
    arr = ds[['C11', 'C22']].to_array()
    assert isinstance(arr['variable'].data, np.ndarray)


def test_readme_chain_from_numpy_on_the_cpu():
    cube = sar_cube(10, 12, 6, seed=57, special=False)
    ds = ndt.Dataset({v: (('y', 'x', 'time'), cube[..., i])
                      for i, v in enumerate(('C11', 'C12__re', 'C12__im',
                                             'C22'))}, device='cpu')
    flt = ndt.NLMeansFilter(dims=('y', 'x'), r=1, f=1, sigma=2,
                            h=3).apply(ds)
    change = ndt.OmnibusTest(ml=3, alpha=0.9).apply(flt)
    assert change.data.device.type == 'cpu' and change.data.dtype == torch.bool
