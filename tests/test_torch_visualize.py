"""nd_tpu_torch.visualize against nd_tpu.visualize on the CPU.

Every case of ``tests/test_visualize.py``, held as equality: the RGB
images (uint8) equal nd_tpu's bit for bit, the written PNG and GIF files
byte for byte (``testing.assert_equal_files``), ``colorize`` and the
colormaps equal. The stretch is held on a 1024 x 1024 band with 5% NaN
at several percentile pairs, where one ulp in a percentile's lerp would
flip a uint8 truncation. Both packages draw the same seeded cube
(``generate_test_dataset``). Without imageio (the card's machine has
cv2 but not imageio) the package-level ``to_rgb`` and ``write_video``
are None, as nd_tpu's would be, while ``visualize.to_rgb`` works;
without cv2 as well the module still imports and the image functions
raise nd_tpu's ImportError texts.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nd_tpu  # noqa: F401  (registers nd_tpu's accessors)
from nd_tpu import visualize as JV
from nd_tpu.testing import generate_test_dataset as jgen
import nd_tpu_torch as ndt
from nd_tpu_torch import visualize as TV
from nd_tpu_torch.testing import assert_equal_files
from nd_tpu_torch.testing import generate_test_dataset as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = {'y': 24, 'x': 32, 'time': 3}


@pytest.fixture(scope='module')
def pair():
    return jgen(dims=DIMS), tgen(dims=DIMS, device='cpu')


def _eq(got, ref):
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('new,orig', [
    (None, (10, 20)), ((None, None), (10, 20)), ((5, None), (10, 20)),
    ((None, 10), (10, 20)), ((7, 9), (10, 20)), ((None, 7), (13, 31)),
    ((11, None), (13, 31))])
def test_calculate_shape(new, orig):
    assert TV.calculate_shape(new, orig) == JV.calculate_shape(new, orig)


def test_cmaps_equal():
    assert TV.CMAPS == JV.CMAPS and TV.CMAPS


def test_to_rgb_single_channel(pair):
    j, t = pair
    _eq(TV.to_rgb(t['C11'].isel(time=0)), JV.to_rgb(j['C11'].isel(time=0)))


def test_to_rgb_three_channels(pair):
    j, t = pair
    dj, dt = j.isel(time=0), t.isel(time=0)
    _eq(TV.to_rgb([dt['C11'], dt['C22'], dt['C11'] / dt['C22']]),
        JV.to_rgb([dj['C11'], dj['C22'], dj['C11'] / dj['C22']]))


@pytest.mark.parametrize('vmin,vmax', [(-1, 1), (-10, 10), (0.25, 0.5),
                                       (1, -1), ([-1, 0, 1], 2.5)])
def test_to_rgb_vmin_vmax(pair, vmin, vmax):
    j, t = pair
    if isinstance(vmin, list):
        dj, dt = j.isel(time=1), t.isel(time=1)
        _eq(TV.to_rgb([dt['C11'], dt['C22'], dt['C12__re']], vmin=vmin,
                      vmax=vmax),
            JV.to_rgb([dj['C11'], dj['C22'], dj['C12__re']], vmin=vmin,
                      vmax=vmax))
        return
    _eq(TV.to_rgb(t['C11'].isel(time=0), vmin=vmin, vmax=vmax),
        JV.to_rgb(j['C11'].isel(time=0), vmin=vmin, vmax=vmax))


def test_to_rgb_vmin_vmax_stretch_order(pair):
    _, t = pair
    ch = t['C11'].isel(time=0)
    assert TV.to_rgb(ch, vmin=-1, vmax=1).std() \
        > TV.to_rgb(ch, vmin=-10, vmax=10).std()


@pytest.mark.parametrize('shape', [None, (12, 16), (12, None), (None, 40)])
def test_to_rgb_mask_and_shape(pair, shape):
    j, t = pair
    mask = np.zeros((24, 32), dtype=bool)
    mask[5:10, 5:10] = True
    got = TV.to_rgb(t['C11'].isel(time=0), mask=mask, shape=shape)
    _eq(got, JV.to_rgb(j['C11'].isel(time=0), mask=mask, shape=shape))
    if shape is None:
        assert (got[0, 0] == 0).all()
    # a tensor mask is the same mask
    _eq(TV.to_rgb(t['C11'].isel(time=0), mask=torch.from_numpy(mask),
                  shape=shape), got)


@pytest.mark.parametrize('cmap', ['jet', 'viridis', 'hot', 'turbo', 'bone'])
def test_to_rgb_colormap(pair, cmap):
    j, t = pair
    _eq(TV.to_rgb(t['C22'].isel(time=2), cmap=cmap),
        JV.to_rgb(j['C22'].isel(time=2), cmap=cmap))


def test_to_rgb_categorical():
    labels = np.random.RandomState(0).randint(0, 4, size=(16, 16))
    got = TV.to_rgb(labels, categorical=True)
    _eq(got, JV.to_rgb(labels, categorical=True))
    assert (got[labels == 0] == 0).all()
    _eq(TV.to_rgb(torch.from_numpy(labels), categorical=True), got)


def test_to_rgb_rejects_3d(pair):
    j, t = pair
    with pytest.raises(ValueError, match='two-dimensional'):
        JV.to_rgb(j['C11'])
    with pytest.raises(ValueError, match='two-dimensional'):
        TV.to_rgb(t['C11'])
    with pytest.raises(ValueError, match='must be a DataArray'):
        TV.to_rgb('C11')


def test_to_rgb_write(tmp_path, pair):
    j, t = pair
    JV.to_rgb(j['C11'].isel(time=0), output=str(tmp_path / 'j.png'))
    assert TV.to_rgb(t['C11'].isel(time=0),
                     output=str(tmp_path / 't.png')) is None
    assert_equal_files(str(tmp_path / 't.png'), str(tmp_path / 'j.png'))


@pytest.mark.parametrize('N', [None, 2, 3, 7])
def test_colorize(N):
    labels = np.arange(64).reshape(8, 8) % 5
    _eq(TV.colorize(labels, N=N, nan_vals=[1]),
        JV.colorize(labels, N=N, nan_vals=[1]))


def test_write_video_gif(tmp_path, pair):
    j, t = pair
    JV.write_video(j, str(tmp_path / 'j.gif'), fps=2)
    TV.write_video(t, str(tmp_path / 't.gif'), fps=2)
    assert os.path.getsize(tmp_path / 't.gif') > 0
    assert_equal_files(str(tmp_path / 't.gif'), str(tmp_path / 'j.gif'))


def test_write_video_dataarray_options(tmp_path, pair):
    j, t = pair
    kw = dict(fps=3, width=40, timestamp='lower right', fontcolor=(255, 0, 0),
              cmap='viridis')
    JV.write_video(j['C22'], str(tmp_path / 'j.gif'), **kw)
    TV.write_video(t['C22'], str(tmp_path / 't.gif'), **kw)
    assert_equal_files(str(tmp_path / 't.gif'), str(tmp_path / 'j.gif'))


def test_plot_map_renders_without_cartopy():
    if TV.cartopy is not None:
        pytest.skip('cartopy installed; the renderer is not the route')
    j = jgen(dims={'y': 8, 'x': 8, 'time': 1})
    t = tgen(dims={'y': 8, 'x': 8, 'time': 1}, device='cpu')
    _eq(TV.plot_map(t), JV.plot_map(j))


@pytest.mark.parametrize('pmin,pmax', [(2, 98), (0.5, 99.5), (1, 99),
                                       (13.7, 61.3), (0, 100), (2.5, 97.5)])
def test_to_rgb_stretch_1024_with_nans(pmin, pmax):
    """A 1024 x 1024 float64 band (gamma draws, 5% NaN): the percentile's
    virtual index and numpy's two-sided lerp decide the uint8 truncation
    of thousands of pixels."""
    rng = np.random.RandomState(11)
    band = rng.gamma(2.0, size=(1024, 1024))
    band[rng.rand(1024, 1024) < 0.05] = np.nan
    _eq(TV.to_rgb(torch.from_numpy(band), pmin=pmin, pmax=pmax),
        JV.to_rgb(band, pmin=pmin, pmax=pmax))


@pytest.mark.parametrize('case', ['float32', 'int_count', 'constant',
                                  'all_nan', 'inf'])
def test_to_rgb_channel_kinds(case):
    rng = np.random.RandomState(5)
    a = {'float32': rng.rand(40, 50).astype(np.float32) * 7,
         'int_count': rng.randint(0, 12, size=(40, 50)),
         'constant': np.full((40, 50), 3.5),
         'all_nan': np.full((40, 50), np.nan),
         'inf': np.where(rng.rand(40, 50) < 0.1, np.inf,
                         rng.rand(40, 50))}[case]
    _eq(TV.to_rgb(torch.from_numpy(a)), JV.to_rgb(a))


def test_stretch_keeps_the_device_and_crosses_only_uint8():
    """The device part returns a uint8 (h, w, 3) image on the channels'
    device: the only array to_rgb copies to the host."""
    c = [torch.rand(20, 30, dtype=torch.float32) for _ in range(3)]
    im = TV._bgr(c)
    assert im.dtype == torch.uint8 and im.shape == (20, 30, 3)
    assert im.device == c[0].device
    _eq(TV.to_rgb(c), im.numpy()[..., ::-1])


def test_accessor_to_rgb(pair):
    j, t = pair
    _eq(t.isel(time=0).nd.to_rgb(), j.isel(time=0).nd.to_rgb())


def test_package_exports():
    assert ndt.to_rgb is TV.to_rgb and ndt.write_video is TV.write_video
    assert 'to_rgb' in ndt.__all__ and 'write_video' in ndt.__all__


def test_without_imageio():
    """As on the card's machine (cv2, no imageio): to_rgb / write_video
    are None at the package level, visualize.to_rgb works and equals the
    run with imageio, write_video raises ImportError."""
    code = '''
import sys
sys.modules['imageio'] = None
import numpy as np
import nd_tpu_torch as ndt
from nd_tpu_torch import visualize
from nd_tpu_torch.testing import generate_test_dataset
assert ndt.to_rgb is None and ndt.write_video is None
ds = generate_test_dataset(dims={'y': 6, 'x': 7, 'time': 2}, device='cpu')
np.save(sys.argv[1], visualize.to_rgb(ds['C11'].isel(time=0)))
try:
    visualize.write_video(ds, 'x.gif')
except ImportError as e:
    assert 'imageio' in str(e), e
else:
    raise SystemExit('write_video did not raise')
print('ok')
'''
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'rgb.npy')
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run([sys.executable, '-c', code, out], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0 and 'ok' in proc.stdout, \
            proc.stdout + proc.stderr
        ds = tgen(dims={'y': 6, 'x': 7, 'time': 2}, device='cpu')
        _eq(np.load(out), TV.to_rgb(ds['C11'].isel(time=0)))


def test_without_cv2_and_imageio():
    """As on the card's machine: the package and its visualize import,
    to_rgb / write_video are None at the package level (no imageio, as in
    nd_tpu), and the image functions raise nd_tpu's ImportError texts."""
    code = '''
import sys
sys.modules['cv2'] = None
sys.modules['imageio'] = None
import numpy as np
import nd_tpu_torch as ndt
from nd_tpu_torch import visualize, visualize_map
from nd_tpu_torch.testing import generate_test_dataset
assert ndt.to_rgb is None and ndt.write_video is None
assert visualize.CMAPS == {}
ds = generate_test_dataset(dims={'y': 6, 'x': 7, 'time': 2}, device='cpu')
for fn, args in ((visualize.to_rgb, (ds['C11'].isel(time=0),)),
                 (visualize.colorize, (np.zeros((3, 3), int),)),
                 (visualize.write_video, (ds, 'x.gif'))):
    try:
        fn(*args)
    except ImportError as e:
        assert str(e) == 'this function requires opencv-python (cv2)', e
    else:
        raise SystemExit('%s did not raise' % fn.__name__)
for fn in (visualize_map.render_map, visualize.plot_map):
    try:
        fn(ds)
    except ImportError as e:
        assert str(e) == 'render_map requires opencv-python (cv2)', e
    else:
        raise SystemExit('%s did not raise' % fn.__name__)
im = visualize._bgr([ds['C11'].isel(time=0).data])
assert im.shape == (6, 7, 3)
print('ok')
'''
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and 'ok' in proc.stdout, \
        proc.stdout + proc.stderr
