"""nd_tpu_torch.visualize_map.render_map and the cartopy branch of
plot_map against nd_tpu's on the CPU.

``render_map`` is host numpy over the port's own copy of ``crs/`` plus
cv2's line and text drawing, so its pixels equal nd_tpu's bit for bit:
every case of ``tests/test_render_map.py`` and each combination of the
map's elements, held as equal images (and PNG files byte for byte).
The cartopy branch (``plot_map``, ``gridlines_with_labels``,
``scale_bar``) runs against ``tests/test_map_stub.py``'s cartopy stub,
imported from there, in both packages: the same patches, texts, view
limits and scale-bar lengths.
"""

import importlib
import itertools
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from nd_tpu import visualize_map as JM  # noqa: E402
from nd_tpu.testing import generate_test_dataset as jgen  # noqa: E402
from nd_tpu_torch import visualize_map as TM  # noqa: E402
from nd_tpu_torch.testing import assert_equal_files  # noqa: E402
from nd_tpu_torch.testing import generate_test_dataset as tgen  # noqa: E402

EXTENT = (4.0, 50.0, 8.0, 53.0)   # a few degrees over NW Europe


def _pair(dims={'y': 12, 'x': 14, 'time': 2}, extent=EXTENT):
    return (jgen(dims=dims, extent=extent),
            tgen(dims=dims, extent=extent, device='cpu'))


def _eq(got, ref):
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('graticule,footprint,scalebar',
                         list(itertools.product([True, False], repeat=3)))
def test_elements_match_jax(graticule, footprint, scalebar):
    j, t = _pair()
    kw = dict(shape=(480, 480), graticule=graticule, footprint=footprint,
              scalebar=scalebar)
    _eq(TM.render_map(t, **kw), JM.render_map(j, **kw))


@pytest.mark.parametrize('extent,shape,buffer', [
    ((-60.0, -35.0, 60.0, 65.0), (400, 400), None),     # the limb shows
    (EXTENT, (300, 500), None),                          # wide frame
    (EXTENT, (500, 300), 0.5),                           # tall, buffered
    ((170.0, -20.0, 179.0, -10.0), (360, 360), 0.1),     # by the antimeridian
    ((10.0, 45.0, 10.05, 45.04), (256, 256), None),      # metres: 'm' bar
])
def test_views_match_jax(extent, shape, buffer):
    j, t = _pair(dims={'y': 8, 'x': 8, 'time': 1}, extent=extent)
    _eq(TM.render_map(t, shape=shape, buffer=buffer),
        JM.render_map(j, shape=shape, buffer=buffer))


def test_png_written_equal(tmp_path):
    j, t = _pair()
    img = TM.render_map(t, shape=(480, 480), output=str(tmp_path / 't.png'))
    JM.render_map(j, shape=(480, 480), output=str(tmp_path / 'j.png'))
    assert_equal_files(str(tmp_path / 't.png'), str(tmp_path / 'j.png'))
    back = cv2.imread(str(tmp_path / 't.png'), cv2.IMREAD_COLOR)[:, :, ::-1]
    _eq(back, img)


def test_palette_and_structure():
    """The tests/test_render_map.py checks, on the port's image."""
    _, t = _pair()
    full = TM.render_map(t, shape=(480, 480))
    bare = TM.render_map(t, shape=(480, 480), graticule=False,
                         footprint=False, scalebar=False)
    assert TM._SPACE == JM._SPACE
    assert not np.all(bare == np.array(TM._SPACE, np.uint8), axis=-1).any()
    assert (bare[..., 2].astype(int) > bare[..., 0].astype(int)).all()
    no_bar = TM.render_map(t, shape=(480, 480), scalebar=False)
    ys, xs = np.nonzero(np.any(full != no_bar, axis=-1))
    assert ys.min() > 480 * 0.75 and xs.min() < 480 * 0.5


def test_small_frame_matches_jax():
    j, t = _pair(dims={'y': 4, 'x': 4, 'time': 1},
                 extent=(-10.0, 50.0, 0.0, 60.0))
    _eq(TM.render_map(t, shape=(64, 64)), JM.render_map(j, shape=(64, 64)))


def test_plot_map_dispatches_without_cartopy(tmp_path):
    from nd_tpu import visualize as JV
    from nd_tpu_torch import visualize as TV
    if TV.cartopy is not None:
        pytest.skip('cartopy installed: plot_map uses the cartopy path')
    j, t = _pair()
    got = TV.plot_map(t, output=str(tmp_path / 't.png'))
    _eq(got, JV.plot_map(j, output=str(tmp_path / 'j.png')))
    assert_equal_files(str(tmp_path / 't.png'), str(tmp_path / 'j.png'))


# ---- the cartopy branch, against test_map_stub.py's stub -------------------

@pytest.fixture
def stubbed():
    """nd_tpu's and the port's visualize reloaded over the cartopy stub."""
    pytest.importorskip('matplotlib')
    from test_map_stub import _build_stub
    import nd_tpu.visualize as jv
    import nd_tpu_torch.visualize as tv
    stubs = _build_stub()
    saved = {k: sys.modules.get(k) for k in stubs}
    sys.modules.update(stubs)
    importlib.reload(jv)
    importlib.reload(tv)
    try:
        yield jv, tv
    finally:
        import matplotlib.pyplot as plt
        plt.close('all')
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        importlib.reload(jv)
        importlib.reload(tv)


def _texts(ax):
    return [(t.get_text(), tuple(np.round(getattr(t, 'xy', t.get_position()),
                                          9))) for t in ax.texts]


def _axes():
    import matplotlib.pyplot as plt
    plt.figure()
    proj = sys.modules['cartopy.crs'].PlateCarree()
    return plt.axes(projection=proj)


def test_plot_map_executes(stubbed):
    jv, tv = stubbed
    j, t = _pair(extent=(-10.0, 50.0, 0.0, 60.0))
    import matplotlib.pyplot as plt
    plt.figure()
    ref = jv.plot_map(j)
    plt.figure()
    got = tv.plot_map(t)
    assert len(got.patches) == len(ref.patches) >= 1
    np.testing.assert_array_equal(got.patches[0].get_xy(),
                                  ref.patches[0].get_xy())
    assert _texts(got) == _texts(ref)
    labels = [s for s, _ in _texts(got)]
    assert any('km' in s for s in labels)
    assert any('°E' in s or '°W' in s for s in labels)
    assert any('°N' in s or '°S' in s for s in labels)
    assert got.get_xlim() == ref.get_xlim()
    assert got.get_ylim() == ref.get_ylim()
    x0, x1 = got.get_xlim()
    y0, y1 = got.get_ylim()
    assert x0 <= -10 and x1 >= 0 and y0 <= 50 and y1 >= 60


@pytest.mark.parametrize('sides', [dict(), dict(top=False, left=False)])
def test_gridlines_edge_labels(stubbed, sides):
    jv, tv = stubbed
    out = []
    for mod in (jv, tv):
        ax = _axes()
        ax.set_xlim(-10, 50)
        ax.set_ylim(0, 60)
        gl = mod.gridlines_with_labels(ax, **sides)
        assert gl is not None
        out.append((_texts(ax), list(gl.xlocator.locs),
                    list(gl.ylocator.locs)))
    assert out[0] == out[1]
    assert any(s.endswith(('E', 'W')) for s, _ in out[1][0])


@pytest.mark.parametrize('location,length,kw', [
    ((0.1, 0.1), None, {}),
    ((0.1, 0.3), 50, dict(metres_per_unit=1609.34, unit_name='mi')),
    ((0.4, 0.6), 123, {})])
def test_scale_bar(stubbed, location, length, kw):
    jv, tv = stubbed
    out = []
    for mod in (jv, tv):
        ax = _axes()
        ax.set_xlim(0, 10)
        ax.set_ylim(-1, 1)
        km = mod.scale_bar(ax, location, length, **kw)
        out.append((km, _texts(ax), [ln.get_xydata().tolist()
                                     for ln in ax.lines]))
    assert out[0] == out[1]
    if length is None:
        assert out[1][0] == pytest.approx(200.0)


def test_cartopy_helpers_raise_without_cartopy():
    from nd_tpu_torch import visualize as TV
    if TV.cartopy is not None:
        pytest.skip('real cartopy present')
    with pytest.raises(ImportError, match='cartopy'):
        TV.scale_bar(None)
    with pytest.raises(ImportError, match='cartopy'):
        TV.gridlines_with_labels(None)
