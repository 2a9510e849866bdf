"""nd_tpu_torch.ops.rasterize against nd_tpu.ops.rasterize on the CPU:
``polygon_mask`` and ``rasterize_values`` bit-equal on seeded polygons,
including polygons that cross the grid's edge, holes, multipolygons,
vertices and horizontal edges on pixel centres, and ascending or
descending coordinates; the bounding-box route against the port's own
whole-grid count; the blocked comparison against one block."""

import numpy as np
import pytest
import torch

from nd_tpu.ops import rasterize as JR
from nd_tpu.testing import generate_test_polygons as jpolys
from nd_tpu.vector import geometry as JG
from nd_tpu_torch.ops import rasterize as TR
from nd_tpu_torch.testing import generate_test_polygons as tpolys
from nd_tpu_torch.vector import geometry as TG


def _twins(kind, *args, **kw):
    """The same geometry built in both packages."""
    return getattr(JG, kind)(*args, **kw), getattr(TG, kind)(*args, **kw)


def _grid(nx=60, ny=50, x0=0.0, y0=0.0, dx=1.0, dy=-1.0):
    xs = x0 + (np.arange(nx) + 0.5) * dx
    ys = y0 + (np.arange(ny) + 0.5) * dy
    return xs, ys


def _same_mask(jg, tg, xs, ys):
    want = np.asarray(JR.polygon_mask(jg, xs, ys))
    got = TR.polygon_mask(tg, xs, ys, device='cpu')
    assert got.dtype == torch.bool and got.device.type == 'cpu'
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def _whole_grid(tg, xs, ys):
    p0, p1 = TR._edges_of(tg)
    return TR._parity(torch.as_tensor(xs, dtype=torch.float64),
                      torch.as_tensor(ys, dtype=torch.float64),
                      p0, p1).numpy()


GRIDS = {
    'descending y': _grid(y0=50.0),
    'ascending y': _grid(dy=1.0),
    'descending x': _grid(x0=60.0, dx=-1.0, y0=50.0),
    'utm 10 m': _grid(nx=70, ny=64, x0=300000.0, y0=5500020.0, dx=10.0,
                      dy=-10.0),
}
SHAPES = {
    'inside': [(10.2, 10.7), (30.9, 12.1), (25.3, 40.4), (12.8, 33.3)],
    'across the left edge': [(-7.3, 5.5), (20.1, 8.8), (14.4, 30.2)],
    'across every edge': [(-5.0, -5.0), (70.0, -3.0), (66.0, 55.0),
                          (-4.0, 58.0)],
    'vertices on centres': [(2.5, 2.5), (40.5, 2.5), (40.5, 30.5),
                            (20.5, 15.5), (2.5, 30.5)],
    'concave, horizontal edges on centre rows': [
        (5.5, 5.5), (35.5, 5.5), (35.5, 25.5), (25.5, 25.5),
        (25.5, 12.5), (15.5, 12.5), (15.5, 25.5), (5.5, 25.5)],
    'between two centres': [(10.6, 10.6), (10.9, 10.6), (10.9, 10.9)],
    'outside': [(100.0, 100.0), (110.0, 100.0), (105.0, 120.0)],
}


def _scaled(coords, grid):
    """A shape's coordinates put on ``grid`` (given in pixel units of a
    unit grid at the origin)."""
    xs, ys = grid
    dx, dy = xs[1] - xs[0], ys[1] - ys[0]
    x0, y0 = xs[0] - dx / 2, ys[0] - dy / 2
    return [(x0 + u * dx, y0 + v * dy) for u, v in coords]


@pytest.mark.parametrize('grid', sorted(GRIDS))
@pytest.mark.parametrize('shape', sorted(SHAPES))
def test_polygon_mask_bit_equal(grid, shape):
    g = GRIDS[grid]
    jg, tg = _twins('Polygon', _scaled(SHAPES[shape], g))
    want = _same_mask(jg, tg, *g)
    np.testing.assert_array_equal(_whole_grid(tg, *g), want)
    if shape in ('outside', 'between two centres'):
        assert not want.any()
    elif shape == 'vertices on centres':
        assert want.sum() > 200


@pytest.mark.parametrize('grid', sorted(GRIDS))
def test_holes_and_multipolygons(grid):
    g = GRIDS[grid]
    shell = _scaled([(3.3, 3.1), (45.2, 4.4), (41.7, 44.9), (6.1, 40.2)], g)
    hole = _scaled([(15.5, 15.5), (30.5, 15.5), (30.5, 30.5),
                    (15.5, 30.5)], g)
    inner = _scaled([(20.1, 20.2), (25.7, 20.3), (23.0, 26.6)], g)
    far = _scaled([(50.2, 2.2), (58.9, 2.9), (55.5, 12.1)], g)
    jp, tp = _twins('Polygon', shell, [hole])
    want = _same_mask(jp, tp, *g)
    np.testing.assert_array_equal(_whole_grid(tp, *g), want)
    jm = JG.MultiPolygon([JG.Polygon(shell, [hole]), JG.Polygon(inner),
                          JG.Polygon(far)])
    tm = TG.MultiPolygon([TG.Polygon(shell, [hole]), TG.Polygon(inner),
                          TG.Polygon(far)])
    want_m = _same_mask(jm, tm, *g)
    np.testing.assert_array_equal(_whole_grid(tm, *g), want_m)
    assert want_m.sum() > want.sum()


@pytest.mark.parametrize('seed', range(4))
def test_random_polygons_bit_equal(seed):
    """Seeded polygons from both generators (the same draws) on a grid
    with descending y, each mask bit-equal and equal to the whole-grid
    count."""
    extent = (300000.0, 5480000.0, 301000.0, 5481000.0)
    xs = extent[0] + (np.arange(97) + 0.5) * (1000 / 97)
    ys = extent[3] - (np.arange(89) + 0.5) * (1000 / 89)
    jp = jpolys(12, extent=extent, random_seed=seed)
    tp = tpolys(12, extent=extent, random_seed=seed)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a.exterior.as_array(),
                                      b.exterior.as_array())
        want = _same_mask(a, b, xs, ys)
        np.testing.assert_array_equal(_whole_grid(b, xs, ys), want)


def test_blocked_comparison_equals_one_block(monkeypatch):
    """The comparison taken a few rows and edges at a time gives the
    same counts as one block."""
    xs, ys = _grid(nx=40, ny=30, y0=30.0)
    tg = tpolys(1, extent=(0.0, 0.0, 40.0, 30.0), random_seed=5)[0]
    tg = TG.Polygon(tg.exterior.coords, [[(15, 12), (20, 12), (18, 16)]])
    one = _whole_grid(tg, xs, ys)
    monkeypatch.setattr(TR, '_COMPARE_BYTES', 40 * 3)   # 3 edges, 1 row
    np.testing.assert_array_equal(_whole_grid(tg, xs, ys), one)
    np.testing.assert_array_equal(
        TR.polygon_mask(tg, xs, ys, device='cpu').numpy(), one)


@pytest.mark.parametrize('fill,dtype', [(0, None), (np.nan, None),
                                        (-1, None), (0, np.float32),
                                        (7, np.int32)])
def test_rasterize_values_bit_equal(fill, dtype):
    """Later pairs on top (overlapping squares), a generator of pairs,
    the dtype that covers values and fill."""
    xs, ys = _grid(y0=50.0)
    sq = [((5, 5, 30, 30), 3), ((20, 20, 45, 40), 5.5),
          ((35.5, 2.5, 55.5, 12.5), 2)]
    want = np.asarray(JR.rasterize_values(
        ((JG.box(*b), v) for b, v in sq), xs, ys, fill=fill, dtype=dtype))
    got = TR.rasterize_values(((TG.box(*b), v) for b, v in sq), xs, ys,
                              fill=fill, dtype=dtype, device='cpu')
    assert str(got.dtype) == 'torch.' + str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rasterize_points_and_lines():
    xs = np.arange(10) + 0.5
    ys = np.arange(8) + 0.5
    pairs = [('Point', (3.4, 2.6), 7), ('Point', (40.0, 2.0), 9),
             ('LineString', ([(0.5, 0.5), (6.5, 6.5), (9.0, 1.0)],), 2)]
    want = np.asarray(JR.rasterize_values(
        [(getattr(JG, k)(*a), v) for k, a, v in pairs], xs, ys, fill=0))
    got = TR.rasterize_values(
        [(getattr(TG, k)(*a), v) for k, a, v in pairs], xs, ys, fill=0,
        device='cpu')
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[2, 3] == 7 and int((got == 2).sum()) >= 6
    for kind, args, _ in pairs:
        _same_mask(getattr(JG, kind)(*args), getattr(TG, kind)(*args),
                   xs, ys)


def test_grid_device_follows_the_coordinates():
    xs, ys = _grid(nx=12, ny=9, y0=9.0)
    tg = TG.box(2, 2, 8, 6)
    from_tensor = TR.polygon_mask(tg, torch.as_tensor(xs), ys)
    assert from_tensor.device.type == 'cpu'
    out = TR.rasterize_values([(tg, 4)], torch.as_tensor(xs),
                              torch.as_tensor(ys))
    assert out.device.type == 'cpu'
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        JR.rasterize_values([(JG.box(2, 2, 8, 6), 4)], xs, ys)))
    with pytest.raises(TypeError, match='cannot rasterize'):
        TR.polygon_mask(object(), xs, ys, device='cpu')
