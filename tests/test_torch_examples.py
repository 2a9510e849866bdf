"""The four runnable workflows of ``examples/`` against their port copies
in ``examples_torch/``, on the CPU: each copy prints exactly the lines
its original prints and returns arrays that agree within rtol 1e-5,
atol 1e-6; the copies import neither JAX nor nd_tpu."""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKFLOWS = ['continental_mosaic', 'geostationary_disk',
             'out_of_core_mosaic', 'timeseries_gapfill']
TOL = dict(rtol=1e-5, atol=1e-6)


def load(folder, name):
    """``<folder>/<name>.py`` as a module of its own name (the two
    folders hold modules of the same names)."""
    path = os.path.join(REPO, folder, name + '.py')
    spec = importlib.util.spec_from_file_location('%s_%s' % (folder, name),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(capsys, fn):
    out = fn()
    return out, capsys.readouterr().out.splitlines()


def close(got, ref):
    """Two results of a workflow: Datasets and DataArrays variable by
    variable (dims, values, coordinates), other values as arrays."""
    if hasattr(ref, 'data_vars'):
        assert sorted(got.data_vars) == sorted(ref.data_vars)
        for v in ref.data_vars:
            close(got[v], ref[v])
        for c in ref.coords:
            close(got[c], ref[c])
        return
    if hasattr(ref, 'dims'):
        assert tuple(got.dims) == tuple(ref.dims)
    g = np.asarray(got.values if hasattr(got, 'values') else got)
    r = np.asarray(ref.values if hasattr(ref, 'values') else ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    if r.dtype.kind in 'fc':
        np.testing.assert_allclose(g, r, equal_nan=True, **TOL)
    else:
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize('name', ['continental_mosaic', 'geostationary_disk',
                                  'timeseries_gapfill'])
def test_workflow_matches_nd_tpu(name, capsys):
    ref, ref_lines = run(capsys, load('examples', name).main)
    got, lines = run(capsys, lambda: load('examples_torch', name).main(
        device='cpu'))
    assert lines == ref_lines and lines
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        close(g, r)


def test_out_of_core_mosaic_matches_nd_tpu(tmp_path, capsys):
    from nd_tpu.io import open_netcdf as jopen
    from nd_tpu_torch.io import open_netcdf
    ref_dir, ref_lines = run(capsys, lambda: load(
        'examples', 'out_of_core_mosaic').main(str(tmp_path / 'a')))
    got_dir, lines = run(capsys, lambda: load(
        'examples_torch', 'out_of_core_mosaic').main(str(tmp_path / 'b'),
                                                     device='cpu'))
    assert [s.replace(got_dir, ref_dir) for s in lines] == ref_lines
    assert len(lines) == 3
    name = 'mosaic_3395.nc'
    close(open_netcdf(os.path.join(got_dir, name), device='cpu'),
          jopen(os.path.join(ref_dir, name)))


def test_sizes_are_keywords_with_the_original_defaults(capsys):
    ts = load('examples_torch', 'timeseries_gapfill')
    mosaic, filled, series = ts.main(device='cpu', ny=24, nx=32, k=6)
    assert filled.sizes['time'] == 6 and mosaic.sizes['y'] == 24
    assert isinstance(filled.data, torch.Tensor)
    assert filled.data.device.type == 'cpu'
    cm = load('examples_torch', 'continental_mosaic')
    out = cm.main(device='cpu', ny=30, nx=40, k=1, res=40000.0)
    assert out.sizes['time'] == 1
    geo = load('examples_torch', 'geostationary_disk')
    disk, europe, laea = geo.main(device='cpu', n=64)
    assert disk.sizes == {'y': 64, 'x': 64}
    capsys.readouterr()


def test_examples_torch_import_no_jax_or_nd_tpu():
    """Their own imports (the package's are checked in a fresh process by
    tests/test_torch_package.py::test_import_loads_no_jax)."""
    for name in WORKFLOWS:
        with open(os.path.join(REPO, 'examples_torch', name + '.py')) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or '']
            else:
                continue
            for m in mods:
                assert m.split('.')[0] not in ('jax', 'jaxlib', 'nd_tpu'), \
                    (name, m)
