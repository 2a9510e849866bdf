"""A cell as ``BENCHMARK.json`` and the files it names describe it.

- ``BENCHMARK.json`` ``workloads[]``: the cell's configuration and
  traffic mix; ``configs[]``: the configuration's file; the metrics,
  each reported in the cells its ``workloads`` list names (all cells
  without one).
- ``configs/<config>.json``: the deployment: the tile's size on each
  of its ``dims``, variables,
  dtype, pool of tiles on the card, the chain's stages and parameters.
- ``traffic/<traffic>.json``: the mix: which stages of the chain each
  tile goes through, its generator and the generator's parameters.
- ``workloads/<cell>.json``: the cell's limits on the numbers its
  checks compare, and how many of the window's tiles are checked.
- ``generators/<name>.py`` (named by a mix's ``generator``),
  ``stages/<kind>.py``, ``metrics/<name>.py``, ``roofline/<kind>.py``:
  loaded by file path.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ['Cell', 'load_cell', 'load_plugin', 'load_json', 'BENCH_DIR']

BENCH_DIR = 'port_bench'
_PLUGINS = {}


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_plugin(root, kind, name):
    """The module ``<root>/port_bench/<kind>/<name>.py``."""
    path = (Path(root) / BENCH_DIR / kind / ('%s.py' % name)).resolve()
    mod = _PLUGINS.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError('no %s named %r (%s)' % (kind, name,
                                                             path))
        modname = 'port_bench_%s_%s' % (kind, name.replace('.', '_'))
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PLUGINS[path] = mod
    return mod


def _applies(metric, cell):
    return 'workloads' not in metric or cell in metric['workloads']


@dataclass
class Cell:
    root: Path
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    check_tiles: int
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def stages(self):
        """[(kind, parameters)] in the order each tile goes through."""
        return [(kind, self.config['chain'][kind])
                for kind in self.traffic['stages']]

    @property
    def tile_shape(self):
        return tuple(int(self.config[d]) for d in self.config['dims'])

    @property
    def tile_pixels(self):
        n = 1
        for s in self.tile_shape:
            n *= s
        return n


def load_cell(root, name):
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    root = Path(root)
    bench = load_json(root / 'BENCHMARK.json')
    entries = [w for w in bench['workloads'] if w['name'] == name]
    if len(entries) != 1:
        raise KeyError('no workload named %r in BENCHMARK.json' % name)
    entry = entries[0]
    config_file = [c['file'] for c in bench['configs']
                   if c['name'] == entry['config']]
    if len(config_file) != 1:
        raise KeyError('no configuration named %r' % entry['config'])
    cell_file = load_json(root / BENCH_DIR / 'workloads'
                          / ('%s.json' % name))
    return Cell(
        root=root, name=name, config_name=entry['config'],
        traffic_name=entry['traffic'], chips=int(entry['chips']),
        config=load_json(root / config_file[0]),
        traffic=load_json(root / BENCH_DIR / 'traffic'
                          / ('%s.json' % entry['traffic'])),
        limits=dict(cell_file['limits']),
        check_tiles=int(cell_file['check_tiles']),
        end_to_end=[m for m in bench['end_to_end'] if _applies(m, name)],
        per_layer=[m for m in bench['per_layer'] if _applies(m, name)])
