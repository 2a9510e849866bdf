"""What a traffic generator hands the harness for one tile, and the
seed of a tile.

A generator is ``generators/<name>.py``, named by a traffic mix's
``generator`` key, with ``make(config, traffic, seed, index, device)``
returning a ``Scene``: the benchmark's own tensors, which the plain
references read, and the program's Dataset built from them, with the
coordinates and attributes a user's Dataset has.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ['Scene', 'tile_seed']

_GOLDEN = 0x9E3779B97F4A7C15


@dataclass
class Scene:
    inputs: dict        # {variable: tensor on its dims}, the benchmark's
    dataset: object     # the program's Dataset of the same tensors


def tile_seed(seed, index):
    """A 63-bit generator seed for tile ``index`` of run ``seed``."""
    return (int(seed) * _GOLDEN + int(index) * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB) % (1 << 63)
