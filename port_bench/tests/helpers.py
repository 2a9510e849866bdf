"""Small cells for the CPU tests: the benchmark's own cells with their
tiles shrunk, so that the plain paths of the program run them here."""

import copy
import os

from harness.spec import load_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CELLS = ('s1_k12.readme_chain', 's1_k56.year_chain', 's1_k12.omnibus_only',
         's1_k56.omnibus_only')


def small_cell(name, y=96, x=128, k56=20, pool=2, patch=16, root=ROOT):
    """The cell ``name`` at a CPU test's size (a longer series keeps
    more than 48 dates only where ``k56`` says so)."""
    cell = load_cell(root, name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config.update(y=y, x=x, pool_tiles=pool)
    if cell.config['time'] > 12:
        cell.config['time'] = k56
    cell.traffic['patch'] = patch
    return cell
