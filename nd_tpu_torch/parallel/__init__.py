"""Mesh-sharded device parallelism: halo exchange, sharded filters and
data-parallel pixelwise kernels, and multi-process execution
(``parallel.distributed``). Counterpart of ``nd_tpu/parallel``."""

from .mesh import get_mesh, factorize2d
from .halo import halo_pad, halo_trim, shard_apply
from .engine import (apply_sharded, shard_dataset,
                     sharded_change_detection, sharded_reproject)
from . import distributed  # noqa: F401

__all__ = ['get_mesh', 'factorize2d', 'halo_pad', 'halo_trim',
           'shard_apply', 'apply_sharded', 'shard_dataset',
           'sharded_change_detection', 'sharded_reproject']
