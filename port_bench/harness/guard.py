"""The check that the run loaded neither JAX nor the JAX package.

Module names are compared by their top-level part (before the first
dot) whole: ``nd_tpu_torch`` is the port, ``nd_tpu`` the JAX package."""

from __future__ import annotations

import sys

__all__ = ['FORBIDDEN', 'forbidden']

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'nd_tpu')


def forbidden(modules=None):
    """Sorted names in ``modules`` (default ``sys.modules``) whose
    top-level name is forbidden."""
    if modules is None:
        modules = list(sys.modules)
    return sorted(m for m in modules if m.split('.')[0] in FORBIDDEN)
