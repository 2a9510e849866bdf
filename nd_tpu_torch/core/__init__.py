"""Data model with torch payloads."""

from .dataarray import (DataArray, Dataset, broadcast, concat,
                        from_jax_dataset, full_like, merge, ones_like,
                        zeros_like)
from .variable import Variable, as_array

__all__ = ['Variable', 'DataArray', 'Dataset', 'from_jax_dataset',
           'concat', 'merge', 'broadcast', 'full_like', 'zeros_like',
           'ones_like', 'as_array']
