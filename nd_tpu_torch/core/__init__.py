"""Data model with torch payloads."""

from .dataarray import DataArray, Dataset, from_jax_dataset
from .variable import Variable

__all__ = ['Variable', 'DataArray', 'Dataset', 'from_jax_dataset']
