"""nd_tpu_torch — the SAR change path of nd_tpu on PyTorch, with CUDA
kernels written for Hopper (sm_90a): spatial and spatio-temporal NLMeans,
boxcar and Gaussian filters, and exact omnibus change detection for short
and long series.

Tensors stay on the device the caller put them on and keep their dtype.
On a CUDA tensor each kernel wrapper launches its kernel (built from
``csrc/*.cu`` with nvcc at first use) or raises; on a CPU tensor it runs
the kernel's plain PyTorch version.
"""

from .algorithm import Algorithm, parallelize, wrap_algorithm
from .change import OmnibusTest, omnibus
from .core import DataArray, Dataset, Variable, from_jax_dataset
from .filters import (BoxcarFilter, ConvolutionFilter, GaussianFilter,
                      NLMeansFilter, boxcar, convolution, gaussian, nlmeans)
from .io import disassemble_complex
from .models import SARChangePipeline, multilook

__all__ = ['Algorithm', 'parallelize', 'wrap_algorithm', 'Variable',
           'DataArray', 'Dataset', 'from_jax_dataset', 'BoxcarFilter',
           'ConvolutionFilter', 'GaussianFilter', 'NLMeansFilter', 'boxcar',
           'convolution', 'gaussian', 'nlmeans', 'OmnibusTest', 'omnibus',
           'disassemble_complex', 'SARChangePipeline', 'multilook']
