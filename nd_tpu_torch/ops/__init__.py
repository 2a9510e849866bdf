"""Array operations on torch tensors: convolution, non-local means,
change detection, statistics, interpolation. The ``*_cuda`` modules hold
the CUDA kernels' wrappers and their plain PyTorch versions.
(``ops.nlmeans`` stays the module: its function is
``ops.nlmeans.nlmeans``.)"""

from .conv import convolve, gaussian_kernel1d, separable_convolve
from .stats import chi2_cdf
from .change import (change_detection, change_detection_exact,
                     change_detection_hybrid, omnibus_probabilities)
from .fft import (fourier_shift, phase_cross_correlation,
                  phase_cross_correlation_batch, translate, translate_batch)
from .interp import map_coordinates

__all__ = ['convolve', 'separable_convolve', 'gaussian_kernel1d',
           'chi2_cdf', 'change_detection',
           'change_detection_exact', 'change_detection_hybrid',
           'omnibus_probabilities',
           'phase_cross_correlation', 'phase_cross_correlation_batch',
           'fourier_shift', 'translate', 'translate_batch',
           'map_coordinates']
