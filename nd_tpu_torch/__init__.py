"""nd_tpu_torch — nd_tpu on PyTorch, with CUDA kernels written for
Hopper (sm_90a): spatial and spatio-temporal NLMeans, boxcar and
Gaussian filters, exact omnibus change detection for short and long
series, and the georeferencing layer in front of them (CRS, reprojection,
resampling and coregistration, with the ``ds.nd.*`` / ``ds.filter.*``
accessors), the flagship model's training step, the classifiers
(scikit-learn bridge and ``TorchClassifier``) and checkpoints
(``nd_tpu_torch.models.checkpoint``), the I/O (netCDF, GeoTIFF,
ENVI, zarr, BEAM-DIMAP, JPEG 2000 and Sentinel-2 granules:
``open_dataset``, ``to_netcdf``, ``nd_tpu_torch.io``) with lazy opens
(``chunks=``), tiling for cubes larger than memory
(``nd_tpu_torch.tiling``: ``ds.nd.tile``, ``map_over_tiles``,
``auto_merge``), vector data rasterized onto a grid
(``nd_tpu_torch.vector``, ``nd_tpu_torch.ops.rasterize``), tracing
(``nd_tpu_torch.tracing``: host spans, ``torch.profiler`` traces, NVTX
ranges) and visualization (``to_rgb``, ``write_video``,
``nd_tpu_torch.visualize_map.render_map``; cv2 and imageio optional).

Tensors stay on the device the caller put them on and keep their dtype.
On a CUDA tensor each kernel wrapper launches its kernel (built from
``csrc/*.cu`` with nvcc at first use) or raises; on a CPU tensor it runs
the kernel's plain PyTorch version. The JPEG 2000 decoder's Tier-1 is
host C++ (``native/jp2_t1.cpp``), built with g++ at first use, as are
the host C++ oracles of NLMeans and change detection (``native``).
"""

from .algorithm import Algorithm, parallelize, wrap_algorithm
from .change import OmnibusTest, omnibus
from .classify import Classifier, TorchClassifier, class_mean
from .core import (DataArray, Dataset, Variable, concat, from_jax_dataset,
                   merge)
from .crs import CRS, Affine, transform_coords
from .filters import (BoxcarFilter, ConvolutionFilter, GaussianFilter,
                      NLMeansFilter, boxcar, convolution, gaussian, nlmeans)
from .io import (assemble_complex, disassemble_complex, open_dataset,
                 to_netcdf)
from .models import SARChangePipeline, change_features, multilook
from .warp import (Coregistration, Reprojection, Resample, coregister,
                   reproject, resample)
from . import tiling  # noqa: F401
from .tiling import auto_merge
from . import tracing  # noqa: F401
from . import accessors  # noqa: E402,F401  (attaches .nd / .filter)

try:
    import imageio  # noqa: F401  (the JAX package's visualize needs it)
except ImportError:
    to_rgb = write_video = None
else:
    from .visualize import to_rgb, write_video

__all__ = ['Algorithm', 'parallelize', 'wrap_algorithm', 'Variable',
           'DataArray', 'Dataset', 'from_jax_dataset', 'concat', 'merge',
           'open_dataset', 'to_netcdf', 'CRS', 'Affine',
           'transform_coords', 'BoxcarFilter', 'ConvolutionFilter',
           'GaussianFilter', 'NLMeansFilter', 'boxcar', 'convolution',
           'gaussian', 'nlmeans', 'OmnibusTest', 'omnibus', 'Classifier',
           'TorchClassifier', 'class_mean', 'assemble_complex',
           'disassemble_complex', 'SARChangePipeline', 'multilook',
           'change_features', 'Reprojection', 'Resample', 'Coregistration',
           'reproject', 'resample', 'coregister', 'auto_merge', 'to_rgb',
           'write_video']
