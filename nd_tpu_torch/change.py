"""Time-series change detection on SAR covariance datacubes.

Counterpart of ``nd_tpu/change.py``: ``OmnibusTest`` and the ``omnibus``
functional wrapper. Where a kernel serves the series length
(``ops.change_cuda.supports_rescan``: the round kernel up to 48 steps,
the sequential scan up to 256 with feasible thresholds) the scan is the
exact mode of ``ops.change.change_detection_exact``: a float32 kernel
plus a float64 rescan of the near-margin pixels. Otherwise it is the
float64 'mixed' scan of the whole grid. Either way the change map equals
the float64 'mixed' decisions. The result stays on the input's device.
"""

from __future__ import annotations

from .algorithm import Algorithm, wrap_algorithm
from .core import DataArray
from .filters import BoxcarFilter
from .io import disassemble_complex
from .ops.change import change_detection_exact
from .tracing import span

__all__ = ['ChangeDetection', 'OmnibusTest', 'omnibus']

MARGIN_EPS = 1e-4


class ChangeDetection(Algorithm):
    """Abstract base class for change detection algorithms."""

    njobs = 1

    def __init__(self, njobs=1):
        self.njobs = njobs


def _omnibus_change_detection(ds, alpha=0.01, ml=None, n=1):
    """Change detection after Conradsen et al. (2016) on a covariance
    Dataset (``C11``, ``C12`` complex or ``C12__re``/``C12__im``,
    ``C22``); returns the (y, x, time) bool change map."""
    ds_m = disassemble_complex(ds)
    if ml is not None:
        ds_m = BoxcarFilter(w=ml).apply(ds_m)
        n = ml ** 2
    with span('data.omnibus_in'):
        da = ds_m[['C11', 'C12__re', 'C12__im', 'C22']].to_array()
        values = da.transpose('y', 'x', 'time', 'variable').data.contiguous()
    # change_detection_exact takes the route (kernel + rescan, or the
    # whole-grid 'mixed' scan) from (k, n, alpha) before any launch
    change = change_detection_exact(values, float(alpha), n=int(n),
                                    margin_eps=MARGIN_EPS)
    with span('omnibus.result'):
        out = DataArray(change, dims=('y', 'x', 'time'),
                        attrs=dict(ds.attrs), name='change')
        for ck, cv in ds._coords.items():
            if set(cv.dims).issubset({'y', 'x', 'time'}):
                out._coords[ck] = cv
    return out


class OmnibusTest(ChangeDetection):
    """Complex-Wishart omnibus change detection (Conradsen et al. 2016)
    for dual-pol SAR covariance time series.

    Parameters
    ----------
    ml : int, optional
        Window size for on-the-fly boxcar multilooking; omit when the
        dataset is already multilooked.
    n : int, optional
        Number of looks the cube carries. Ignored (and derived as
        ``ml**2``) when ``ml`` is given (default: 1).
    alpha : float in (0, 1), optional
        Significance level of the per-test rejection (default: 0.01).
    kwargs : dict, optional
        Forwarded to ``ChangeDetection.__init__`` (e.g. ``njobs``).
    """

    def __init__(self, ml=None, n=1, alpha=0.01, *args, **kwargs):
        self.ml = ml
        self.n = n
        self.alpha = alpha
        super().__init__(*args, **kwargs)

    def apply(self, ds):
        with span('OmnibusTest.apply'):
            return _omnibus_change_detection(ds, alpha=self.alpha,
                                             ml=self.ml, n=self.n)


omnibus = wrap_algorithm(OmnibusTest, 'omnibus')
