"""Vectorized ellipsoidal geodesics (Vincenty's formulae).

Powers the azimuthal-equidistant projection (``+proj=aeqd``), geodesic
scale bars, and ground-distance queries. Accuracy is ~0.5 mm on
WGS84-like ellipsoids everywhere except nearly-antipodal pairs, where
the inverse iteration does not converge and the result is masked NaN
(documented Vincenty limitation; EO scenes never span antipodes).

The port's own copy of ``nd_tpu/crs/geodesic.py`` (numpy only):
self-contained and array-vectorized, in place of ``cartopy.geodesic`` /
pyproj's Geod.
"""

from __future__ import annotations

import numpy as np

__all__ = ['geodesic_inverse', 'geodesic_direct']


def _reduced_latitude(lat, f, xp):
    """sin/cos of the reduced latitude, pole-safe (no tan infinity)."""
    s, c = xp.sin(lat), xp.cos(lat)
    norm = xp.hypot((1.0 - f) * s, c)
    return (1.0 - f) * s / norm, c / norm


def geodesic_inverse(lon1, lat1, lon2, lat2, ell, xp=np, iters=32):
    """Geodesic between two points: (s, azi1, azi2).

    All angles in radians; ``s`` in meters. Inputs broadcast.
    Nearly-antipodal pairs (non-convergent) come back NaN.
    """
    a, b, f = ell.a, ell.b, ell.f
    lon1 = xp.asarray(lon1, dtype=np.float64)
    lat1 = xp.asarray(lat1, dtype=np.float64)
    lon2 = xp.asarray(lon2, dtype=np.float64)
    lat2 = xp.asarray(lat2, dtype=np.float64)
    su1, cu1 = _reduced_latitude(lat1, f, xp)
    su2, cu2 = _reduced_latitude(lat2, f, xp)
    L = lon2 - lon1
    lam = L
    tiny = 1e-300

    def geometry(lam):
        """Vincenty angular geometry at longitude difference lam."""
        sl, cl = xp.sin(lam), xp.cos(lam)
        sin_sigma = xp.hypot(cu2 * sl, cu1 * su2 - su1 * cu2 * cl)
        cos_sigma = su1 * su2 + cu1 * cu2 * cl
        sigma = xp.arctan2(sin_sigma, cos_sigma)
        sin_alpha = cu1 * cu2 * sl / xp.where(sin_sigma == 0.0, tiny,
                                              sin_sigma)
        cos2_alpha = xp.clip(1.0 - sin_alpha * sin_alpha, 0.0, 1.0)
        # equatorial geodesic: cos²α = 0 makes cos(2σ_m) irrelevant
        cos2sm = xp.where(cos2_alpha == 0.0, 0.0,
                          cos_sigma - 2.0 * su1 * su2
                          / xp.where(cos2_alpha == 0.0, 1.0,
                                     cos2_alpha))
        return sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha, \
            cos2sm

    for _ in range(iters):
        (sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha,
         cos2sm) = geometry(lam)
        C = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
        lam_new = L + (1.0 - C) * f * sin_alpha * (
            sigma + C * sin_sigma * (
                cos2sm + C * cos_sigma * (-1.0 + 2.0 * cos2sm ** 2)))
        delta = xp.abs(lam_new - lam)
        lam = lam_new
    converged = delta < 1e-12
    # final geometry from the converged longitude difference
    (sin_sigma, cos_sigma, sigma, sin_alpha, cos2_alpha,
     cos2sm) = geometry(lam)
    sl, cl = xp.sin(lam), xp.cos(lam)
    u2 = cos2_alpha * (a * a - b * b) / (b * b)
    A = 1.0 + u2 / 16384.0 * (4096.0 + u2 * (-768.0 + u2
                                             * (320.0 - 175.0 * u2)))
    B = u2 / 1024.0 * (256.0 + u2 * (-128.0 + u2 * (74.0 - 47.0 * u2)))
    dsigma = B * sin_sigma * (
        cos2sm + B / 4.0 * (
            cos_sigma * (-1.0 + 2.0 * cos2sm ** 2)
            - B / 6.0 * cos2sm * (-3.0 + 4.0 * sin_sigma ** 2)
            * (-3.0 + 4.0 * cos2sm ** 2)))
    s = b * A * (sigma - dsigma)
    azi1 = xp.arctan2(cu2 * sl, cu1 * su2 - su1 * cu2 * cl)
    azi2 = xp.arctan2(cu1 * sl, -su1 * cu2 + cu1 * su2 * cl)
    bad = ~converged
    nan = xp.where(bad, xp.nan, 1.0)
    return s * nan, azi1 * nan, azi2 * nan


def geodesic_direct(lon1, lat1, azi1, s, ell, xp=np, iters=12):
    """Destination point: (lon2, lat2, azi2) from start, azimuth,
    distance. All angles in radians; ``s`` in meters. Broadcasts."""
    a, b, f = ell.a, ell.b, ell.f
    lon1 = xp.asarray(lon1, dtype=np.float64)
    lat1 = xp.asarray(lat1, dtype=np.float64)
    azi1 = xp.asarray(azi1, dtype=np.float64)
    s = xp.asarray(s, dtype=np.float64)
    su1, cu1 = _reduced_latitude(lat1, f, xp)
    sa1, ca1 = xp.sin(azi1), xp.cos(azi1)
    sigma1 = xp.arctan2(su1, cu1 * ca1)
    sin_alpha = cu1 * sa1
    cos2_alpha = xp.clip(1.0 - sin_alpha * sin_alpha, 0.0, 1.0)
    u2 = cos2_alpha * (a * a - b * b) / (b * b)
    A = 1.0 + u2 / 16384.0 * (4096.0 + u2 * (-768.0 + u2
                                             * (320.0 - 175.0 * u2)))
    B = u2 / 1024.0 * (256.0 + u2 * (-128.0 + u2 * (74.0 - 47.0 * u2)))
    sigma = s / (b * A)
    for _ in range(iters):
        cos2sm = xp.cos(2.0 * sigma1 + sigma)
        ss, cs = xp.sin(sigma), xp.cos(sigma)
        dsigma = B * ss * (
            cos2sm + B / 4.0 * (
                cs * (-1.0 + 2.0 * cos2sm ** 2)
                - B / 6.0 * cos2sm * (-3.0 + 4.0 * ss ** 2)
                * (-3.0 + 4.0 * cos2sm ** 2)))
        sigma = s / (b * A) + dsigma
    cos2sm = xp.cos(2.0 * sigma1 + sigma)
    ss, cs = xp.sin(sigma), xp.cos(sigma)
    tmp = su1 * ss - cu1 * cs * ca1
    lat2 = xp.arctan2(su1 * cs + cu1 * ss * ca1,
                      (1.0 - f) * xp.hypot(sin_alpha, tmp))
    lam = xp.arctan2(ss * sa1, cu1 * cs - su1 * ss * ca1)
    C = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
    L = lam - (1.0 - C) * f * sin_alpha * (
        sigma + C * ss * (cos2sm + C * cs
                          * (-1.0 + 2.0 * cos2sm ** 2)))
    lon2 = lon1 + L
    azi2 = xp.arctan2(sin_alpha, -tmp)
    return lon2, lat2, azi2
