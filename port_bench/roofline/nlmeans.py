"""The work of an NLMeans stage, counted from its shapes.

Bytes: the cube read once and the filtered cube written once. Operations
(float32), per output pixel and unordered offset pair of the search
window: the squared differences summed over the variables (3 nvars - 1),
the separable patch sums (2 per unit of patch radius on each axis), the
weight (division, subtraction, max, product, exp: 5) and both
directions' weighted adds (2 (2 nvars + 2)). A pair's distance serves
both of its directions, so a pair is the least work the inputs need.
Frozen from the port's ``chip_smoke.nlmeans_bound``.
"""

from __future__ import annotations

from reference.nlmeans import window

READS_OUTPUT = False      # counted from the shapes alone


def work(shape, nvars, params, dims, output=None):
    """{'bytes', 'f32_ops', 'f64_ops'} of one stage call on a tile of
    ``shape`` (over ``dims``) with ``nvars`` float32 variables."""
    del output
    r, f = window(params, dims)
    npix = 1
    for s in shape:
        npix *= int(s)
    size = 1
    for ri in r:
        size *= 2 * ri + 1
    pairs = (size - 1) // 2
    per_pair = (3 * nvars - 1) + 2 * sum(f) + 5 + 2 * (2 * nvars + 2)
    return {'bytes': 2 * npix * nvars * 4,
            'f32_ops': npix * pairs * per_pair, 'f64_ops': 0}
