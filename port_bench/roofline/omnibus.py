"""The work of an OmnibusTest stage: the multilook and the test's steps
that the output flags imply.

Bytes: the input cube read once and the change map (one byte a flag)
written once; no intermediate (the multilooked cube) is counted, so a
fused multilook cannot read above its bound. Operations (float32): the
boxcar's separable passes (``ml - 1`` adds and one scale on the first
axis, ``ml - 1`` adds on the second) per element; the test counted as
the port's ``chip_smoke.round_bound`` counts it without margins: per
pixel and date the terms that do not depend on the anchor (the
determinant, its log, the sign: 6 + MLOG_OPS), per step of a round the
running sums and the sign parity (6), per tested step the window's
statistic (19 + MLOG_OPS). One round runs from date 0 and one from each
flag before the last date, each to the end of the series. The exact
mode's float64 rescan is its own choice of how to reach the decisions
and is not counted as work.
"""

from __future__ import annotations

import torch

READS_OUTPUT = True      # the test's steps follow from the output flags
MLOG_OPS = 25        # a float32 log, as csrc/mlog.cuh computes it


def steps(flags):
    """(steps, tested steps) of the scan that a (..., k) bool change map
    implies."""
    k = flags.shape[-1]
    rows = flags.reshape(-1, k)
    anchors = rows[:, :k - 1]
    rest = (k - torch.arange(k - 1, device=flags.device)) * anchors
    rounds = rows.shape[0] + int(anchors.sum())
    total = rows.shape[0] * k + int(rest.sum())
    return total, total - rounds


def work(shape, nvars, params, dims, output):
    """{'bytes', 'f32_ops', 'f64_ops'} of one stage call on a tile of
    ``shape`` with ``nvars`` float32 variables and the (y, x, time) bool
    change map ``output``."""
    del dims
    npix = 1
    for s in shape:
        npix *= int(s)
    ml = int(params['ml'])
    total, tested = steps(output)
    looks = npix * nvars * (2 * ml - 1)
    test = (npix * (6 + MLOG_OPS) + total * 6
            + tested * (19 + MLOG_OPS))
    return {'bytes': npix * nvars * 4 + npix,
            'f32_ops': looks + test, 'f64_ops': 0}
