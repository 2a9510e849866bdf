"""Stage 'omnibus': ``OmnibusTest(ml, alpha).apply`` on the Dataset it
is handed, judged flag by flag against the plain omnibus test
(``reference/omnibus.py``: the float32 multilook, the 'mixed' scan with
float64 decisions). In the program's place: ``control``, that
reference with the statistic and the decisions in float32 and the
multilook in bfloat16, each the precision below the one the
configuration states; ``stat32``, the statistic and the decisions alone
in float32 (the float64 the configuration states for them, dropped).

``outputs`` reads ``result.data`` of the program's DataArray; a control
hands on a tensor, whose ``.data`` is itself."""

from __future__ import annotations

import torch

from reference import omnibus as ref

CHECKS = ('change_mismatch',)


def make(params):
    """The program's test."""
    import nd_tpu_torch as ndt
    return ndt.OmnibusTest(ml=params['ml'], alpha=params['alpha'])


def outputs(result):
    """The (y, x, time) bool change map."""
    return result.data


def check(inputs, got, params, dims):
    """{'change_mismatch'}: flags that differ from the reference's."""
    del dims
    want = ref.change_map(inputs, int(params['ml']), float(params['alpha']))
    return {'change_mismatch': int((got != want).sum())}


def describe(got):
    """What the change map says of the scene: the share of pixels with a
    flag, and the change points a pixel (mean, most)."""
    per_px = got.sum(-1, dtype=torch.int32)
    return {'flagged_px_pct': 100.0 * float((per_px > 0).double().mean()),
            'change_points_per_px': float(per_px.double().mean()),
            'change_points_max': float(per_px.max())}


class _Control:
    def __init__(self, params, dims, looks):
        del dims
        self.ml, self.alpha = int(params['ml']), float(params['alpha'])
        self.looks = looks

    def apply(self, x):
        inputs = {v: x[v].data for v in ref.VARIABLES}
        return ref.change_map(inputs, self.ml, self.alpha, stat='float32',
                              looks=self.looks)


CONTROLS = {
    'control': lambda params, dims: _Control(params, dims, torch.bfloat16),
    'stat32': lambda params, dims: _Control(params, dims, torch.float32),
}
