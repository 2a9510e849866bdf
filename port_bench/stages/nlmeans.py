"""Stage 'nlmeans': ``NLMeansFilter(**params).apply`` on the tile's
Dataset, judged against the textbook NLMeans in float64
(``reference/nlmeans.py``); its control is that reference in bfloat16,
the precision below the float32 the configuration states, in the
program's place.

``outputs`` reads ``result[v].data`` of the program's Dataset; a
control hands on a dict of tensors, whose ``.data`` is the tensor."""

from __future__ import annotations

import torch

from reference import nlmeans as ref
from reference.omnibus import VARIABLES

CHECKS = ('nlmeans_err',)


def make(params):
    """The program's filter."""
    import nd_tpu_torch as ndt
    return ndt.NLMeansFilter(dims=tuple(params['dims']), r=params['r'],
                             f=params['f'], sigma=params['sigma'],
                             h=params['h'])


def outputs(result):
    """The filter's Dataset as the check reads it: {variable: tensor}."""
    return {v: result[v].data for v in VARIABLES}


def _reference(inputs, params, dims, dtype):
    r, f = ref.window(params, dims)
    cube = torch.stack([inputs[v] for v in VARIABLES], -1)
    return ref.nlmeans(cube, r, f, params['sigma'], params['h'], dtype)


def check(inputs, got, params, dims):
    """{'nlmeans_err'}: the largest of each variable's max |got - ref|
    over its max |ref|."""
    want = _reference(inputs, params, dims, torch.float64)
    errs = [(got[v].to(want.dtype) - want[..., i]).abs().max()
            / want[..., i].abs().max() for i, v in enumerate(VARIABLES)]
    return {'nlmeans_err': float(torch.stack(errs).max())}   # NaN stays


class _Control:
    """The reference in bfloat16, handed on in float32."""

    def __init__(self, params, dims):
        self.params, self.dims = params, dims

    def apply(self, x):
        inputs = {v: x[v].data for v in VARIABLES}
        out = _reference(inputs, self.params, self.dims, torch.bfloat16)
        return {v: out[..., i].to(torch.float32)
                for i, v in enumerate(VARIABLES)}


CONTROLS = {'control': _Control}
