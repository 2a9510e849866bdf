"""The long-series scan kernel's host plan (``change_scan_cuda._scan_plan``
and the sweep's ``plan_candidates``) on the CPU: for every series length
the kernel takes and for image sizes both below and above a block's
pixels, each plan fits the H100's shared memory, its chunks cover the
series, and a block's copies and threads cover its pixels exactly once.

The chunks and the copy mapping below mirror ``load_chunk`` in
``nd_tpu_torch/csrc/omnibus_scan.cu`` (chunk c holds steps c*T .. c*T +
L - 1, L = min(T, k - c*T); item i = q * L + s of a chunk goes to thread
i % threads, walked with the kernel's incremental arithmetic).

The round kernel's plan (``change_cuda._round_plan`` and its sweep's
``round_plan_candidates``) is checked the same way: resident exactly up
to ``RESIDENT_K`` steps, within the shared memory, one thread a pixel.
"""

import functools
from collections import Counter

import pytest

from nd_tpu_torch.ops import change_scan_cuda as scan

KS = range(3, scan.K_SCAN_MAX + 1)
NPIX = [1, 31, 1000, 131072, 1 << 20]


def _chunks(k, T):
    """(first step, steps) of each chunk of a series of k steps."""
    return [(t0, min(T, k - t0)) for t0 in range(0, k, T)]


@functools.lru_cache(maxsize=None)
def _copies(threads, pv, L):
    """(pixel, step) -> number of copies a block of ``threads`` threads
    makes of a chunk of ``L`` steps of its ``pv`` pixels."""
    seen = Counter()
    dq, ds = divmod(threads, L)
    for tid in range(threads):
        q, s = divmod(tid, L)
        for _ in range(tid, pv * L, threads):
            seen[(q, s)] += 1
            q += dq
            s += ds
            if s >= L:
                s -= L
                q += 1
    return seen


def _plans(npix):
    return [(k, scan._scan_plan(k, npix)) for k in KS]


@pytest.mark.parametrize('npix', NPIX)
def test_scan_plan_fits_the_shared_memory(npix):
    for k, plan in _plans(npix):
        assert plan['smem'] == scan.scan_smem(k, plan['threads'], plan['T'],
                                              plan['nbuf'])
        assert plan['smem'] <= scan.SMEM_MAX == 232448, (k, plan)
        assert 1 <= plan['nbuf'] <= len(_chunks(k, plan['T']))


@pytest.mark.parametrize('npix', NPIX)
def test_scan_plan_chunks_cover_the_series(npix):
    for k, plan in _plans(npix):
        chunks = _chunks(k, plan['T'])
        assert 1 <= plan['T'] <= k
        assert chunks[0][0] == 0
        for (t0, n), (t1, _) in zip(chunks, chunks[1:]):
            assert t0 + n == t1 and n == plan['T']
        assert chunks[-1][0] + chunks[-1][1] == k
        assert 1 <= chunks[-1][1] <= plan['T']


@pytest.mark.parametrize('npix', NPIX)
def test_scan_plan_blocks_cover_each_pixel_once(npix):
    for k, plan in _plans(npix):
        P = plan['threads']
        assert P % 32 == 0 and 32 <= P <= 256
        assert plan['blocks'] * P >= npix > (plan['blocks'] - 1) * P
        # the first block and the last (ragged) one; a thread computes
        # pixel p0 + tid, so the copies are what can go wrong
        for pv in {min(P, npix), npix - (plan['blocks'] - 1) * P}:
            for L in {n for _, n in _chunks(k, plan['T'])}:
                got = _copies(P, pv, L)
                assert set(got) == {(q, s) for q in range(pv)
                                    for s in range(L)}, (k, plan, pv, L)
                assert set(got.values()) == {1}


@pytest.mark.parametrize('k', [3, 4, 16, 56, 200, 256])
def test_every_sweep_plan_fits_and_covers(k):
    plans = scan.plan_candidates(k, 131072)
    keys = {(p['threads'], p['T'], p['nbuf']) for p in plans}
    assert len(keys) == len(plans) >= 4
    assert scan._scan_plan(k, 131072) in plans
    for plan in plans:
        assert plan['smem'] <= scan.SMEM_MAX
        for L in {n for _, n in _chunks(k, plan['T'])}:
            assert set(_copies(plan['threads'], plan['threads'],
                               L).values()) == {1}


# ---- the round kernel's plan (ops.change_cuda._round_plan) ------------------

from nd_tpu_torch.ops import change_cuda  # noqa: E402


@pytest.mark.parametrize('npix', NPIX)
def test_round_plan_is_resident_up_to_its_threshold(npix):
    limit = change_cuda.SMEM_MAX - change_cuda.STATIC_SMEM
    for k in range(1, change_cuda.MAX_K + 1):
        plan = change_cuda._round_plan(k, npix)
        assert plan['resident'] == (k <= change_cuda.RESIDENT_K), k
        assert plan['smem'] == change_cuda.round_smem(
            plan['threads'], plan['T'], plan['nbuf']) <= limit
        assert plan['T'] * plan['nbuf'] >= k or not plan['resident']
        assert plan['blocks'] * plan['threads'] >= npix
        assert plan['blocks'] * plan['threads'] - npix < plan['threads']
        assert plan in change_cuda.round_plan_candidates(k, npix)


@pytest.mark.parametrize('k', [1, 2, 12, 28, 29, 48, 56, 100, 256])
def test_every_round_sweep_plan_fits(k):
    plans = change_cuda.round_plan_candidates(k, 1 << 20)
    limit = change_cuda.SMEM_MAX - change_cuda.STATIC_SMEM
    keys = [(p['threads'], p['T'], p['nbuf']) for p in plans]
    assert len(set(keys)) == len(keys)
    for p in plans:
        assert p['smem'] <= limit and 1 <= p['T'] <= k
        assert p['resident'] == (p['T'] * p['nbuf'] >= k)
        assert p['threads'] % 32 == 0
    assert any(p['resident'] for p in plans) or k > 200
    assert any(not p['resident'] for p in plans) == (k > 3)
