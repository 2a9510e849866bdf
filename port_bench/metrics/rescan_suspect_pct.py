"""rescan_suspect_pct: the share of the omnibus test's pixels that the
float64 rescan scanned again, over the traced window: the program's
counters ``omnibus.rescanned`` over ``omnibus.pixels``
(``nd_tpu_torch.tracing.counters()``, kept only while a profiler
traces). None where the program keeps no such counters."""


def read(run):
    if not (run.trace or {}).get('tiles'):
        return None
    from nd_tpu_torch import tracing
    counters = getattr(tracing, 'counters', None)
    if counters is None:
        return None
    got = counters()
    pixels = got.get('omnibus.pixels')
    if not pixels or 'omnibus.rescanned' not in got:
        return None
    return 100.0 * got['omnibus.rescanned'] / pixels
