"""unpack_ms_per_tile: the card's time inside the program's
``omnibus.unpack`` span (the change map's bits unpacked into bools),
summed over the traced window, per traced tile: the span's ``device``
seconds in ``nd_tpu_torch.tracing``'s ``report()``, recorded only while
a profiler traces. None where the span has none."""


def read(run):
    tiles = (run.trace or {}).get('tiles')
    if not tiles:
        return None
    from nd_tpu_torch import tracing
    seconds = tracing.report().get('omnibus.unpack', {}).get('device')
    if seconds is None:
        return None
    return 1e3 * seconds / tiles
