"""copy_ms_per_tile: the card's time inside the program's ``data.*``
spans (the data model's stacks, transposes and contiguous copies),
summed over the traced window, per traced tile. The program records a
span's device time (CUDA events at its entry and exit, on the current
stream) only while a profiler traces, and ``nd_tpu_torch.tracing``'s
``report()`` sums it as ``device``. None where no such span has any."""


def read(run):
    tiles = (run.trace or {}).get('tiles')
    if not tiles:
        return None
    from nd_tpu_torch import tracing
    seconds = [v['device'] for name, v in tracing.report().items()
               if name.startswith('data.') and 'device' in v]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / tiles
