"""host_ms_per_tile: the host time from each stage's ``.apply`` call to
its return, summed over the stages, per tile of the measured window
(untraced). Host work and enqueue, not stage time: a call returns
before the card finishes."""


def read(run):
    if not run.tiles:
        return None
    return 1e3 * sum(sum(t.host) for t in run.tiles) / len(run.tiles)
