"""kernels_per_tile: device kernel events in the traced window per
tile."""


def read(run):
    tr = run.trace
    if not tr or not tr['tiles']:
        return None
    return tr['kernels'] / tr['tiles']
