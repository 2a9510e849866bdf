"""device_idle_pct: the share of the traced window (the first tile
range's start to the last one's end) in which no kernel, copy or memset
ran on the card. The traced window synchronizes at each stage's end."""


def read(run):
    tr = run.trace
    if not tr or tr['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])
