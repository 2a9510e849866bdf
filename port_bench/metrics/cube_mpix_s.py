"""cube_mpix_s: the y*x*time pixels of every tile completed in the
window over the window's seconds (host clock, from the window's start
to the end of its last tile's synchronize)."""


def read(run):
    if not run.tiles:
        return None
    return len(run.tiles) * run.cell.tile_pixels / 1e6 / run.window_s
