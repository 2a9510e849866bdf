"""setup_s: host seconds from the process's start to the measured
window's start: imports, loading (or building) the kernel library,
drawing the pool on the card, the first calls of every stage (threshold
solves, tables, workspaces) over the warm-up tiles."""


def read(run):
    return run.setup_s
