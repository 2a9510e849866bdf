"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` from the start of
set-up to the end of the measured window, in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
