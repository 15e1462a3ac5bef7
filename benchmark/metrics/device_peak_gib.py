"""device_peak_gib: torch.cuda.max_memory_allocated() from the start of the
system's build to the end of the window, in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
