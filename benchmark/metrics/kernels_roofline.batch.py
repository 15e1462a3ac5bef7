"""kernels_roofline.batch: the least bytes of the window's batches
(benchmark/bytecount.py) at the H100's 3.35 TB/s, as a share of the
device time of every kernel in the traced window, in %."""

from benchmark.bytecount import H100_BYTES_PER_S


def read(run):
    p = run.profile
    if not run.batches or p is None or not p["kernel_s"]:
        return None
    return 100.0 * run.least_bytes / H100_BYTES_PER_S / p["kernel_s"]
