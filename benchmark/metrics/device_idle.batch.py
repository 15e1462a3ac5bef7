"""device_idle.batch: the share of the window in which no operation ran on
the device, in %, in a cell of batches: 1 - the device's busy time a
batch (the union of device intervals, torch.profiler, over the traced
window's batches) times the batches a second of the untraced window. The
profiler slows the host, so the traced window's own idle share reads high."""


def read(run):
    p = run.profile
    if not run.batches or p is None or not p["calls"]:
        return None
    busy_a_call = p["busy_s"] / p["calls"]
    return 100.0 * (1.0 - busy_a_call * run.batches / run.window_s)
