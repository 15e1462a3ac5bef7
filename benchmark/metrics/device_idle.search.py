"""device_idle.search: the share of the window in which no operation ran on
the device, in %, in a cell of blocking searches: 1 - the device's busy time a
search() call (the union of device intervals, torch.profiler, over the traced
window's searches) times the searches a second of the untraced window. The
profiler slows the host, so the traced window's own idle share reads high."""


def read(run):
    p = run.profile
    if not run.searches or p is None or not p["calls"]:
        return None
    busy_a_call = p["busy_s"] / p["calls"]
    return 100.0 * (1.0 - busy_a_call * run.searches / run.window_s)
