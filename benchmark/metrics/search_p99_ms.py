"""search_p99_ms: the 99th percentile over every search() call of the window, in ms."""

import numpy as np


def read(run):
    s = run.spans.get("search")
    if not s:
        return None
    return float(np.percentile(np.array(s) * 1e3, 99))
