"""batch_p95_ms: the 95th percentile over every batch of the window, from its
launch_batch call to the return of its finish_batch, in ms."""

import numpy as np


def read(run):
    b = run.spans.get("batch")
    if not b:
        return None
    return float(np.percentile(np.array(b) * 1e3, 95))
