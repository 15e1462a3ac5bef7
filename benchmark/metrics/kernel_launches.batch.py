"""kernel_launches.batch: launches of the port's four kernels (K1-K4,
utils.kernels.launches) in the window, per batch."""


def read(run):
    if not run.batches:
        return None
    return sum(run.launches.values()) / run.batches
