"""setup_s: seconds from process start to the window's first query."""


def read(run):
    return run.setup_s
