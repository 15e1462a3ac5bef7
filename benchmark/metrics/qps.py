"""qps: queries whose results came back in the window, over the window's seconds."""


def read(run):
    if not run.completed:
        return None
    return run.completed / run.window_s
