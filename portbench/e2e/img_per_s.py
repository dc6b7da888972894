"""Images completed in the window, over the window (host clock)."""
from portbench.readers import completed_in_window


def read(run):
    return completed_in_window(run) / run.window.seconds
