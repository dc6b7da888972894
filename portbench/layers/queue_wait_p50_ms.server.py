"""Median ingress wait of the window's requests: the stage-0 worker's
dequeue stamp minus the submit stamp, from their tickets."""
from portbench.readers import percentile


def read(run):
    waits = [r.queued_s for r in run.window.window_requests() if r.queued_s is not None]
    p50 = percentile(waits, 50)
    return None if p50 is None else 1e3 * p50
