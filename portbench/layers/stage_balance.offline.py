"""Mean over stages of busy seconds in the window, over the busiest
stage's (the server's StageMetrics: host clock around each synchronised
stage call).  1 is a balanced pipeline."""
from portbench.readers import stage_busy


def read(run):
    busy = stage_busy(run)
    if not busy or max(busy) <= 0:
        return None
    return sum(busy) / len(busy) / max(busy)
