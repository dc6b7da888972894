"""95th percentile (nearest rank) of every request due in the window, from
its due time to its answer; a shed, failed or unresolved request is a
miss, placed above every latency as the window plus the drain allowance."""
from portbench.readers import percentile
from portbench.traffic import DRAIN_S


def read(run):
    cap = run.window.seconds + DRAIN_S
    p95 = percentile([min(r.latency_s(), cap) for r in run.window.window_requests()], 95)
    return None if p95 is None else 1e3 * p95
