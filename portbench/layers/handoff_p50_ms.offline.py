"""Median over the window's micro-batches and stage boundaries of the
host's delay in handing a micro-batch on: the next stage's launch start,
less the later of this stage's sync end and the next stage's handoff end
for the micro-batch before (the server's span log).  Nothing to read
without spans."""
from portbench.readers import percentile
from portbench.spans import handoff_delays_ns, window_ns


def read(run):
    spans = getattr(run, "spans", None)
    p50 = percentile(handoff_delays_ns(spans, *window_ns(run)), 50) if spans else None
    return None if p50 is None else p50 * 1e-6
