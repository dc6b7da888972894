"""Stage 0's wait for a micro-batch's first image and its fill up to the
batch (``stage0.wait`` + ``stage0.fill`` in the server's span log) in the
window, over the window, in %.  Nothing to read without spans."""
from portbench.spans import ingress_gather_share, window_ns


def read(run):
    spans = getattr(run, "spans", None)
    return ingress_gather_share(spans, *window_ns(run)) if spans else None
