"""What the metric readers share (``portbench/e2e/<name>.py`` and
``portbench/layers/<name>.py``): each reader is ``read(run)`` on a
finished :class:`portbench.bench.Run` and returns a number, or ``None``
where it finds nothing to read."""
from __future__ import annotations

import math
from typing import Optional, Sequence

from . import yardstick as Y


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest rank: the value at rank ``ceil(q / 100 * n)`` of the sorted
    values; ``None`` for no values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def completed_in_window(run) -> int:
    """Requests whose answer resolved inside the window."""
    w = run.window
    return sum(
        1 for r in w.requests
        if r.output is not None and r.done_at is not None and w.t0 <= r.done_at <= w.t1
    )


def stage_busy(run) -> Optional[list]:
    """Each stage's busy seconds in the window (the server's counters)."""
    w = run.window
    if w.stages0 is None or w.stages1 is None:
        return None
    return [b1[0] - b0[0] for b0, b1 in zip(w.stages0, w.stages1)]


def idle_share(run) -> Optional[float]:
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def kernel_roofline(run, peak: float = Y.PEAK_FLOPS) -> Optional[float]:
    """Summed roofline bound of the conv and fc work of the images
    completed in the traced window, over the kernels' busy time in it."""
    if run.trace is None or run.trace["kernel_busy_s"] <= 0:
        return None
    n = completed_in_window(run)
    if n == 0:
        return None
    _, bound = Y.totals(run.layers, run.batch, peak)
    return 100.0 * n * bound / run.batch / run.trace["kernel_busy_s"]


def mfu(run, peak: float = Y.PEAK_FLOPS) -> Optional[float]:
    """Model FLOPs of the images completed in the traced window, over the
    window at ``peak``."""
    if run.trace is None:
        return None
    n = completed_in_window(run)
    if n == 0:
        return None
    per_image = sum(Y.flops(l) for l in run.layers)
    return 100.0 * n * per_image / (run.trace["window_s"] * peak)
