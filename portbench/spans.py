"""The program's span log beside the device trace.

The server's span log (``repro_torch.serving.metrics.SpanLog``) stamps
each stage thread's phases of each micro-batch with
``time.perf_counter_ns``; the profiler stamps the device's operations and
the runtime calls that launched them on its own clock (Unix
nanoseconds).  This module maps the spans onto the profiler's clock,
checks the mapping against the profiler's own host events (every
``cudaGraphLaunch`` should fall inside a ``stage{i}.launch`` span of the
thread that made the call), and puts each idle gap of the device down to
the span its launching thread had open when the gap began.  The spans'
thread ids also tie each stage to the stream its thread launched on, so
a stage's device time is the profiler's busy time on that stream.  It
also holds the arithmetic of the span metrics (``layers/``).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .trace import DeviceOp, union

SPAN_CAPACITY = 8192  # records a stage thread: a 6 s window holds about 1,300
GRAPH_LAUNCH = "cudaGraphLaunch"
GC = "gc"
BETWEEN = "between_spans"
UNTRACED = "no_traced_host_call"
THREAD_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class RuntimeCall:
    """A CUDA runtime call on the profiler's clock, with its thread."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # the low 32 bits of the calling thread's pthread id
    corr: int


def thread_of(span) -> int:
    """A span's thread as the profiler names a runtime call's."""
    return span.ident & THREAD_MASK


def runtime_calls(prof) -> List[RuntimeCall]:
    """The runtime calls of a stopped ``torch.profiler.profile`` that
    traced the CUDA activity.  Kineto gives a runtime call's thread as its
    resource id: the calling thread's pthread id cut to a signed 32-bit
    integer."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()) and e.name().startswith("cuda"):
            out.append(RuntimeCall(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                                   e.device_resource_id() & THREAD_MASK, e.correlation_id()))
    return out


def clock_offset(reads: int = 5) -> int:
    """What to add to a ``perf_counter_ns`` stamp to place it on the
    profiler's clock: ``time_ns() - perf_counter_ns()``, from the read
    whose two ``perf_counter_ns`` stamps lie closest together."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def shifted(spans: Iterable, offset_ns: int) -> list:
    """The spans moved by ``offset_ns``."""
    return [s._replace(start_ns=s.start_ns + offset_ns, end_ns=s.end_ns + offset_ns) for s in spans]


def _phase(name: str) -> str:
    return name.split(".", 1)[1] if "." in name else ""


class _Open:
    """Per thread, its spans sorted by start (phases apart from the stage
    iterations that hold them): which one was open at a time."""

    def __init__(self, spans: Iterable):
        by: Dict[Tuple[int, bool], list] = collections.defaultdict(list)
        for s in spans:
            by[(thread_of(s), _phase(s.name) == "")].append(s)
        self._spans = {k: sorted(v, key=lambda s: s.start_ns) for k, v in by.items()}
        self._starts = {k: [s.start_ns for s in v] for k, v in self._spans.items()}

    def at(self, thread: int, t: int):
        """The innermost span of ``thread`` open at ``t``, or ``None``."""
        for parent in (False, True):
            starts = self._starts.get((thread, parent))
            if not starts:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0:
                s = self._spans[(thread, parent)][i]
                if s.start_ns <= t < s.end_ns:
                    return s
        return None


def clock_check(spans: Sequence, calls: Sequence[RuntimeCall], t0_ns: int, t1_ns: int) -> dict:
    """How the mapped spans meet the profiler's graph launches in the
    window: the share of ``cudaGraphLaunch`` calls that fall inside a
    ``stage{i}.launch`` span of their thread, and the median residual:
    the distance from a call's start to its thread's nearest launch span
    (0 inside; negative before it), in microseconds."""
    launches = collections.defaultdict(list)
    for s in spans:
        if _phase(s.name) == "launch":
            launches[thread_of(s)].append((s.start_ns, s.end_ns))
    for v in launches.values():
        v.sort()
    residuals, leads = [], []
    graph_calls = [c for c in calls if c.name.startswith(GRAPH_LAUNCH) and t0_ns <= c.start_ns <= t1_ns]
    for c in graph_calls:
        mine = launches.get(c.thread, [])
        i = bisect.bisect_right(mine, (c.start_ns, float("inf"))) - 1
        if i >= 0 and mine[i][0] <= c.start_ns and c.end_ns <= mine[i][1]:
            residuals.append(0.0)
            leads.append((c.start_ns - mine[i][0]) * 1e-3)
            continue
        near = [mine[j] for j in (i, i + 1) if 0 <= j < len(mine)]
        if not near:
            continue
        d = min((c.start_ns - a if c.start_ns < a else c.end_ns - b for a, b in near), key=abs)
        residuals.append(d * 1e-3)
    n = len(graph_calls)
    return {
        "graph_launches": n,
        "inside_share": (len(leads) / n) if n else None,
        "median_residual_us": statistics.median(residuals) if residuals else None,
        "median_lead_us": statistics.median(leads) if leads else None,
    }


def idle_by_span(ops: Sequence[DeviceOp], calls: Sequence[RuntimeCall], spans: Sequence,
                 pauses: Sequence[Tuple[int, int]], t0_ns: int, t1_ns: int) -> Dict[str, float]:
    """Seconds of device idle in ``[t0_ns, t1_ns]``.  What of a gap lies in
    a collection (``pauses``, on the profiler's clock) is ``gc``, whenever
    the gap began; the rest of it goes to the span that the thread whose
    call ended the gap had open where the gap began,
    ``no_traced_host_call`` where no traced call launched the op that
    ended it, ``between_spans`` where that thread had no span open.
    Spans are on the profiler's clock."""
    busy = union((max(o.start_ns, t0_ns), min(o.end_ns, t1_ns)) for o in ops
                 if min(o.end_ns, t1_ns) > max(o.start_ns, t0_ns))
    starts = sorted((o.start_ns, o.corr) for o in ops)
    by_corr = {c.corr: c for c in calls}
    open_at = _Open(spans)
    pauses = sorted(pauses)
    pause_starts = [a for a, _ in pauses]
    out: Dict[str, float] = collections.defaultdict(float)
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    j = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        while j < len(starts) and starts[j][0] < g1:
            j += 1
        first = max(0, bisect.bisect_right(pause_starts, g0) - 1)
        held = sum(max(0, min(b, g1) - max(a, g0))
                   for a, b in pauses[first:bisect.bisect_left(pause_starts, g1)])
        if held:
            out[GC] += held * 1e-9
        if held == g1 - g0:
            continue
        call = by_corr.get(starts[j][1]) if j < len(starts) else None
        if call is None:
            name = UNTRACED
        else:
            s = open_at.at(call.thread, g0)
            name = s.name if s is not None else BETWEEN
        out[name] += (g1 - g0 - held) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def stage_streams(spans: Sequence, calls: Sequence[RuntimeCall], ops: Sequence[DeviceOp]) -> Dict[int, int]:
    """Each stage's stream: the stream most of the ops launched by the
    stage's threads ran on."""
    stage_of = {thread_of(s): s.stage for s in spans if s.name == f"stage{s.stage}"}
    thread = {c.corr: c.thread for c in calls}
    votes: Dict[int, collections.Counter] = collections.defaultdict(collections.Counter)
    for o in ops:
        stage = stage_of.get(thread.get(o.corr))
        if stage is not None:
            votes[stage][o.stream] += 1
    return {stage: c.most_common(1)[0][0] for stage, c in sorted(votes.items())}


def stage_device_seconds(spans: Sequence, calls: Sequence[RuntimeCall], ops: Sequence[DeviceOp],
                         t0_ns: int, t1_ns: int) -> Dict[int, Optional[float]]:
    """Each stage's device seconds in the window: the profiler's busy
    time on the stage's stream (``stage_streams``); ``None`` for a stage
    of the spans whose stream the trace does not show."""
    streams = stage_streams(spans, calls, ops)
    out: Dict[int, Optional[float]] = {}
    for stage in sorted({s.stage for s in spans}):
        if stage not in streams:
            out[stage] = None
            continue
        busy = union((max(o.start_ns, t0_ns), min(o.end_ns, t1_ns)) for o in ops
                     if o.stream == streams[stage] and min(o.end_ns, t1_ns) > max(o.start_ns, t0_ns))
        out[stage] = sum(b - a for a, b in busy) * 1e-9
    return out


# ------------------------------------------------------------------ metrics
def window_ns(run) -> Tuple[int, int]:
    return int(run.window.t0 * 1e9), int(run.window.t1 * 1e9)


def _by_stage_and_batch(spans: Sequence) -> Dict[Tuple[int, int], Dict[str, object]]:
    out: Dict[Tuple[int, int], Dict[str, object]] = collections.defaultdict(dict)
    for s in spans:
        out[(s.stage, s.micro_batch)][_phase(s.name)] = s
    return out


def stage_device_balance(device_s: Optional[Dict[int, Optional[float]]]) -> Optional[float]:
    """Mean over stages of their device seconds (``stage_device_seconds``)
    over the largest; ``None`` where a stage's is unknown or none is busy."""
    if not device_s or None in device_s.values() or max(device_s.values()) <= 0:
        return None
    return sum(device_s.values()) / len(device_s) / max(device_s.values())


def handoff_delays_ns(spans: Sequence, t0_ns: int, t1_ns: int) -> List[int]:
    """For each stage boundary i -> i + 1 and each micro-batch k whose
    launch in stage i + 1 began in the window: that start, less the later
    of stage i's sync end for k and stage i + 1's handoff end for the
    micro-batch it ran before k (the host's delay once both were ready)."""
    idx = _by_stage_and_batch(spans)
    stages = sorted({s.stage for s in spans})
    out = []
    for nxt in stages[1:]:
        order = sorted((p["launch"].start_ns, mb) for (st, mb), p in idx.items()
                       if st == nxt and "launch" in p)
        prev_free = None
        for start, mb in order:
            sync = idx.get((nxt - 1, mb), {}).get("sync")
            if sync is not None and t0_ns <= start <= t1_ns:
                ready = sync.end_ns if prev_free is None else max(sync.end_ns, prev_free)
                out.append(start - ready)
            handoff = idx[(nxt, mb)].get("handoff")
            prev_free = handoff.end_ns if handoff is not None else None
    return out


def ingress_gather_share(spans: Sequence, t0_ns: int, t1_ns: int) -> Optional[float]:
    """Stage 0's ``wait`` and ``fill`` seconds in the window over the
    window, in %."""
    if not spans or t1_ns <= t0_ns:
        return None
    held = sum(max(0, min(s.end_ns, t1_ns) - max(s.start_ns, t0_ns)) for s in spans
               if s.name in ("stage0.wait", "stage0.fill"))
    return 100.0 * held / (t1_ns - t0_ns)
