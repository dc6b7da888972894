"""Serving-side observability: per-stage and end-to-end statistics.

The paper evaluates Pipe-it by *sustained throughput* (Eq. 12: the
steady-state rate is set by the bottleneck stage's service time
``max_i T_{L_i}^{P_i}``).  To see that equation live in the runtime, every
pipeline stage records its per-micro-batch service time and busy fraction;
the server aggregates them into the same quantities the paper reasons
about:

* stage service-time percentiles (p50/p95/p99) — the empirical
  ``T_{L_i}^{P_i}`` distribution (Eq. 10 summed over the stage's layers);
* stage occupancy — busy_time / wall_time; the bottleneck stage of a
  well-planned pipeline runs near 1.0 while the others wait (Fig. 2,
  layer-level timeline);
* end-to-end request latency and completed-images/second throughput.

A span log (:class:`SpanLog`, off by default) records, while it is on,
what each stage thread does with each micro-batch: its wait, stage 0's
fill and stack, the launch, the sync, the handoff.  It holds no device
time: a stage's device time is the profiler's busy time on the stage's
stream, which the spans' thread ids tie to the stage.

All times are seconds, except the span log's nanoseconds.  Counters are
monotone over the server's whole lifetime; latency *samples* live in
bounded sliding windows (a persistent server must not grow memory with
uptime), so the percentiles describe recent behaviour — which is what an
operator watches anyway.
``snapshot()`` is safe to call while the server is running (workers only
append).
"""
from __future__ import annotations

import array
import collections
import dataclasses
import threading
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Sequence, Tuple

from ..core.queueing import empirical_percentile

# Sliding-window sizes for latency samples (per stage / end-to-end).
STAGE_WINDOW = 2048
E2E_WINDOW = 8192
# Retired-epoch snapshots kept after plan hot-swaps (bounded for the same
# reason as the latency windows: uptime must not grow memory).
EPOCH_HISTORY = 64


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input.

    The textbook nearest-rank method: the P-th percentile of N ordered
    samples is the value at (1-based) rank ``ceil(P/100 * N)``.  An
    earlier version used Python's ``round()`` (banker's rounding) over a
    0-based interpolation index, which e.g. picked the LOWER of the two
    middle ranks for p50 of an even window — inconsistent with the
    documented method and with itself across window sizes (round-half-to-
    even flips direction with the parity of the half-rank).  Pinned by
    regression fixtures in tests/test_serving.py.

    Delegates to the single shared implementation
    (``core.queueing.empirical_percentile``) so serving metrics, the
    simulator, and the queueing model can never disagree on the same
    samples — this repo used to carry two copies of the rule.
    """
    return empirical_percentile(samples, q)


@dataclasses.dataclass
class StageMetrics:
    """Counters owned by one stage worker.

    Single-writer; the small lock only keeps the (busy_s, items) pair
    consistent for readers like the adaptive monitor — a torn pair would
    shift one micro-batch's busy time into the next observation window
    and fake a service-time spike.
    """

    name: str
    batches: int = 0
    items: int = 0
    padded_items: int = 0  # batch slots filled with padding, not images
    busy_s: float = 0.0
    service_s: Deque[float] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=STAGE_WINDOW)
    )
    started_at: Optional[float] = None
    stopped_at: Optional[float] = None
    _pair_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def record(self, service_time: float, n_items: int, n_padded: int = 0) -> None:
        with self._pair_lock:
            self.batches += 1
            self.items += n_items
            self.padded_items += n_padded
            self.busy_s += service_time
        self.service_s.append(service_time)

    def totals(self) -> Tuple[float, int]:
        """A mutually-consistent (busy_s, items) snapshot."""
        with self._pair_lock:
            return self.busy_s, self.items

    def occupancy(self) -> float:
        """Busy fraction over the worker's active wall time."""
        if self.started_at is None:
            return 0.0
        end = self.stopped_at if self.stopped_at is not None else time.perf_counter()
        wall = max(end - self.started_at, 1e-12)
        return min(self.busy_s / wall, 1.0)

    def snapshot(self) -> Dict[str, Any]:
        lat = list(self.service_s)
        return {
            "stage": self.name,
            "batches": self.batches,
            "items": self.items,
            "padded_items": self.padded_items,
            "occupancy": self.occupancy(),
            "service_p50_s": percentile(lat, 50),
            "service_p95_s": percentile(lat, 95),
            "service_p99_s": percentile(lat, 99),
        }


class Span(NamedTuple):
    """One phase of one micro-batch in one stage, in ``perf_counter_ns``.

    ``name`` is ``stage{i}.<phase>``, or ``stage{i}`` for the loop
    iteration that holds the phases (its self time is the loop's own
    bookkeeping).  ``ident`` is the writing thread's
    ``threading.get_ident()``: the pthread id, whose low 32 bits name the
    thread of a CUDA runtime call in the profiler's trace.
    """

    name: str
    micro_batch: int
    stage: int
    ident: int
    start_ns: int
    end_ns: int
    redispatched: bool = False


PHASES = ("", "wait", "fill", "stack", "launch", "sync", "handoff")
_PHASE_CODE = {p: i for i, p in enumerate(PHASES)}


class _SpanBuffer:
    """One writing thread's records, filled in order by that thread only,
    in flat arrays: a record allocates no object the collector tracks."""

    __slots__ = ("ident", "phase", "mb", "stage", "start", "end", "redo", "n", "dropped")

    def __init__(self, capacity: int):
        self.ident = threading.get_ident()
        self.phase = array.array("b", bytes(capacity))
        self.redo = array.array("b", bytes(capacity))
        self.stage = array.array("i", bytes(4 * capacity))
        self.mb, self.start, self.end = (array.array("q", bytes(8 * capacity)) for _ in range(3))
        self.n = 0
        self.dropped = 0


class SpanLog:
    """The stage threads' spans, kept in memory while tracing is on.

    Each writing thread gets one buffer of ``capacity`` records, made at
    its first record; a write takes no lock.  A full buffer counts drops
    and does not grow.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"span capacity {capacity} < 1")
        self.capacity = capacity
        self._local = threading.local()
        self._buffers: List[_SpanBuffer] = []
        self._lock = threading.Lock()

    def add(self, phase: str, micro_batch: int, stage: int, start_ns: int, end_ns: int,
            redispatched: bool = False) -> None:
        """Record ``stage{stage}.{phase}`` (``phase`` "" for the iteration)."""
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = _SpanBuffer(self.capacity)
            self._local.buf = buf
            with self._lock:
                self._buffers.append(buf)
        i = buf.n
        if i < self.capacity:
            buf.phase[i] = _PHASE_CODE[phase]
            buf.mb[i] = micro_batch
            buf.stage[i] = stage
            buf.start[i] = start_ns
            buf.end[i] = end_ns
            buf.redo[i] = redispatched
            buf.n = i + 1
        else:
            buf.dropped += 1

    @property
    def dropped(self) -> int:
        with self._lock:
            return sum(b.dropped for b in self._buffers)

    def records(self) -> List[Span]:
        """Every record so far, in start order."""
        with self._lock:
            buffers = list(self._buffers)
        out = []
        for b in buffers:
            for i in range(b.n):
                phase, stage = PHASES[b.phase[i]], b.stage[i]
                name = f"stage{stage}.{phase}" if phase else f"stage{stage}"
                out.append(Span(name, b.mb[i], stage, b.ident, b.start[i], b.end[i], bool(b.redo[i])))
        out.sort(key=lambda s: s.start_ns)
        return out


class RecoveryMetrics:
    """Fault-tolerance accounting for one server (all epochs).

    Populated only when the server runs with a
    :class:`~repro_torch.serving.faults.RecoveryPolicy`; all counters stay zero
    under the fail-fast default.  Counters are lifetime-monotone (they
    survive ``new_epoch`` — availability is a property of the server, not
    of one plan).  MTTR is measured per recovery episode: from the moment
    a fault is detected (worker death, watchdog stall verdict) to the
    re-dispatched work's safe hand-off downstream.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.transient_retries = 0  # in-place retries of TransientStageError
        self.redispatched = 0  # tickets re-executed on a restarted stage
        self.worker_restarts = 0  # stage workers respawned (crash or stall)
        self.stalls_detected = 0  # watchdog verdicts
        self.duplicates_suppressed = 0  # late zombie rows deduped at egress
        self.faults = 0  # recovery episodes entered
        self.faults_by_kind: Dict[str, int] = {}
        self.last_stall_age_s: Optional[float] = None  # detection latency
        self.heartbeat_age_s: Dict[int, float] = {}  # stage -> current age
        self._mttr_total = 0.0
        self._recoveries = 0

    # ------------------------------------------------------------- writers
    def note_retry(self, stage: int) -> None:
        with self._lock:
            self.transient_retries += 1

    def note_fault(self, stage: int, kind: str) -> None:
        with self._lock:
            self.faults += 1
            self.faults_by_kind[kind] = self.faults_by_kind.get(kind, 0) + 1

    def note_restart(self, stage: int) -> None:
        with self._lock:
            self.worker_restarts += 1

    def note_stall(self, stage: int, age_s: float) -> None:
        with self._lock:
            self.stalls_detected += 1
            self.last_stall_age_s = age_s

    def note_redispatch(self, n_tickets: int) -> None:
        with self._lock:
            self.redispatched += int(n_tickets)

    def note_duplicate(self, n: int = 1) -> None:
        with self._lock:
            self.duplicates_suppressed += int(n)

    def note_recovered(self, mttr_s: float) -> None:
        with self._lock:
            self._mttr_total += mttr_s
            self._recoveries += 1

    def set_heartbeat_ages(self, ages: Dict[int, float]) -> None:
        with self._lock:
            self.heartbeat_age_s = dict(ages)

    # ------------------------------------------------------------- readers
    @property
    def recoveries(self) -> int:
        with self._lock:
            return self._recoveries

    @property
    def mttr_s(self) -> float:
        """Mean time to recover over completed episodes (0.0 when none)."""
        with self._lock:
            return self._mttr_total / self._recoveries if self._recoveries else 0.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "faults": self.faults,
                "faults_by_kind": dict(self.faults_by_kind),
                "transient_retries": self.transient_retries,
                "worker_restarts": self.worker_restarts,
                "redispatched": self.redispatched,
                "stalls_detected": self.stalls_detected,
                "duplicates_suppressed": self.duplicates_suppressed,
                "recoveries": self._recoveries,
                "mttr_s": (
                    self._mttr_total / self._recoveries if self._recoveries else 0.0
                ),
                "last_stall_age_s": self.last_stall_age_s,
                "heartbeat_age_s": dict(self.heartbeat_age_s),
            }


class ServerMetrics:
    """Aggregates stage metrics plus end-to-end request accounting.

    The end-to-end latency of image z includes queueing: the window is
    stamped at ``submit()`` (the ``Ticket``'s enqueue timestamp), so the
    reported percentiles cover ingress-queue wait + pipeline time — under
    an open-loop arrival process the queue wait IS the tail (ROADMAP item
    4), so a service-time-only e2e would under-report p99.  In steady
    state closed-loop it approaches ``p * max_i T_{L_i}`` (fill latency,
    Eq. 11's pipeline-fill term) while throughput approaches
    ``1 / max_i T_{L_i}`` (Eq. 12).  ``note_dequeue`` additionally breaks
    out the queue-wait component (submit → the stage-0 worker forming the
    micro-batch) so an operator can tell a saturated ingress from a slow
    pipeline at a glance.
    """

    def __init__(self, stage_names: List[str]):
        self.stages = [StageMetrics(name=n) for n in stage_names]
        # Fault-recovery counters persist across epochs (like the e2e
        # stream counters): a restart during epoch 3 is still part of the
        # server's availability story in epoch 4.
        self.recovery = RecoveryMetrics()
        self.epoch = 0
        self.stage_history: Deque[List[Dict[str, Any]]] = collections.deque(
            maxlen=EPOCH_HISTORY
        )
        self._lock = threading.Lock()
        self._e2e_s: Deque[float] = collections.deque(maxlen=E2E_WINDOW)
        self._queue_wait_s: Deque[float] = collections.deque(maxlen=E2E_WINDOW)
        self._completed = 0
        self._first_submit: Optional[float] = None
        self._last_complete: Optional[float] = None
        # The stage threads test this once a phase; while it is None they
        # read no clock and record nothing.
        self.spans: Optional[SpanLog] = None

    def start_spans(self, capacity: int) -> SpanLog:
        """Turn the span log on (a fresh one), ``capacity`` records a
        writing thread."""
        self.spans = SpanLog(capacity)
        return self.spans

    def stop_spans(self) -> Optional[SpanLog]:
        """Turn the span log off; returns it (``records()``, ``dropped``),
        or ``None`` where none was on."""
        log, self.spans = self.spans, None
        return log

    def new_epoch(self, stage_names: List[str]) -> None:
        """Roll per-stage metrics for a plan hot-swap (server epoch bump).

        The retiring epoch's final stage snapshots are archived in
        ``stage_history``; end-to-end counters (completed, latency,
        throughput window) deliberately persist — the request stream is
        continuous across the swap, only the stage structure changes.
        """
        with self._lock:
            self.stage_history.append([s.snapshot() for s in self.stages])
            self.stages = [StageMetrics(name=n) for n in stage_names]
            self.epoch += 1

    # ------------------------------------------------------------- writers
    def note_submit(self, now: float) -> None:
        with self._lock:
            if self._first_submit is None:
                self._first_submit = now

    def note_dequeue(self, submitted_at: float, now: float) -> None:
        """Record one image's ingress-queue wait (submit → batch formed)."""
        with self._lock:
            self._queue_wait_s.append(now - submitted_at)

    def note_complete(self, submitted_at: float, now: float) -> None:
        with self._lock:
            self._e2e_s.append(now - submitted_at)
            self._completed += 1
            self._last_complete = now

    # ------------------------------------------------------------- readers
    @property
    def completed(self) -> int:
        return self._completed

    def throughput(self) -> float:
        """Completed images / second over the active window."""
        with self._lock:
            if self._first_submit is None or self._last_complete is None:
                return 0.0
            window = max(self._last_complete - self._first_submit, 1e-12)
            return self._completed / window

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            e2e = list(self._e2e_s)
            qwait = list(self._queue_wait_s)
            completed = self._completed
        return {
            "completed": completed,
            "epoch": self.epoch,
            "throughput_img_s": self.throughput(),
            "e2e_p50_s": percentile(e2e, 50),
            "e2e_p95_s": percentile(e2e, 95),
            "e2e_p99_s": percentile(e2e, 99),
            "queue_wait_p50_s": percentile(qwait, 50),
            "queue_wait_p95_s": percentile(qwait, 95),
            "queue_wait_p99_s": percentile(qwait, 99),
            "stages": [s.snapshot() for s in self.stages],
            "recovery": self.recovery.snapshot(),
        }


class RouterMetrics:
    """Per-model admission accounting for the multi-model front-end.

    The router decides — per model — whether a request is *admitted* into
    that model's pipeline or *rejected* (admission control: the model's
    in-flight bound is hit, or its pipeline pushed back).  Completion and
    latency live in each model's own :class:`ServerMetrics`; this class
    owns only what the router itself decides, so a rejected request never
    pollutes a pipeline's service-time statistics.
    """

    def __init__(self, names: Sequence[str]):
        self._lock = threading.Lock()
        self._admitted: Dict[str, int] = {n: 0 for n in names}
        self._rejected: Dict[str, int] = {n: 0 for n in names}

    def note_admit(self, name: str) -> None:
        with self._lock:
            self._admitted[name] += 1

    def note_reject(self, name: str) -> None:
        with self._lock:
            self._rejected[name] += 1

    def admitted(self, name: str) -> int:
        with self._lock:
            return self._admitted[name]

    def rejected(self, name: str) -> int:
        with self._lock:
            return self._rejected[name]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                name: {
                    "admitted": self._admitted[name],
                    "rejected": self._rejected[name],
                }
                for name in self._admitted
            }
