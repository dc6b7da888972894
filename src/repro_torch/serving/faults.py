"""Deterministic fault injection for the serving stack.

Pipe-it's pipeline spreads one inference across every core of the board,
so a single stalled or lost stage takes the whole pipeline's throughput
to zero.  This module is the *fault model* half of the fault-tolerance
layer: a seeded, JSON-round-trippable schedule of failures
(:class:`FaultPlan`) and a thread-safe runtime that fires them
(:class:`FaultInjector`) — bit-for-bit reproducibly — into

* **live servers**, by wrapping a ``stage_fn_builder`` so each stage fn
  consults the injector at entry (:func:`fault_injecting_builder`), and
* **the discrete-event simulator**, via ``simulate(faults=...)``, which
  replays the *same* per-stage invocation ordinals and converts each
  event into the deterministic delay the recovery policy implies.

Fault classes
-------------
``transient``
    The stage fn raises :class:`TransientStageError` for ``count``
    consecutive invocations starting at ``at_call``.  Models flaky
    kernels / ECC hiccups; the server retries in place with exponential
    backoff (:class:`RecoveryPolicy`), escalating to a worker restart
    when retries are exhausted.
``crash``
    The stage fn raises :class:`WorkerCrash` at invocation ``at_call``
    — the worker thread dies mid-item.  The server restarts the stage
    and **re-dispatches** the in-flight micro-batch (at-least-once).
``stall``
    The stage fn silently sleeps ``stall_s`` at invocation ``at_call``
    before computing.  No exception is ever raised: only the heartbeat
    watchdog can convert this into a detected failure.
``cluster_loss`` / ``rejoin``
    Permanent core loss (``lost`` maps core-type name -> cores lost) and
    its reversal.  These are *platform* events: they do not fire inside
    a stage fn — harnesses drain them via :meth:`FaultPlan.platform_events`
    and call ``AdaptiveMonitor.degrade`` / ``.rejoin`` (or the
    ``PartitionController`` equivalents), which re-plan on the surviving
    ``HeteroPlatform.subset`` and epoch-hot-swap.

Determinism contract
--------------------
Events trigger on **per-stage invocation ordinals** (`at_call`), not
wall-clock time, so the same :class:`FaultPlan` produces the same fault
sequence in the simulator, on a fake-stage board, and on real silicon.
The live injector and the simulator consume ordinals identically: a
retried / re-dispatched invocation advances the same counter in both
worlds (see :meth:`FaultInjector.sim_delay`, which emulates the server's
retry loop event for event).  A warm-up call (:func:`warm_calls`: the
server's ``warmup()`` and the prepare phase of ``swap_plan``) serves no
micro-batch and consumes no ordinal, so a swap warming the next epoch
while the old one serves cannot take a scheduled fault from a worker.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "FaultEvent",
    "FaultInjected",
    "FaultPlan",
    "FaultInjector",
    "RecoveryPolicy",
    "TransientStageError",
    "WorkerCrash",
    "fault_injecting_builder",
    "warm_calls",
]

STAGE_KINDS = ("transient", "crash", "stall")
PLATFORM_KINDS = ("cluster_loss", "rejoin")
BOARD_KINDS = ("board_loss", "board_rejoin")


class FaultInjected(RuntimeError):
    """Base class for every injected failure (marks them as scripted)."""


class TransientStageError(FaultInjected):
    """A retryable stage failure (flaky kernel, transient I/O error)."""


class WorkerCrash(FaultInjected):
    """A fatal in-worker failure: the stage thread dies mid-item."""


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How a server responds to faults.  ``None`` disables recovery
    entirely (the pre-fault-tolerance fail-fast semantics).

    ``heartbeat_deadline_s`` is the stall-detection contract: a stage
    busy on one micro-batch for longer than this is declared stalled and
    restarted.  It must exceed the worst-case *healthy* stage time
    (service + retry backoffs) or the watchdog will shoot healthy
    workers; DESIGN.md §10 relates it to SLO headroom.
    """

    max_retries: int = 3  # transient retries before escalating to restart
    backoff_base_s: float = 0.005  # first retry sleeps this long
    backoff_factor: float = 2.0  # exponential growth per retry
    heartbeat_deadline_s: float = 1.0  # stall detection deadline
    restart_delay_s: float = 0.0  # modeled/imposed delay before respawn
    max_restarts: int = 8  # per-stage restarts before giving up (-> _fail)

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based)."""
        return self.backoff_base_s * (self.backoff_factor ** (attempt - 1))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    Stage events (``transient``/``crash``/``stall``) bind to a stage
    index and a 0-based per-stage invocation ordinal ``at_call``.
    Platform events (``cluster_loss``/``rejoin``) bind to ``at_s``
    (harness time) and carry ``lost`` (core-type name -> cores lost);
    ``model`` optionally scopes any event to one model of a
    ``MultiModelServer``.  Board events (``board_loss``/``board_rejoin``)
    bind to ``at_s`` and name a whole board of a fleet
    (serving/fleet.py): the board's every replica dies / comes back at
    once.  ``board`` also scopes STAGE events to one board's injector
    when the same plan drives a multi-board run.
    """

    kind: str
    stage: int = 0
    at_call: int = 0
    count: int = 1  # transient only: consecutive failing invocations
    stall_s: float = 0.0  # stall only
    at_s: float = 0.0  # platform/board events: harness-relative seconds
    lost: Tuple[Tuple[str, int], ...] = ()  # cluster_loss: ((name, n), ...)
    model: Optional[str] = None
    board: Optional[str] = None

    def __post_init__(self):
        if self.kind not in STAGE_KINDS + PLATFORM_KINDS + BOARD_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "transient" and self.count < 1:
            raise ValueError("transient count must be >= 1")
        if self.kind == "stall" and self.stall_s < 0:
            raise ValueError("stall_s must be >= 0")
        if self.kind == "cluster_loss" and not self.lost:
            raise ValueError("cluster_loss needs a non-empty 'lost' mapping")
        if self.kind in BOARD_KINDS and not self.board:
            raise ValueError(f"{self.kind} needs a board name")

    @property
    def lost_counts(self) -> Dict[str, int]:
        return dict(self.lost)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["lost"] = [list(p) for p in self.lost]
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultEvent":
        kw = dict(d)
        kw["lost"] = tuple((str(n), int(c)) for n, c in kw.get("lost", ()))
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, seeded schedule of faults.

    The plan is pure data: inject it by constructing a fresh
    :class:`FaultInjector` (:meth:`injector`) per run — the injector
    holds the mutable per-stage call counters, so one plan can replay
    identically across any number of runs.
    """

    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    # ------------------------------------------------------------ views
    def stage_events(
        self,
        model: Optional[str] = None,
        board: Optional[str] = None,
    ) -> Tuple[FaultEvent, ...]:
        """Events that fire inside stage fns (optionally scoped to one
        model and/or one board of a fleet)."""
        return tuple(
            e for e in self.events
            if e.kind in STAGE_KINDS
            and (model is None or e.model in (None, model))
            and (board is None or e.board in (None, board))
        )

    def platform_events(self) -> Tuple[FaultEvent, ...]:
        """Cluster loss / rejoin events, ordered by harness time."""
        evs = [e for e in self.events if e.kind in PLATFORM_KINDS]
        return tuple(sorted(evs, key=lambda e: e.at_s))

    def board_events(self) -> Tuple[FaultEvent, ...]:
        """Board loss / rejoin events, ordered by harness time.

        Harnesses drain these and call ``FleetRouter.fail_board`` /
        ``.rejoin_board`` (serving/fleet.py) at each ``at_s``."""
        evs = [e for e in self.events if e.kind in BOARD_KINDS]
        return tuple(sorted(evs, key=lambda e: e.at_s))

    def injector(
        self,
        policy: Optional[RecoveryPolicy] = None,
        model: Optional[str] = None,
        board: Optional[str] = None,
    ) -> "FaultInjector":
        """A fresh runtime for one run (counters start at zero)."""
        return FaultInjector(self.stage_events(model, board), policy=policy)

    # ------------------------------------------------------- round trip
    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "events": [e.to_dict() for e in self.events]}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FaultPlan":
        return cls(
            events=tuple(FaultEvent.from_dict(e) for e in d.get("events", ())),
            seed=d.get("seed"),
        )

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))

    # --------------------------------------------------------- generator
    @classmethod
    def seeded(
        cls,
        seed: int,
        *,
        n_stages: int,
        n_events: int = 4,
        kinds: Sequence[str] = STAGE_KINDS,
        max_call: int = 16,
        stall_s: float = 0.5,
        max_transient: int = 3,
    ) -> "FaultPlan":
        """A reproducible random schedule: same seed -> same plan,
        bit-for-bit (pure ``random.Random``, no global state)."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            stage = rng.randrange(n_stages)
            at_call = rng.randrange(max_call)
            if kind == "transient":
                events.append(FaultEvent(
                    kind, stage=stage, at_call=at_call,
                    count=rng.randint(1, max_transient),
                ))
            elif kind == "crash":
                events.append(FaultEvent(kind, stage=stage, at_call=at_call))
            else:  # stall
                events.append(FaultEvent(
                    kind, stage=stage, at_call=at_call, stall_s=stall_s,
                ))
        return cls(events=tuple(events), seed=seed)

    @classmethod
    def seeded_board_cycle(
        cls,
        seed: int,
        boards: Sequence[str],
        *,
        at_s: float = 0.0,
        rejoin_after_s: float = 0.0,
    ) -> "FaultPlan":
        """A reproducible board-loss -> rejoin cycle: the seed picks WHICH
        board dies (same seed -> same victim, bit-for-bit)."""
        if not boards:
            raise ValueError("need >= 1 board name")
        victim = random.Random(seed).choice(list(boards))
        return cls(
            events=(
                FaultEvent("board_loss", at_s=at_s, board=victim),
                FaultEvent(
                    "board_rejoin", at_s=at_s + rejoin_after_s, board=victim
                ),
            ),
            seed=seed,
        )


class FaultInjector:
    """The mutable runtime for one run of a :class:`FaultPlan`.

    Thread-safe.  ``on_call(stage)`` is the live hook (called at stage-fn
    entry by :func:`fault_injecting_builder`); ``sim_delay(stage)`` is
    the simulator hook, which *emulates the server's recovery loop* over
    the same invocation ordinals so live and simulated runs consume the
    schedule identically.
    """

    def __init__(
        self,
        events: Sequence[FaultEvent],
        policy: Optional[RecoveryPolicy] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        for e in events:
            if e.kind not in STAGE_KINDS:
                raise ValueError(
                    f"{e.kind!r} is a platform event; injectors only take "
                    f"stage events (use FaultPlan.platform_events)"
                )
        self.events = tuple(events)
        self.policy = policy if policy is not None else RecoveryPolicy()
        self._sleep = sleep
        self._lock = threading.Lock()
        self._calls: Dict[int, int] = {}
        #: fired (kind, stage, ordinal) triples, in consumption order
        self.fired: List[Tuple[str, int, int]] = []

    # ------------------------------------------------------------ stats
    def calls(self, stage: int) -> int:
        with self._lock:
            return self._calls.get(stage, 0)

    @property
    def total_fired(self) -> int:
        with self._lock:
            return len(self.fired)

    def fired_kinds(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for kind, _, _ in self.fired:
                out[kind] = out.get(kind, 0) + 1
            return out

    # ---------------------------------------------------------- consume
    def _consume(self, stage: int) -> Optional[FaultEvent]:
        """Advance stage's invocation ordinal; return the event active at
        the consumed ordinal (or None)."""
        with self._lock:
            c = self._calls.get(stage, 0)
            self._calls[stage] = c + 1
            for e in self.events:
                if e.stage != stage:
                    continue
                if e.kind == "transient":
                    if e.at_call <= c < e.at_call + e.count:
                        self.fired.append((e.kind, stage, c))
                        return e
                elif c == e.at_call:
                    self.fired.append((e.kind, stage, c))
                    return e
        return None

    # --------------------------------------------------------- live hook
    def on_call(self, stage: int) -> None:
        """Fire the scheduled fault (if any) for this stage invocation.

        Raises :class:`TransientStageError` / :class:`WorkerCrash`, or
        sleeps ``stall_s`` (silent stall) before returning.  Called at
        stage-fn ENTRY, before compute, so a crashed invocation costs one
        restart + re-dispatch rather than double compute — matching the
        simulator's accounting.
        """
        e = self._consume(stage)
        if e is None:
            return
        if e.kind == "transient":
            raise TransientStageError(
                f"injected transient error (stage {stage}, call {self.calls(stage) - 1})"
            )
        if e.kind == "crash":
            raise WorkerCrash(
                f"injected worker crash (stage {stage}, call {self.calls(stage) - 1})"
            )
        # stall: silently wedge, then let the fn proceed.  If the stall
        # outlives the watchdog deadline this invocation's result is
        # discarded as stale (the replacement worker re-dispatched it).
        if e.stall_s > 0:
            self._sleep(e.stall_s)

    # ---------------------------------------------------- simulator hook
    def sim_delay(self, stage: int) -> float:
        """Deterministic extra seconds for the next invocation of
        ``stage``, emulating the server's recovery loop.

        Mirrors the live path event for event: transient retries consume
        consecutive ordinals and cost their backoffs; escalation and
        crashes cost ``restart_delay_s`` (re-dispatch re-invokes, so the
        loop continues on the next ordinal); a stall costs its full
        ``stall_s`` when it beats the watchdog deadline, else the
        deadline (detection) plus a restart.
        """
        pol = self.policy
        delay = 0.0
        attempt = 0
        while True:
            e = self._consume(stage)
            if e is None:
                return delay
            if e.kind == "transient":
                attempt += 1
                if attempt > pol.max_retries:
                    # escalate: restart + re-dispatch; the retry budget
                    # resets for the replacement worker
                    delay += pol.restart_delay_s
                    attempt = 0
                else:
                    delay += pol.backoff_s(attempt)
                continue  # the retry / re-dispatch is a new invocation
            if e.kind == "crash":
                delay += pol.restart_delay_s
                attempt = 0
                continue
            # stall
            if e.stall_s <= pol.heartbeat_deadline_s:
                # wakes before detection: the invocation completes late
                return delay + e.stall_s
            # detected: watchdog fires at the deadline, restarts the
            # stage, and the replacement re-dispatches (next ordinal)
            delay += pol.heartbeat_deadline_s + pol.restart_delay_s
            attempt = 0


_WARMING = threading.local()


@contextlib.contextmanager
def warm_calls():
    """Stage fns called on this thread inside the block skip every
    injector: a warm-up is not a served invocation (module docstring)."""
    outer = getattr(_WARMING, "on", False)
    _WARMING.on = True
    try:
        yield
    finally:
        _WARMING.on = outer


def fault_injecting_builder(
    inner_builder: Callable[..., Sequence[Callable]],
    injector: FaultInjector,
) -> Callable[..., List[Callable]]:
    """Wrap a ``stage_fn_builder`` so every stage fn consults ``injector``
    at entry.

    Drop-in for ``PipelineServer(stage_fn_builder=...)`` — composes with
    any inner builder (real compute, ``delayed_stage_fn_builder`` fake
    boards, governed builders).  The wrapped fns keep the stage-fn
    contract (pure function of ``(params, batch)``) because the injected
    faults depend only on the injector's deterministic call schedule, so
    re-executing an invocation after a crash is safe (at-least-once).
    """

    def build(graph, plan, **kwargs) -> List[Callable]:
        fns = inner_builder(graph, plan, **kwargs)

        def wrap(si: int, fn: Callable) -> Callable:
            def faulty(params, batch):
                if not getattr(_WARMING, "on", False):
                    injector.on_call(si)
                return fn(params, batch)

            return faulty

        return [wrap(si, fn) for si, fn in enumerate(fns)]

    return build
