"""FleetRouter — N simulated boards behind one global ingress.

The live counterpart of core/fleet.py: each board of a
:class:`~repro_torch.core.fleet.FleetPlan` runs its own
:class:`~.multimodel.MultiModelServer` (one pipeline per hosted replica),
and one :class:`FleetRouter` owns the fleet-level ingress:

* **routing** — every submit goes to the least-loaded alive replica of
  its model (ingress depth + in-flight, ties by board order);
* **board loss / rejoin** — :meth:`FleetRouter.fail_board` simulates an
  abrupt board death (``PipelineServer.crash``): the board's generation
  is bumped, its in-flight fleet tickets are *re-dispatched* to
  surviving replicas, and late completions from the dead board are
  discarded at the fleet egress — the server's generation-token +
  egress-dedup machinery lifted from per-worker to per-board scope, so a
  client sees each accepted image resolve exactly once;
* **replica autoscaling** — :class:`FleetAutoscaler` converts each
  model's *observed* arrival rate into a desired replica count, re-runs
  :func:`~repro_torch.core.fleet.fleet_search`, and applies the new plan with
  :meth:`FleetRouter.apply_plan`: boards whose hosted-model set is
  unchanged hot-swap in place (the epoch protocol —
  ``MultiModelServer.swap_partition``), boards gaining/losing models
  drain-and-rebuild while submits for their models wait on the router's
  condition variable — zero dropped tickets either way.

Boards here are *simulated* (threads + scripted stage delays on one
host); the routing, re-dispatch, and autoscaling logic is exactly what a
networked deployment would run per board (DESIGN.md §11 maps which parts
are silicon-ready).

The port's copy of ``repro/serving/fleet.py``, on the port's ``core/``
and :class:`~.multimodel.MultiModelServer`.  :class:`FleetRouter` takes
``device=`` (``None`` means the card) and hands it to every board's
server, so on one card the boards share it, as the reference's share one
host.  Warm-up on the card captures each stage's CUDA graph
(``kernels/graphs.py``); captures are serialised and thread-local, so a
board rebuilt by ``rejoin_board`` or ``apply_plan`` captures while its
peers replay.  A lost or rebuilt board's server is stopped, its workers
joined, before it is dropped, so no replay still runs on a stage stream
when its graphs' pools go back to the allocator.  Two departures from
the reference: a submit that meets the closed server of a board lost
after the router picked it returns its ticket (the loss re-dispatches
the entry) where the reference raises; and ``fail_board`` collects the
reference cycle a crashed server leaves, so the lost board's memory is
free before a rejoin captures.
"""
from __future__ import annotations

import collections
import gc
import logging
import math
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

from ..core.fleet import BoardPlan, BoardSpec, FleetPlan, fleet_search
from ..core.pipeline import TimeMatrix
from ..kernels.config import resolve_device
from .multimodel import MultiModelServer
from .registry import ModelRegistry
from .server import Backpressure, ServingError, Ticket

logger = logging.getLogger(__name__)

__all__ = ["FleetRouter", "FleetAutoscaler", "NoReplica"]

#: ``stage_fn_builders`` spec: one mapping shared by every board, or a
#: factory keyed by board name (per-board fault injection / fake delays).
BuilderSpec = Union[
    None,
    Mapping[str, Any],
    Callable[[str], Optional[Mapping[str, Any]]],
]


class NoReplica(ServingError):
    """No alive board hosts the requested model (and none is rebuilding)."""


class _Board:
    """Mutable runtime state of one board (router-lock protected)."""

    __slots__ = ("spec", "plan", "server", "generation", "alive", "draining")

    def __init__(self, spec: BoardSpec, plan: BoardPlan):
        self.spec = spec
        self.plan = plan
        self.server: Optional[MultiModelServer] = None
        self.generation = 0  # bumps on every death/rebuild — the dedup token
        self.alive = True
        self.draining = False


class _Inflight:
    """One accepted image: the fleet ticket plus what re-dispatch needs."""

    __slots__ = ("ticket", "model", "payload", "board", "generation")

    def __init__(self, ticket: Ticket, model: str, payload: Any):
        self.ticket = ticket
        self.model = model
        self.payload = payload
        self.board: Optional[str] = None
        self.generation = -1


def _reap(server: MultiModelServer, board: str, orphans: int, timeout: float) -> None:
    """Crash a lost board's servers and join their workers."""
    for inner in server.servers.values():
        inner.crash()
    try:
        server.stop(timeout=timeout)
    except Exception:  # the scripted crash re-raises here as a
        # ServingError; an interrupt must NOT be absorbed into the reap
        # log — Ctrl-C outranks fault handling
        logger.info(
            "board %r: reaped crashed servers (%d orphaned tickets)",
            board, orphans,
        )


class FleetRouter:
    """Global ingress + replica lifecycle for one :class:`FleetPlan`.

    Parameters mirror :class:`~.multimodel.MultiModelServer` (applied per
    board); ``stage_fn_builders`` may be a per-model mapping shared by
    all boards or a ``board_name -> mapping`` factory.  ``rate_window_s``
    is the sliding window :meth:`observed_rate` measures arrivals over.
    ``device`` is where every board's stages run (``None``: the card,
    which raises on a host without CUDA); the registry's params must
    live there.
    """

    def __init__(
        self,
        registry: ModelRegistry,
        plan: FleetPlan,
        *,
        batch_size: int = 1,
        flush_timeout_s: float = 0.01,
        queue_depth: int = 2,
        stage_fn_builders: BuilderSpec = None,
        backend=None,
        recovery=None,
        rate_window_s: float = 2.0,
        boards: Optional[Sequence[BoardSpec]] = None,
        device=None,
    ):
        self.registry = ModelRegistry.coerce(registry)
        missing = [n for n in plan.names if n not in self.registry]
        if missing:
            raise ValueError(f"fleet plan names models the registry lacks: {missing}")
        # the original specs carry per-board power caps the plan drops;
        # keep them so autoscale re-plans stay under the same envelopes
        specs = {b.name: b for b in (boards or ())}
        unknown = [n for n in specs if all(bp.board != n for bp in plan.boards)]
        if unknown:
            raise ValueError(
                f"boards {unknown} are not in the fleet plan "
                f"({[bp.board for bp in plan.boards]})"
            )
        self.device = resolve_device(device)
        self.plan = plan
        self.plan_epoch = 0
        self.batch_size = batch_size
        self.flush_timeout_s = flush_timeout_s
        self.queue_depth = queue_depth
        self.backend = backend
        self.recovery = recovery
        self.rate_window_s = rate_window_s
        self._builders = stage_fn_builders
        self._lock = threading.Lock()
        self._changed = threading.Condition(self._lock)
        self._boards: Dict[str, _Board] = {
            bp.board: _Board(
                specs.get(bp.board, BoardSpec(bp.board, bp.platform)), bp
            )
            for bp in plan.boards
        }
        self._inflight: Dict[int, _Inflight] = {}
        self._arrivals: Dict[str, collections.deque] = {
            n: collections.deque(maxlen=65536) for n in self.registry.names
        }
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.redispatched = 0
        self.duplicates_discarded = 0
        self._started = False

    # ----------------------------------------------------------- lifecycle
    def _builders_for(self, board: str) -> Optional[Mapping[str, Any]]:
        if callable(self._builders):
            return self._builders(board)
        return self._builders

    def _build_server(self, board: _Board) -> Optional[MultiModelServer]:
        if board.plan.partition is None:
            return None
        sub = ModelRegistry.coerce(
            {n: self.registry[n] for n in board.plan.models}
        )
        return MultiModelServer(
            sub,
            board.plan.partition,
            batch_size=self.batch_size,
            flush_timeout_s=self.flush_timeout_s,
            queue_depth=self.queue_depth,
            stage_fn_builders=self._builders_for(board.spec.name),
            backend=self.backend,
            recovery=self.recovery,
            device=self.device,
        )

    def start(self) -> "FleetRouter":
        for board in self._boards.values():
            if board.server is None:
                board.server = self._build_server(board)
            if board.server is not None:
                board.server.start()
        self._started = True
        return self

    def warmup(self) -> None:
        """Warm every stage on every alive board: on the card, capture
        each stage's CUDA graph.

        The router load-balances, so sequential warm traffic lands on one
        replica and leaves the others cold — their first real images would
        run op by op and pay the capture.  Call this (or rely on
        ``rejoin_board`` / ``apply_plan``, which warm rebuilt servers
        before they take traffic) to capture the whole fleet up front.
        """
        with self._lock:
            servers = [
                b.server
                for b in self._boards.values()
                if b.alive and b.server is not None
            ]
        for srv in servers:
            srv.warmup()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop every board; the first error re-raises (interrupts first,
        matching ``MultiModelServer.stop``)."""
        first: Optional[BaseException] = None
        for board in self._boards.values():
            srv = board.server
            if srv is None:
                continue
            try:
                srv.stop(timeout=timeout)
            except BaseException as e:  # noqa: BLE001 — keep stopping boards
                if first is None or (
                    isinstance(e, (KeyboardInterrupt, SystemExit))
                    and not isinstance(first, (KeyboardInterrupt, SystemExit))
                ):
                    first = e
        if first is not None:
            raise first

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.stop()
        else:
            try:
                self.stop()
            except Exception:
                logger.exception(
                    "fleet router: stop() raised while unwinding %s "
                    "(absorbed so the caller's exception propagates)",
                    exc_type.__name__,
                )

    # ------------------------------------------------------------- routing
    def models(self) -> List[str]:
        return self.registry.names

    def alive_replicas(self, model: str) -> List[str]:
        with self._lock:
            return [
                name
                for name, b in self._boards.items()
                if b.alive and model in b.plan.models
            ]

    def alive_board_specs(self) -> List[BoardSpec]:
        with self._lock:
            return [b.spec for b in self._boards.values() if b.alive]

    def _load(self, board: _Board, model: str) -> int:
        srv = board.server
        if srv is None or model not in srv.servers:
            return 1 << 30
        inner = srv.servers[model]
        return inner.ingress_depth() + inner.inflight

    def submit(
        self,
        model: str,
        image,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> Ticket:
        """Accept one image for ``model`` and return the FLEET ticket.

        The payload is retained until the ticket resolves so a board
        loss can re-dispatch it; the client-visible contract is
        exactly-once (late results from a dead board are discarded at
        the fleet egress).  When every replica of the model is mid-
        rebuild (``apply_plan``), a blocking submit waits for the
        rebuild instead of failing — zero drops across an autoscale.
        """
        if model not in self.registry:
            raise KeyError(
                f"unknown model {model!r}; fleet serves {self.registry.names}"
            )
        now = time.perf_counter()
        with self._lock:
            self._arrivals[model].append(now)
            self.submitted += 1
        entry = _Inflight(Ticket(submitted_at=now), model, image)
        self._dispatch(entry, block=block, timeout=timeout)
        return entry.ticket

    def _dispatch(
        self,
        entry: _Inflight,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> None:
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            with self._lock:
                candidates = sorted(
                    (
                        name
                        for name, b in self._boards.items()
                        if b.alive
                        and not b.draining
                        and b.server is not None
                        and entry.model in b.plan.models
                    ),
                    key=lambda name: (
                        self._load(self._boards[name], entry.model),
                        name,
                    ),
                )
                rebuilding = any(
                    b.alive
                    and (
                        b.draining
                        or (b.server is None and b.plan.partition is not None)
                    )
                    for b in self._boards.values()
                )
            backpressure: Optional[Backpressure] = None
            for name in candidates:
                with self._lock:
                    board = self._boards[name]
                    if (
                        not board.alive
                        or board.draining
                        or board.server is None
                        or entry.model not in board.plan.models
                    ):
                        continue
                    srv = board.server
                    gen = board.generation
                    entry.board, entry.generation = name, gen
                    self._inflight[entry.ticket.id] = entry
                try:
                    # non-blocking per board: a full replica must not
                    # serialise the fleet behind it while a peer has room
                    inner = srv.submit(entry.model, entry.payload, block=False)
                except Exception as err:
                    with self._lock:
                        owned = (
                            self._inflight.get(entry.ticket.id) is entry
                            and entry.board == name
                            and entry.generation == gen
                        )
                        if owned:
                            del self._inflight[entry.ticket.id]
                    if not owned:
                        # The board died between the pick above and this
                        # submit (whose server is closed by now):
                        # fail_board took the entry as an orphan and
                        # re-dispatches it, so the fleet ticket stays live.
                        return
                    if isinstance(err, Backpressure):
                        backpressure = err
                        continue
                    raise
                except BaseException:
                    with self._lock:
                        self._inflight.pop(entry.ticket.id, None)
                    raise
                inner.add_done_callback(
                    lambda t, e=entry, g=gen: self._inner_done(e, g, t)
                )
                return
            if not candidates and not rebuilding:
                raise NoReplica(
                    f"no alive replica hosts {entry.model!r} "
                    f"(fleet plan: {self.plan.notation()})"
                )
            if not block:
                raise backpressure or Backpressure(
                    f"every replica of {entry.model!r} is full or rebuilding"
                )
            if deadline is not None and time.perf_counter() >= deadline:
                raise backpressure or Backpressure(
                    f"submit timeout: every replica of {entry.model!r} "
                    "stayed full/rebuilding"
                )
            with self._changed:
                self._changed.wait(timeout=0.002)

    def _inner_done(self, entry: _Inflight, gen: int, inner: Ticket) -> None:
        with self._lock:
            owned = (
                self._inflight.get(entry.ticket.id) is entry
                and entry.generation == gen
            )
            if owned:
                del self._inflight[entry.ticket.id]
            else:
                # A dead board's completion racing its re-dispatch: the
                # re-dispatched copy owns the ticket now — discard this
                # result at the fleet egress (per-board dedup).
                if inner._error is None:
                    self.duplicates_discarded += 1
                return
        try:
            value = inner.result(timeout=0)
        except BaseException as err:  # noqa: BLE001 — board still "alive"
            # but its pipeline failed outside a scripted board loss:
            # surface to the client (same contract as a worker failure)
            with self._lock:
                self.failed += 1
            entry.ticket._fail(err)
            return
        if entry.ticket.done():
            with self._lock:
                self.duplicates_discarded += 1
            return
        entry.ticket._resolve(value)
        with self._lock:
            self.completed += 1

    # --------------------------------------------------- board loss / rejoin
    def fail_board(self, name: str, *, timeout: float = 10.0) -> int:
        """Simulate an abrupt board death; returns #tickets re-dispatched.

        Ownership of the board's in-flight fleet tickets moves to the
        router BEFORE the crash propagates, so the dying pipelines'
        failure callbacks find the entries gone and no client ticket
        fails; each orphan is then re-submitted to a surviving replica
        of its model (oldest first).  Idempotent on a dead board.
        """
        with self._lock:
            board = self._board(name)
            if not board.alive:
                return 0
            board.alive = False
            board.generation += 1
            srv, board.server = board.server, None
            orphans = [
                e for e in self._inflight.values() if e.board == name
            ]
            for e in orphans:
                del self._inflight[e.ticket.id]
            self._changed.notify_all()
        if srv is not None:
            _reap(srv, name, len(orphans), timeout)
            # stop() re-raised the crash reason, whose traceback holds the
            # dead servers in a reference cycle (reason -> frames ->
            # server -> reason): collect it now, so the lost board's stage
            # graphs give back their pools (on the card) before a rejoin
            # captures anew, not whenever the interpreter next collects
            del srv
            gc.collect()
        redispatched = 0
        for e in sorted(orphans, key=lambda e: e.ticket.id):
            if e.ticket.done():
                continue  # resolved just before the crash took the queues
            try:
                self._dispatch(e, block=True, timeout=timeout)
                redispatched += 1
            except BaseException as err:  # noqa: BLE001 — no survivor hosts it
                e.ticket._fail(err)
                with self._lock:
                    self.failed += 1
        with self._lock:
            self.redispatched += redispatched
        return redispatched

    def rejoin_board(self, name: str) -> None:
        """Bring a dead board back on its last assigned partition (a
        fresh server, a fresh generation).  Callers wanting a different
        placement re-plan via :meth:`apply_plan` afterwards."""
        with self._lock:
            board = self._board(name)
            if board.alive:
                return
            board.generation += 1
        server = self._build_server(board)
        if server is not None and self._started:
            server.start()
            server.warmup()  # capture the stage graphs before taking traffic
        with self._lock:
            board.server = server
            board.alive = True
            self._changed.notify_all()

    def _board(self, name: str) -> _Board:
        try:
            return self._boards[name]
        except KeyError:
            raise KeyError(
                f"unknown board {name!r}; fleet has {sorted(self._boards)}"
            ) from None

    # ------------------------------------------------------------- swapping
    def apply_plan(self, plan: FleetPlan, *, timeout: float = 60.0) -> None:
        """Switch the fleet to ``plan`` without dropping a ticket.

        Boards are processed one at a time: an alive board whose
        hosted-model set is unchanged hot-swaps via the epoch protocol
        (``swap_partition`` — in-flight work survives); a board whose
        set changed (or goes idle) is drained (its in-flight tickets
        complete, new submits route to peers or wait) and rebuilt.
        Boards absent from ``plan`` (e.g. a re-plan over survivors)
        keep their current state.
        """
        for bp in plan.boards:
            with self._lock:
                board = self._boards.get(bp.board)
                if board is None:
                    raise KeyError(
                        f"plan names unknown board {bp.board!r}; "
                        f"fleet has {sorted(self._boards)}"
                    )
            if not board.alive:
                with self._lock:
                    board.plan = bp  # picked up by the next rejoin
                continue
            same_models = sorted(bp.models) == sorted(board.plan.models)
            if bp.partition is not None and same_models and board.server is not None:
                if bp.partition != board.plan.partition:
                    board.server.swap_partition(bp.partition, timeout=timeout)
                with self._lock:
                    board.plan = bp
                continue
            # hosted set changed: drain, rebuild, restart
            with self._lock:
                board.draining = True
            try:
                deadline = time.perf_counter() + timeout
                while True:
                    with self._lock:
                        pending = [
                            e
                            for e in self._inflight.values()
                            if e.board == bp.board
                        ]
                    if not pending:
                        break
                    if time.perf_counter() > deadline:
                        raise ServingError(
                            f"board {bp.board!r}: drain deadline expired with "
                            f"{len(pending)} ticket(s) in flight"
                        )
                    time.sleep(0.001)
                old, board.server = board.server, None
                if old is not None:
                    old.stop(timeout=max(0.0, deadline - time.perf_counter()))
                with self._lock:
                    board.plan = bp
                    board.generation += 1
                server = self._build_server(board)
                if server is not None and self._started:
                    server.start()
                    server.warmup()  # capture the stage graphs before taking traffic
                with self._lock:
                    board.server = server
            finally:
                with self._lock:
                    board.draining = False
                    self._changed.notify_all()
        self.plan = plan
        self.plan_epoch += 1

    # -------------------------------------------------------------- metrics
    def observed_rate(
        self, model: str, window_s: Optional[float] = None
    ) -> float:
        """Arrivals per second for ``model`` over the sliding window."""
        win = self.rate_window_s if window_s is None else window_s
        cutoff = time.perf_counter() - win
        with self._lock:
            n = sum(1 for t in self._arrivals[model] if t >= cutoff)
        return n / win if win > 0 else 0.0

    def metrics(self) -> Dict[str, Any]:
        """Fleet snapshot: router counters, per-model observed rates, and
        per-board state including per-replica queue depths."""
        with self._lock:
            counters = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "redispatched": self.redispatched,
                "duplicates_discarded": self.duplicates_discarded,
                "inflight": len(self._inflight),
            }
            boards = list(self._boards.items())
        board_snap: Dict[str, Any] = {}
        agg_tp = 0.0
        for name, b in boards:
            srv = b.server
            queues: Dict[str, int] = {}
            inflight: Dict[str, int] = {}
            completed = 0
            if srv is not None:
                for m, inner in srv.servers.items():
                    queues[m] = inner.ingress_depth()
                    inflight[m] = inner.inflight
                    completed += inner.metrics.snapshot()["completed"]
                    agg_tp += inner.metrics.throughput()
            board_snap[name] = {
                "alive": b.alive,
                "draining": b.draining,
                "generation": b.generation,
                "models": list(b.plan.models),
                "queue_depths": queues,
                "inflight": inflight,
                "completed": completed,
            }
        return {
            "plan": self.plan.notation(),
            "plan_epoch": self.plan_epoch,
            **counters,
            "observed_rates": {
                m: self.observed_rate(m) for m in self.registry.names
            },
            "aggregate_throughput_img_s": agg_tp,
            "boards": board_snap,
        }


class FleetAutoscaler:
    """Observed arrival rate -> desired replicas -> re-plan -> hot apply.

    ``desired = ceil(rate / (target_utilization * per_replica_capacity))``
    clamped to ``[min_replicas, alive boards]``, where the per-replica
    capacity is the current plan's modeled aggregate for the model
    divided by its replica count.  ``step()`` re-runs
    :func:`~repro_torch.core.fleet.fleet_search` only when some desired count
    changed, and applies via :meth:`FleetRouter.apply_plan` (zero-drop).
    Driven explicitly (benchmarks/tests call ``step()``) — no daemon
    thread, so every decision is deterministic and observable.
    """

    def __init__(
        self,
        router: FleetRouter,
        instances: Mapping[str, TimeMatrix],
        *,
        target_utilization: float = 0.7,
        window_s: Optional[float] = None,
        min_replicas: int = 1,
        max_replicas: Optional[int] = None,
        fairness: str = "sum",
    ):
        if not 0.0 < target_utilization <= 1.0:
            raise ValueError("target_utilization must be in (0, 1]")
        self.router = router
        self.instances = dict(instances)
        self.target_utilization = target_utilization
        self.window_s = window_s
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.fairness = fairness
        self.decisions: List[Dict[str, Any]] = []

    def desired_replicas(self) -> Dict[str, int]:
        plan = self.router.plan
        counts = plan.replica_counts()
        agg = plan.throughputs()
        n_alive = len(self.router.alive_board_specs())
        cap = self.max_replicas if self.max_replicas is not None else n_alive
        out: Dict[str, int] = {}
        for m in self.instances:
            r = max(1, counts.get(m, 1))
            per_replica = agg.get(m, 0.0) / r
            rate = self.router.observed_rate(m, self.window_s)
            if per_replica <= 0.0:
                out[m] = r
                continue
            need = math.ceil(rate / (self.target_utilization * per_replica))
            out[m] = max(self.min_replicas, min(max(need, 1), cap, n_alive))
        return out

    def step(self) -> Optional[FleetPlan]:
        """One control decision; returns the new plan iff it re-planned."""
        desired = self.desired_replicas()
        current = self.router.plan.replica_counts()
        if all(desired.get(m) == current.get(m) for m in desired):
            return None
        new_plan = fleet_search(
            self.instances,
            self.router.alive_board_specs(),
            replicas=desired,
            weights=self.router.registry.weights(),
            slo_rates=self.router.registry.slo_rates(),
            fairness=self.fairness,
        )
        self.router.apply_plan(new_plan)
        self.decisions.append(
            {
                "desired": dict(desired),
                "was": dict(current),
                "plan": new_plan.notation(),
            }
        )
        return new_plan
