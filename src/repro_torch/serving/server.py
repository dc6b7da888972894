"""PipelineServer — persistent, batched, bounded-queue pipelined serving.

This is the production form of the paper's layer-level pipeline (Fig. 2):
one long-lived worker thread per pipeline stage, connected by bounded
queues, continuously draining an image stream.  Relative to the one-shot
:class:`repro_torch.serving.engine.PipelinedGraphEngine` it adds what a serving
deployment needs:

* **Persistent stage workers** — threads start once and survive across
  requests, so steady-state throughput (Eq. 12:
  ``1 / max_i T_{L_i}^{P_i}``) is not diluted by per-call thread spawn
  and teardown.
* **Micro-batching** — stage 0 coalesces up to ``batch_size`` images
  (flushing on ``flush_timeout_s``) into fixed-shape micro-batches
  (:mod:`repro_torch.serving.batching`); each stage then amortises its per-call
  overhead (the Eq. 6-8 ``a2/a3`` analogues) across the batch.
* **Bounded queues with backpressure** — ``submit`` blocks (or raises
  :class:`Backpressure`) when the pipeline is full, so an open-loop
  client cannot grow memory without bound; queue depth bounds the
  pipeline-fill latency term of Eq. 11.
* **Metrics** — per-stage service-time percentiles and occupancy plus
  end-to-end latency/throughput (:mod:`repro_torch.serving.metrics`).  The
  bottleneck stage is visible as the one with occupancy near 1.0, which
  is exactly the ``argmax_i T_{L_i}^{P_i}`` of Eq. 12.

Construction is usually via :func:`repro_torch.serving.planner.serve`, which
runs the paper's DSE (Algorithms 1-3) to pick the stage plan first.

On the card every stage worker issues its kernels on a CUDA stream of its
own, so the stages of one pipeline overlap on the device the way the
paper's stages overlap on their clusters.  A stage synchronizes its
stream before it hands its output env to the next stage (the counterpart
of the reference's ``block_until_ready``), and it holds its input env
until then: a tensor made on stage i's stream and freed by stage i+1
returns to stage i's allocator pool only after every kernel that read it
has finished.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..cnn.graph import Graph
from ..core.pipeline import PipelinePlan
from ..kernels.config import resolve_device, synchronize
from .batching import MicroBatch, gather, split_rows, stack_envs
from .engine import build_stage_fns, on_stream, stage_stream, sync_stream
from .faults import RecoveryPolicy, TransientStageError
from .metrics import ServerMetrics

_SENTINEL = object()

# Failures on the egress/callback/shutdown paths are absorbed by design
# (a user callback must not kill the egress worker; a flush error must not
# mask the caller's exception) — but absorbed NEVER means silent: every
# such site logs here with enough context (ticket id, path) to debug.
logger = logging.getLogger(__name__)


class ServingError(RuntimeError):
    """Base class for serving-runtime failures."""


class Backpressure(ServingError):
    """The ingress queue stayed full past the submit timeout."""


class ServerClosed(ServingError):
    """submit() after stop(), or after a worker failure closed the server."""


class Ticket:
    """A pending result for one submitted image (a minimal future).

    ``submitted_at`` is the enqueue timestamp (stamped inside ``submit()``)
    and ``dequeued_at`` is set by the stage-0 worker when the image's
    micro-batch forms — their difference is the ingress-queue wait, the
    component that dominates tail latency under open-loop load.
    """

    __slots__ = (
        "id", "submitted_at", "dequeued_at", "_event", "_value", "_error",
        "_callbacks", "_cb_lock",
    )

    _ids = itertools.count()  # monotone ids for log/trace context

    def __init__(self, submitted_at: float):
        self.id = next(Ticket._ids)
        self.submitted_at = submitted_at
        self.dequeued_at: Optional[float] = None
        self._event = threading.Event()
        self._value: Optional[torch.Tensor] = None
        self._error: Optional[BaseException] = None
        self._callbacks: List = []
        self._cb_lock = threading.Lock()

    def _resolve(self, value: torch.Tensor) -> None:
        self._value = value
        self._finish()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._finish()

    def _finish(self) -> None:
        self._event.set()
        with self._cb_lock:
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — a callback must not kill egress
                logger.exception(
                    "ticket %d done-callback %r raised on the egress path "
                    "(callback error absorbed; ticket already %s)",
                    self.id, cb, "failed" if self._error is not None else "resolved",
                )

    def add_done_callback(self, fn) -> None:
        """Run ``fn(ticket)`` when the ticket resolves or fails; runs
        immediately if it already has.  Fires exactly once per callback
        (the multi-model router counts its admitted in-flight load with
        this).  ``_fail`` can race ``_resolve`` only after a worker
        failure, where the loser finds the list already drained."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:  # noqa: BLE001 — symmetric with _finish
            logger.exception(
                "ticket %d done-callback %r raised (already-done path; "
                "error absorbed)", self.id, fn,
            )

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> torch.Tensor:
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value


class PipelineServer:
    """Continuously-running pipelined CNN server for a fixed plan.

    Parameters
    ----------
    graph, params : the CNN graph and its parameters.
    plan : Pipe-it :class:`PipelinePlan` (stage configs + layer allocation).
    batch_size : micro-batch width; every stage runs at exactly this
        leading dimension (partial flushes are zero-padded).
    flush_timeout_s : max time stage 0 waits to fill a micro-batch after
        its first image arrives before flushing a partial batch.
    queue_depth : bound on each inter-stage queue (micro-batches) and, x
        ``batch_size``, on the ingress queue (images) — the backpressure
        surface.
    stage_fn_builder : ``(graph, plan) -> [stage_fn]`` factory used for the
        initial plan AND for every ``swap_plan``; defaults to the real
        stage functions (:func:`repro_torch.serving.engine.build_stage_fns`),
        each captured as a CUDA graph on the card at its first call at
        ``batch_size`` (:meth:`warmup`, or the prepare phase of
        ``swap_plan``) and replayed for every micro-batch after it.
        :func:`~repro_torch.serving.engine.build_eager_stage_fns` runs them
        op by op instead.  Tests inject fake-stage builders here (real
        outputs plus a scripted service delay or fault) to run the server
        against known timings.
    backend : kernel execution backend spec for the stage functions
        ("torch" | "cuda" | "cuda_fused", a per-node mapping/callable, or a
        resolved ``repro_torch.kernels.backend.KernelBackend``).  Resolved
        once and reused across plan swaps; ignored when a custom
        ``stage_fn_builder`` is injected.
    recovery : optional :class:`repro_torch.serving.faults.RecoveryPolicy`.
        ``None`` (default) keeps the historical fail-fast contract: any
        worker error closes the server and fails every in-flight ticket.
        With a policy, the server self-heals instead:

        * **transient errors** (:class:`TransientStageError`) retry in
          place with exponential backoff, escalating to a restart after
          ``max_retries``;
        * **worker crashes** restart the stage (a fresh generation) and
          *re-dispatch* the in-flight micro-batch to it — at-least-once
          execution, safe because stage fns are pure functions of
          ``(params, batch)``; the egress worker dedupes by the
          already-resolved :class:`Ticket` (monotone ``Ticket.id``), so
          clients still see each output exactly once;
        * **silent stalls** are converted into detected failures by a
          heartbeat watchdog within ``heartbeat_deadline_s`` — the
          wedged thread is abandoned (it exits on wake, its late result
          discarded as stale) and a replacement re-dispatches;
        * recovery counters (retries, re-dispatches, restarts, MTTR,
          heartbeat ages) live in ``metrics.recovery``.

        ``max_restarts`` bounds self-healing per stage per epoch; past
        it the server falls back to fail-fast.
    device : where the stages run and where ``params`` live; ``None``
        means the card (and raises on a host without CUDA).
    """

    def __init__(
        self,
        graph: Graph,
        params,
        plan: PipelinePlan,
        *,
        batch_size: int = 4,
        flush_timeout_s: float = 0.01,
        queue_depth: int = 2,
        stage_fn_builder=None,
        backend=None,
        name: str = "pipe",
        recovery: Optional[RecoveryPolicy] = None,
        device=None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.device = resolve_device(device)
        self.name = name  # label for worker threads (multi-model servers)
        self.graph = graph
        self.params = params
        self.plan = plan
        self.batch_size = batch_size
        self.flush_timeout_s = flush_timeout_s
        self.queue_depth = queue_depth
        if stage_fn_builder is None:
            from ..kernels.backend import resolve_backend

            kb = resolve_backend(backend)
            self.backend = kb
            stage_fn_builder = (
                lambda graph, plan, _kb=kb: build_stage_fns(graph, plan, backend=_kb)
            )
        else:
            self.backend = None
        self._stage_fn_builder = stage_fn_builder
        self._stage_fns = self._stage_fn_builder(graph, plan)
        n = len(self._stage_fns)
        self._ingress: "queue.Queue" = queue.Queue(maxsize=queue_depth * batch_size)
        self._qs: List["queue.Queue"] = [
            queue.Queue(maxsize=queue_depth) for _ in range(n)
        ]  # _qs[i] feeds stage i+1 for i<n-1; _qs[-1] feeds the egress worker
        self.metrics = ServerMetrics(self._stage_names(plan))
        self._threads: List[threading.Thread] = []
        self._inflight: set = set()
        self._epoch = 0
        self.recovery = recovery
        # Optional PlanStore (serving/persistence.py): the last-known-good
        # plan is saved after every successful swap (and on attach).
        self.plan_store = None
        # Worker generation tokens: each spawned/restarted stage worker
        # gets a unique monotone generation; a superseded ("zombie")
        # worker notices its token is stale and exits without forwarding,
        # so a stalled thread abandoned by the watchdog can never corrupt
        # the stream its replacement re-dispatched.
        self._gen_seq = itertools.count(1)
        self._stage_gen: List[int] = []
        self._processing: List[Optional[Any]] = []  # in-flight work, per stage
        self._busy_since: List[Optional[float]] = []  # heartbeat timestamps
        self._fault_at: List[Optional[float]] = []  # MTTR episode starts
        self._restarts: List[int] = []
        self._abandoned: List[threading.Thread] = []  # watchdog-shot zombies
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        # Optional adaptive-control attachment (serving/adaptive.py); when
        # set, stop() shuts it down before draining the pipeline.
        self.monitor = None
        # Optional DVFS attachment (serving/governor.py): owns the live
        # per-stage frequency assignment; passive (no thread of its own).
        self.governor = None
        self._lock = threading.Lock()
        # Serializes ingress puts against stop()'s shutdown sentinel: a
        # submit that passed the closed-check is guaranteed to land its
        # image AHEAD of the sentinel, so it gets flushed, not stranded.
        # swap_plan() holds it for a whole drain; _sealed marks those long
        # holds so non-blocking submits shed immediately instead of
        # mistaking a peer submit's microsecond hold for saturation.
        self._submit_lock = threading.Lock()
        self._sealed = False
        self._started = False
        self._closed = False
        self._error: Optional[BaseException] = None
        self._reset_recovery_state(n)

    # ------------------------------------------------------------ lifecycle
    @staticmethod
    def _stage_names(plan: PipelinePlan) -> List[str]:
        return [f"{i}:{t}{c}" for i, (t, c) in enumerate(plan.pipeline.stages)]

    @property
    def epoch(self) -> int:
        """Worker generation: bumped by every completed swap_plan()."""
        return self._epoch

    @property
    def inflight(self) -> int:
        """Requests admitted but not yet resolved or failed — the signal
        the multi-model router's per-model admission control bounds."""
        with self._lock:
            return len(self._inflight)

    def _reset_recovery_state(self, n: int) -> None:
        """Fresh per-stage recovery bookkeeping for ``n`` stages (epoch
        boundary or construction).  Generation 0 means 'no live worker';
        real generations (from ``_gen_seq``) start at 1."""
        with self._lock:
            self._stage_gen = [0] * n
            self._processing = [None] * n
            self._busy_since = [None] * n
            self._fault_at = [None] * n
            self._restarts = [0] * n

    def _spawn_workers(self) -> None:
        # Idempotent: spawning while the current epoch's workers are
        # still alive would create a rival consumer set racing on the
        # same queues (and a set stop()'s single sentinel can never
        # reach), so a redundant call is a no-op.  Epoch swaps and
        # per-stage recovery drain/bump generations first, so they are
        # never suppressed by this guard.
        if any(t.is_alive() for t in self._threads):
            return
        n = len(self._stage_fns)
        e = self._epoch
        tag = self.name
        self._reset_recovery_state(n)
        with self._lock:
            gens = [next(self._gen_seq) for _ in range(n)]
            self._stage_gen = gens
        self._threads = [
            threading.Thread(
                target=self._stage0_worker, args=(gens[0],),
                name=f"{tag}-e{e}-stage0", daemon=True,
            )
        ]
        for i in range(1, n):
            self._threads.append(
                threading.Thread(
                    target=self._stage_worker, args=(i, gens[i]),
                    name=f"{tag}-e{e}-stage{i}", daemon=True,
                )
            )
        self._threads.append(
            threading.Thread(
                target=self._egress_worker, name=f"{tag}-e{e}-egress", daemon=True
            )
        )
        for t in self._threads:
            t.start()
        self._start_watchdog()

    # ------------------------------------------------------------- recovery
    def _gen_current(self, si: int, gen: int) -> bool:
        with self._lock:
            return si < len(self._stage_gen) and self._stage_gen[si] == gen

    def _mark_busy(self, si: int, gen: int) -> None:
        with self._lock:
            if si < len(self._stage_gen) and self._stage_gen[si] == gen:
                self._busy_since[si] = time.perf_counter()

    def _mark_idle(self, si: int, gen: int) -> None:
        with self._lock:
            if si < len(self._stage_gen) and self._stage_gen[si] == gen:
                self._busy_since[si] = None

    def _set_processing(self, si: int, gen: int, item: Any) -> None:
        with self._lock:
            if si < len(self._stage_gen) and self._stage_gen[si] == gen:
                self._processing[si] = item

    def _take_redispatch(self, si: int, gen: int) -> Optional[Any]:
        """A replacement worker claims its predecessor's in-flight work.
        The slot stays set until the item is safely forwarded
        (``_clear_processing``), so a crash *during* re-dispatch hands the
        same item to the next replacement — at-least-once."""
        with self._lock:
            if si < len(self._stage_gen) and self._stage_gen[si] == gen:
                return self._processing[si]
        return None

    def _clear_processing(self, si: int, gen: int) -> None:
        recovered = None
        with self._lock:
            if si < len(self._stage_gen) and self._stage_gen[si] == gen:
                self._processing[si] = None
                if self._fault_at[si] is not None:
                    recovered = time.perf_counter() - self._fault_at[si]
                    self._fault_at[si] = None
        if recovered is not None:
            self.metrics.recovery.note_recovered(recovered)

    def _execute(self, si: int, gen: int, fn, env, stream):
        """Run one stage invocation with the transient-retry loop.

        The stage's kernels go on ``stream`` (the worker's own), and the
        call returns only once that stream has finished them, so the
        output env is complete before it is handed on.
        :class:`TransientStageError` retries in place with exponential
        backoff up to ``recovery.max_retries``, then escalates (re-raise
        -> worker restart + re-dispatch).  ``_busy_since`` brackets the
        call so the watchdog sees a heartbeat per invocation."""
        policy = self.recovery
        attempt = 0
        while True:
            self._mark_busy(si, gen)
            try:
                with on_stream(stream):
                    out = fn(self.params, env)
                sync_stream(stream)
                return out
            except TransientStageError:
                attempt += 1
                if policy is None or attempt > policy.max_retries:
                    raise
                self.metrics.recovery.note_retry(si)
                time.sleep(policy.backoff_s(attempt))
            finally:
                self._mark_idle(si, gen)

    def _on_worker_failure(self, si: int, gen: int, error: BaseException) -> None:
        """A stage worker's loop died.  Fail-fast without a recovery
        policy (historical semantics); otherwise restart the stage and
        re-dispatch its in-flight work.  Superseded generations exit
        silently — their failure already belongs to a restarted past."""
        with self._lock:
            stale = not (si < len(self._stage_gen) and self._stage_gen[si] == gen)
            closed = self._closed
        if stale:
            logger.info(
                "server %r: superseded stage-%d worker exited with %r (ignored)",
                self.name, si, error,
            )
            return
        if self.recovery is None or closed:
            self._fail(error)
            return
        self._recover_stage(si, gen, error, stalled=False)

    def _recover_stage(
        self,
        si: int,
        gen: int,
        error: BaseException,
        *,
        stalled: bool,
        old_thread: Optional[threading.Thread] = None,
    ) -> None:
        """Bump the stage's generation and spawn a replacement worker.

        Called from a dying worker (crash / escalated transient) or from
        the watchdog (stall).  The generation check under the lock makes
        concurrent callers race safely: exactly one restarts, the loser
        sees a stale token and returns."""
        policy = self.recovery
        with self._lock:
            if not (si < len(self._stage_gen) and self._stage_gen[si] == gen):
                return  # already recovered by a concurrent path
            if self._closed:
                return
            exhausted = self._restarts[si] >= policy.max_restarts
            if not exhausted:
                self._restarts[si] += 1
                restart_no = self._restarts[si]
                newgen = next(self._gen_seq)
                self._stage_gen[si] = newgen
                self._busy_since[si] = None
                if self._fault_at[si] is None:
                    self._fault_at[si] = time.perf_counter()
        if exhausted:
            exc = ServingError(
                f"stage {si}: max_restarts ({policy.max_restarts}) exhausted"
            )
            exc.__cause__ = error
            self._fail(exc)
            return
        rec = self.metrics.recovery
        rec.note_fault(si, "stall" if stalled else type(error).__name__)
        rec.note_restart(si)
        logger.warning(
            "server %r (epoch %d): stage %d worker %s (%r) — restarting "
            "(restart %d/%d, generation %d)",
            self.name, self._epoch, si,
            "stalled" if stalled else "failed", error,
            restart_no, policy.max_restarts, newgen,
        )
        if stalled and old_thread is not None:
            # The wedged thread stays alive until its stage fn returns; it
            # will notice the stale generation and exit without forwarding.
            self._abandoned.append(old_thread)
        if policy.restart_delay_s > 0:
            time.sleep(policy.restart_delay_s)
        if si == 0:
            target, args = self._stage0_worker, (newgen,)
        else:
            target, args = self._stage_worker, (si, newgen)
        t = threading.Thread(
            target=target, args=args,
            name=f"{self.name}-e{self._epoch}-stage{si}-r{restart_no}",
            daemon=True,
        )
        self._threads[si] = t  # stop()/swap join the replacement, not the corpse
        t.start()

    def _start_watchdog(self) -> None:
        if self.recovery is None or self._watchdog is not None:
            return
        t = threading.Thread(
            target=self._watchdog_loop, name=f"{self.name}-watchdog", daemon=True
        )
        self._watchdog = t
        t.start()

    def _watchdog_loop(self) -> None:
        """Convert silent stalls into detected failures: a stage busy on
        ONE invocation for longer than ``heartbeat_deadline_s`` is
        declared stalled and restarted (its thread abandoned)."""
        deadline = self.recovery.heartbeat_deadline_s
        period = min(max(deadline / 4.0, 0.002), 0.25)
        while not self._watchdog_stop.wait(period):
            with self._lock:
                if self._closed:
                    return
                now = time.perf_counter()
                snap = list(zip(self._busy_since, self._stage_gen))
            ages: Dict[int, float] = {}
            stalled = []
            for si, (busy, gen) in enumerate(snap):
                age = 0.0 if busy is None else now - busy
                ages[si] = age
                if busy is not None and age > deadline:
                    stalled.append((si, gen, age))
            self.metrics.recovery.set_heartbeat_ages(ages)
            for si, gen, age in stalled:
                old = self._threads[si] if si < len(self._threads) else None
                self.metrics.recovery.note_stall(si, age)
                self._recover_stage(
                    si, gen,
                    ServingError(
                        f"stage {si} stalled: heartbeat age {age:.3f}s > "
                        f"watchdog deadline {deadline:.3f}s"
                    ),
                    stalled=True, old_thread=old,
                )

    def start(self) -> "PipelineServer":
        # _submit_lock spans the _started publish AND the spawn: a
        # concurrent swap_plan (which serializes on the same lock) can
        # never observe started=True with no worker threads to drain.
        with self._submit_lock:
            with self._lock:
                if self._started:
                    return self
                if self._closed:
                    raise ServerClosed("server already stopped")
                self._started = True
            self._spawn_workers()
        return self

    def swap_plan(
        self,
        plan: PipelinePlan,
        *,
        warmup: bool = True,
        timeout: float = 60.0,
    ) -> "PipelineServer":
        """Hot-swap the stage->layer allocation (drain-and-switch epochs).

        The re-planner's runtime half: adopt a new :class:`PipelinePlan`
        on a live server without dropping a single in-flight ticket.
        Protocol (each server generation is an *epoch*):

        1. **Prepare** (concurrent with serving): build and, by default,
           warm the new epoch's stage functions — warmup runs while the
           old epoch keeps draining traffic.
        2. **Seal** the ingress: take ``_submit_lock`` so new ``submit()``
           calls block (they queue behind the swap, they are never
           dropped) and the old epoch's image set is frozen.
        3. **Drain**: send the shutdown sentinel through the old workers;
           every image admitted before the seal flows through the *old*
           plan to its ticket.  Old workers then exit and are joined.
        4. **Switch**: install the new plan/stage functions/queues, roll
           the per-stage metrics to a new epoch (end-to-end counters
           persist), spawn the new workers, release the seal.

        Raises :class:`ServerClosed` if the server was stopped, and
        re-raises the worker error if the old epoch failed while
        draining.  Returns ``self``.
        """
        n_layers = sum(len(s) for s in self.plan.allocation)
        flat = [l for stage_layers in plan.allocation for l in stage_layers]
        if flat != list(range(n_layers)):
            raise ValueError(
                f"new plan must partition layers 0..{n_layers - 1} in order, "
                f"got {plan.notation()}"
            )
        # 1. Prepare off-line: warm the next epoch while the old one runs.
        new_fns = self._stage_fn_builder(self.graph, plan)
        if warmup:
            self._warm(new_fns)
        self._sealed = True  # non-blocking submits shed instantly from here
        try:
            with self._submit_lock:  # 2. seal: submits queue behind the swap
                with self._lock:
                    if self._closed:
                        raise ServerClosed("server is closed") from self._error
                    started = self._started
                if started:
                    # 3. drain the old epoch completely — under a deadline:
                    # a wedged stage 0 leaves the ingress full forever, and
                    # the old blocking put would deadlock the swap with the
                    # submit lock held.  Fail loudly instead.
                    drain_deadline = time.perf_counter() + timeout
                    try:
                        self._ingress.put(_SENTINEL, timeout=timeout)
                    except queue.Full:
                        err = ServingError(
                            f"server {self.name!r}: swap drain could not even "
                            f"enqueue its sentinel within {timeout:.1f}s — "
                            "ingress full and stage 0 wedged"
                        )
                        self._fail(err)
                        raise err
                    # _recover_stage may replace entries concurrently (a
                    # crash during the drain restarts the stage, and the
                    # REPLACEMENT finishes the drain) — so keep joining the
                    # live list until it is quiet or the deadline expires.
                    while True:
                        for t in list(self._threads):
                            t.join(
                                timeout=max(
                                    0.0, drain_deadline - time.perf_counter()
                                )
                            )
                        alive = [t for t in self._threads if t.is_alive()]
                        if not alive or time.perf_counter() >= drain_deadline:
                            break
                    wedged = [t.name for t in alive]
                    if wedged:
                        # Can't switch under a live old epoch; don't leave a
                        # zombie either (accepting submits nobody consumes) —
                        # close the server and fail the in-flight tickets.
                        err = ServingError(
                            f"server {self.name!r}: old epoch failed to drain "
                            f"before swap (deadline {timeout:.1f}s; wedged: "
                            f"{', '.join(wedged)})"
                        )
                        self._fail(err)
                        raise err
                    if self._error is not None:  # old epoch died while draining
                        raise self._error
                # 4. switch
                self.plan = plan
                self._stage_fns = new_fns
                self._qs = [
                    queue.Queue(maxsize=self.queue_depth) for _ in range(len(new_fns))
                ]
                self._epoch += 1
                self.metrics.new_epoch(self._stage_names(plan))
                if started:
                    self._spawn_workers()
                else:
                    self._reset_recovery_state(len(new_fns))
        finally:
            self._sealed = False
        self._persist_plan()
        return self

    def _persist_plan(self) -> None:
        """Save the active plan as the last-known-good (best effort: a
        persistence error must never fail serving — it is logged)."""
        store = self.plan_store
        if store is None:
            return
        try:
            store.save_server(self)
        except Exception:  # noqa: BLE001 — persistence is best-effort
            logger.exception(
                "server %r: last-known-good plan persistence failed "
                "(serving continues)", self.name,
            )

    def stop(self, timeout: float = 10.0) -> None:
        """Flush in-flight work, then shut the workers down.

        Idempotent; re-raises the first worker error if the pipeline
        failed (so a crash can't be silently absorbed by shutdown).

        ``timeout`` is a hard deadline for the whole drain.  A wedged
        (stalled) worker used to deadlock this path forever — first on
        the blocking sentinel put when the ingress was full, then
        silently on the joins.  Now the sentinel put is bounded and any
        worker still alive past the deadline raises a
        :class:`ServingError` naming the wedged stage thread(s), so a
        hung pipeline is loud at shutdown instead of hanging the caller.
        """
        if self.monitor is not None:
            self.monitor.stop()
        self._watchdog_stop.set()
        with self._lock:
            already_closed = self._closed
            self._closed = True
            started = self._started
        deadline = time.perf_counter() + timeout
        if started:
            if not already_closed:
                with self._submit_lock:  # after any in-progress submit's put
                    try:
                        self._ingress.put(_SENTINEL, timeout=timeout)
                    except queue.Full:
                        # Stage 0 is wedged behind a full ingress: nothing
                        # can drain.  Fall through — the join deadline below
                        # names the stalled stage.
                        pass
            for t in list(self._threads):  # also reaps workers after a failure
                t.join(timeout=max(0.0, deadline - time.perf_counter()))
        if self._error is not None:
            raise self._error
        # A dead adaptive loop must be as loud as a dead worker: if the
        # monitor gave up on an error (and no worker error explains it),
        # surface it here rather than let adaptation fail silently.
        monitor_error = getattr(self.monitor, "error", None)
        if monitor_error is not None:
            raise ServingError("adaptive monitor failed") from monitor_error
        if started:
            wedged = [t.name for t in self._threads if t.is_alive()]
            if wedged:
                raise ServingError(
                    f"server {self.name!r}: stop() deadline ({timeout:.1f}s) "
                    f"expired with wedged worker(s): {', '.join(wedged)} — "
                    "stage stalled; in-flight tickets remain unresolved"
                )

    def crash(self, reason: Optional[BaseException] = None) -> None:
        """Simulate an abrupt server death (power loss, kernel panic).

        Unlike :meth:`stop`, nothing is flushed: the server closes
        immediately, every in-flight ticket FAILS, and the workers are
        poisoned.  A later :meth:`stop` re-raises the crash reason (the
        same contract as any worker failure)."""
        self._watchdog_stop.set()
        self._fail(
            reason
            if reason is not None
            else ServingError(f"server {self.name!r}: simulated crash")
        )

    def __enter__(self) -> "PipelineServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.stop()
        else:  # don't mask the caller's exception with a flush error
            try:
                self.stop()
            except Exception:
                logger.exception(
                    "server %r: stop() raised while unwinding %s (absorbed "
                    "so the caller's original exception propagates)",
                    self.name, exc_type.__name__,
                )

    def _warm(self, fns) -> None:
        env = {
            "input": torch.zeros(
                (self.batch_size, *self.graph.input_shape), device=self.device
            )
        }
        for fn in fns:
            env = fn(self.params, env)
        synchronize(self.device)

    def warmup(self) -> None:
        """Run every stage once at the padded micro-batch shape (loads the
        kernels, sizes the allocator's pools and, on the card, captures
        each stage's CUDA graph before traffic)."""
        self._warm(self._stage_fns)

    # ------------------------------------------------- live batching control
    def ingress_depth(self) -> int:
        """Images currently waiting in the ingress queue (approximate —
        the stage-0 worker drains concurrently); the queue-state signal
        the admission controller converts into a predicted wait."""
        return self._ingress.qsize()

    def set_batching(
        self,
        batch_size: Optional[int] = None,
        flush_timeout_s: Optional[float] = None,
    ) -> None:
        """Adapt the batching policy live — the queue-aware controller's
        knobs.  Both are read fresh by the stage-0 gather loop each
        micro-batch, so no restart or epoch swap is needed: a smaller
        flush timeout trades batching efficiency for latency when the
        queue is shallow; a larger batch amortizes per-batch overhead
        when utilization climbs.  A batch-size change takes effect at the
        next micro-batch, at the new padded shape.
        """
        if batch_size is not None:
            if batch_size < 1:
                raise ValueError(f"batch_size {batch_size} < 1")
            self.batch_size = int(batch_size)
        if flush_timeout_s is not None:
            if flush_timeout_s < 0.0:
                raise ValueError(f"flush_timeout_s {flush_timeout_s} < 0")
            self.flush_timeout_s = float(flush_timeout_s)

    # -------------------------------------------------------------- ingress
    def submit(
        self,
        image: Union[np.ndarray, torch.Tensor],
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> Ticket:
        """Enqueue one image; returns a :class:`Ticket` future.

        With ``block=False`` (or a ``timeout``) a full pipeline raises
        :class:`Backpressure` instead of waiting — the caller sheds load.
        """
        if not self._started and not self._closed:
            self.start()
        x = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        if self.device.type == "cuda":
            # the copy ran on this thread's stream; finish it before a
            # stage stream reads the image
            torch.cuda.current_stream(self.device).synchronize()
        if x.ndim == len(self.graph.input_shape):
            x = x[None]
        if x.shape != (1, *self.graph.input_shape):
            raise ValueError(
                f"submit() takes ONE image of shape {self.graph.input_shape} "
                f"(optionally with a leading batch dim of 1), got {x.shape}; "
                "the server forms micro-batches itself"
            )
        now = time.perf_counter()
        ticket = Ticket(submitted_at=now)
        # Honour the non-blocking/timeout contract on the submit lock too:
        # during a swap_plan drain the lock is held for the whole drain, and
        # a submit(block=False) / submit(timeout=...) must shed load rather
        # than stall behind it.  Ordinary peer submits hold the lock only
        # microseconds, so a short bounded acquire absorbs that contention
        # without spurious Backpressure.
        if block:
            acquired = self._submit_lock.acquire(
                timeout=-1 if timeout is None else timeout
            )
        elif self._sealed:
            acquired = False  # drain in progress: shed with zero wait
        else:
            acquired = self._submit_lock.acquire(timeout=0.05)
        if not acquired:
            raise Backpressure(
                "pipeline busy (plan swap or shutdown in progress)"
            )
        try:
            with self._lock:
                if self._closed or self._error is not None:
                    raise ServerClosed("server is closed") from self._error
                self._inflight.add(ticket)
            if timeout is not None:
                timeout = max(0.0, timeout - (time.perf_counter() - now))
            try:
                self._ingress.put((ticket, x), block=block, timeout=timeout)
            except queue.Full:
                with self._lock:
                    self._inflight.discard(ticket)
                raise Backpressure(
                    f"ingress full ({self._ingress.maxsize} images) — pipeline "
                    "saturated"
                ) from None
        finally:
            self._submit_lock.release()
        # close the submit()/_fail() race: if a worker failed while we were
        # enqueueing, nothing will ever consume the item — fail the ticket
        # now instead of letting the caller block until timeout
        with self._lock:
            raced = self._error is not None and ticket in self._inflight
            if raced:
                self._inflight.discard(ticket)
        if raced:
            ticket._fail(ServingError(f"pipeline worker failed: {self._error!r}"))
            raise ServerClosed("server is closed") from self._error
        self.metrics.note_submit(now)
        return ticket

    def run(self, images: Sequence[Union[np.ndarray, torch.Tensor]]) -> Dict[str, Any]:
        """Convenience closed loop: submit a stream, wait for every result.

        Returns the same shape of dict as the one-shot engines, plus a
        metrics snapshot; callable repeatedly — workers persist between
        calls (that persistence is the point of this class).
        """
        t0 = time.perf_counter()
        tickets = [self.submit(img) for img in images]
        outputs = [t.result(timeout=300.0) for t in tickets]
        dt = time.perf_counter() - t0
        return {
            "outputs": outputs,
            "seconds": dt,
            "throughput": len(images) / dt,
            "stages": self.plan.pipeline.notation(),
            "metrics": self.metrics.snapshot(),
        }

    # -------------------------------------------------------------- workers
    def _forward(
        self,
        q: "queue.Queue",
        item: Any,
        si: Optional[int] = None,
        gen: Optional[int] = None,
    ) -> bool:
        """Bounded put that aborts when a peer worker has failed (or, for
        generation-tagged callers, when this worker has been superseded),
        so no worker can block forever on a queue whose consumer is dead."""
        while True:
            if self._error is not None:
                return False
            if gen is not None and not self._gen_current(si, gen):
                return False  # superseded: the replacement owns the stream
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue

    def _stage0_worker(self, gen: int) -> None:
        fn = self._stage_fns[0]
        m = self.metrics.stages[0]
        qs = self._qs  # epoch-bound: a zombie must not touch new queues
        try:
            stream = stage_stream(self.device)
            redo = self._take_redispatch(0, gen)
            if redo is not None:
                self.metrics.recovery.note_redispatch(len(redo))
            while True:
                if redo is not None:
                    items, eof = redo, False
                    redo = None
                else:
                    items, eof = gather(
                        self._ingress, self.batch_size, self.flush_timeout_s,
                        _SENTINEL,
                    )
                    if items:
                        self._set_processing(0, gen, items)
                if items:
                    t0 = time.perf_counter()
                    tickets = tuple(t for t, _ in items)
                    for t in tickets:
                        if t.dequeued_at is None:  # not restamped on re-dispatch
                            t.dequeued_at = t0
                            self.metrics.note_dequeue(t.submitted_at, t0)
                    with on_stream(stream):
                        env = stack_envs(
                            [{"input": x} for _, x in items], pad_to=self.batch_size
                        )
                    # materialize before handing off: the stage boundary is
                    # where the activation crosses clusters in the paper
                    out = self._execute(0, gen, fn, env, stream)
                    t1 = time.perf_counter()
                    if not self._gen_current(0, gen):
                        return  # declared stalled; replacement re-dispatched
                    if m.started_at is None:
                        m.started_at = t0
                    m.stopped_at = t1
                    m.record(t1 - t0, len(items), self.batch_size - len(items))
                    ok = self._forward(
                        qs[0], MicroBatch(tickets, out, valid=len(items)), 0, gen
                    )
                    self._clear_processing(0, gen)
                    if not ok:
                        return
                if eof:
                    self._forward(qs[0], _SENTINEL, 0, gen)
                    return
        except BaseException as e:
            self._on_worker_failure(0, gen, e)

    def _stage_worker(self, si: int, gen: int) -> None:
        fn = self._stage_fns[si]
        m = self.metrics.stages[si]
        qs = self._qs  # epoch-bound: a zombie must not touch new queues
        try:
            stream = stage_stream(self.device)
            item = self._take_redispatch(si, gen)
            if item is not None:
                self.metrics.recovery.note_redispatch(item.valid)
            while True:
                if item is None:
                    item = qs[si - 1].get()
                    if item is _SENTINEL:
                        self._forward(qs[si], _SENTINEL, si, gen)
                        return
                    self._set_processing(si, gen, item)
                t0 = time.perf_counter()
                out = self._execute(si, gen, fn, item.env, stream)
                t1 = time.perf_counter()
                if not self._gen_current(si, gen):
                    return  # declared stalled; replacement re-dispatched
                if m.started_at is None:
                    m.started_at = t0
                m.stopped_at = t1
                m.record(t1 - t0, item.valid, item.padded)
                ok = self._forward(
                    qs[si], MicroBatch(item.tickets, out, valid=item.valid), si, gen
                )
                self._clear_processing(si, gen)
                if not ok:
                    return
                item = None
        except BaseException as e:
            self._on_worker_failure(si, gen, e)

    def _egress_worker(self) -> None:
        try:
            while True:
                item = self._qs[-1].get()
                if item is _SENTINEL:
                    return
                (out,) = item.env.values()  # last stage prunes to the output
                now = time.perf_counter()
                for ticket, row in zip(item.tickets, split_rows(out, item.valid)):
                    if ticket.done():
                        # At-least-once re-dispatch raced a stalled worker's
                        # late result: the ticket already resolved with an
                        # identical row (stage fns are pure) — suppress the
                        # duplicate so clients see each output exactly once.
                        self.metrics.recovery.note_duplicate()
                        with self._lock:
                            self._inflight.discard(ticket)
                        continue
                    self.metrics.note_complete(ticket.submitted_at, now)
                    with self._lock:
                        self._inflight.discard(ticket)
                    ticket._resolve(row)
        except BaseException as e:
            self._fail(e)

    # -------------------------------------------------------------- failure
    def _fail(self, error: BaseException) -> None:
        """A worker died: close the server, fail every pending ticket, and
        poison every queue so all peer workers exit."""
        with self._lock:
            first = self._error is None
            if first:
                self._error = error
            self._closed = True
            pending = list(self._inflight)
            self._inflight.clear()
        if first:  # loud at the moment of death, not only on stop()
            logger.error(
                "server %r (epoch %d): pipeline worker failed, closing and "
                "failing %d in-flight ticket(s)",
                self.name, self._epoch, len(pending), exc_info=error,
            )
        reason = ServingError(f"pipeline worker failed: {error!r}")
        for t in pending:
            t._fail(reason)
        # Unblock any submit() stuck on a full ingress queue; the drained
        # images never reached stage 0, so their tickets fail here (they
        # were also in _inflight above — Ticket._fail is idempotent).
        try:
            while True:
                item = self._ingress.get_nowait()
                if item is not _SENTINEL:
                    item[0]._fail(reason)
        except queue.Empty:
            pass
        # Poison EVERY queue (after the drain, so the ingress sentinel
        # survives): workers sit in bare get() calls and would otherwise
        # block forever.  A full inter-stage queue is fine — its consumer
        # is awake and will observe _error via _forward/gather.
        for q in (self._ingress, *self._qs):
            try:
                q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
