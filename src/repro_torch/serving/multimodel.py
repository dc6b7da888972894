"""Multi-model co-serving: one machine, several CNNs, disjoint core shares.

Pipe-it treats the big.LITTLE cluster as a partitionable resource and
splits *layers* across core groups (Eq. 12).  A production edge box never
serves one CNN (PICO 2206.08662, Synergy 1804.00706), so this module
applies the same insight one level up: :func:`repro_torch.core.dse.
partition_search` first partitions *clusters across models*, then
partitions *layers within each share* — and the runtime here executes
that two-level plan:

* :class:`MultiModelServer` — one :class:`~repro_torch.serving.server.
  PipelineServer` worker set per model, each on its assigned share,
  behind a single front-end router.  The router owns per-model admission
  control (an in-flight bound per model on top of each pipeline's bounded
  queues — an overloaded model sheds ITS OWN traffic instead of starving
  its neighbours) and per-model metrics
  (:class:`~repro_torch.serving.metrics.RouterMetrics` + each server's
  :class:`~repro_torch.serving.metrics.ServerMetrics`).
* :class:`PartitionController` — the multi-model belief state: one
  :class:`~repro_torch.serving.adaptive.OnlineCalibrator` +
  :class:`~repro_torch.serving.adaptive.DriftDetector` per co-resident model.
  Drift confirmed in ANY model triggers a *global* re-partition
  (``partition_search`` on all calibrated matrices): one model slowing
  down changes the optimal share split for everyone.
* :class:`MultiModelMonitor` — the runtime attachment: a daemon thread
  samples every model's stage counters
  (:class:`~repro_torch.serving.adaptive.ServerSampler` each), steps the
  controller, and hot-swaps the whole partition via
  :meth:`MultiModelServer.swap_partition` — each inner server's epoch
  protocol guarantees no in-flight ticket is dropped.

Construction is usually via :func:`repro_torch.serving.planner.serve` with a
dict of models (or :meth:`AutoPlanner.build_multi`), which also threads
one shared :class:`~repro_torch.kernels.autotune.ConvAutotuner` cache through
every model's route measurements.

The port's copy of ``repro/serving/multimodel.py``, on the port's own
``core/``, ``adaptive`` and ``server``.  It differs in the device alone:
:class:`MultiModelServer` takes ``device=`` (``None`` means the card) and
hands it to every inner server.  On the card the inner servers share it:
each stage worker issues its kernels on a stream of its own, warm-up and
every inner ``swap_plan`` capture their stage graphs one at a time
(``kernels/graphs.py``), and a swap or its rollback re-captures only the
models whose plan changes.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Any, Deque, Dict, List, Mapping, Optional, Sequence, Union

from ..core.dse import (
    PartitionPlan,
    evaluate_frequencies,
    partition_objective,
    partition_search,
)
from ..core.pipeline import TimeMatrix
from ..core.plan import Availability, evaluate
from ..core.platform import HeteroPlatform
from ..kernels.config import resolve_device
from .adaptive import (
    AdaptiveConfig,
    DriftDetector,
    OnlineCalibrator,
    ServerSampler,
    StageObservation,
)
from .faults import RecoveryPolicy
from .metrics import RouterMetrics
from .registry import ModelRegistry
from .server import (
    Backpressure,
    PipelineServer,
    ServerClosed,
    ServingError,
    Ticket,
)

# Absorbed-by-design failure sites (context-manager unwinding, rollback of
# a broken server) log here instead of passing silently — see the matching
# policy note in serving/server.py.
logger = logging.getLogger(__name__)

__all__ = [
    "AdmissionError",
    "MultiModelServer",
    "PartitionController",
    "PartitionEvent",
    "MultiModelMonitor",
    "attach_partition_adaptive",
]


class AdmissionError(Backpressure):
    """The router refused the request: the model's in-flight bound is hit."""


class MultiModelServer:
    """Co-serving runtime for a :class:`PartitionPlan`.

    Parameters
    ----------
    registry : the co-resident models (graphs, params, weights, SLOs).
    partition : cluster-share assignment + per-model inner plans
        (:func:`repro_torch.core.dse.partition_search`).
    batch_size, flush_timeout_s, queue_depth : per inner server, as in
        :class:`~repro_torch.serving.server.PipelineServer`.
    max_inflight : per-model admission bound — an int (same bound for
        every model) or ``{model: bound}``; ``None`` disables router-level
        admission (each pipeline's bounded queues still push back).
    stage_fn_builders : optional ``{model: (graph, plan) -> [stage_fn]}``
        overrides (fake-stage benchmarks and the stress tests).
    backend : kernel execution backend spec shared by every model's stage
        executables; pass a resolved ``KernelBackend`` to share tuner
        state across models.
    tuner : the shared :class:`~repro_torch.kernels.autotune.ConvAutotuner`
        whose route cache planned this partition (kept for re-planning).
    device : where every model's stages run and its params live; ``None``
        means the card (and raises on a host without CUDA).
    """

    def __init__(
        self,
        registry: ModelRegistry,
        partition: PartitionPlan,
        *,
        batch_size: int = 1,
        flush_timeout_s: float = 0.01,
        queue_depth: int = 2,
        max_inflight: Union[None, int, Mapping[str, int]] = None,
        stage_fn_builders: Optional[Mapping[str, Any]] = None,
        backend=None,
        tuner=None,
        fairness: str = "sum",
        recovery: Optional[RecoveryPolicy] = None,
        device=None,
    ):
        missing = [n for n in partition.names if n not in registry]
        if missing:
            raise ValueError(f"partition names models the registry lacks: {missing}")
        if len(partition.names) != len(registry):
            raise ValueError(
                f"partition covers {partition.names}, registry has {registry.names}"
            )
        self.device = resolve_device(device)
        self.registry = registry
        self.partition = partition
        self.tuner = tuner
        # the objective this partition was searched under; the adaptive
        # re-partition loop re-plans under the SAME objective by default
        self.fairness = fairness
        if max_inflight is None:
            self._max_inflight: Dict[str, Optional[int]] = {
                n: None for n in partition.names
            }
        elif isinstance(max_inflight, int):
            if max_inflight < 1:
                raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
            self._max_inflight = {n: max_inflight for n in partition.names}
        else:
            unknown = [n for n in max_inflight if n not in registry]
            if unknown:  # a typo'd name must not silently disable the bound
                raise ValueError(
                    f"max_inflight names unknown models {unknown}; "
                    f"serving {registry.names}"
                )
            bad = {n: b for n, b in max_inflight.items() if b is not None and b < 1}
            if bad:
                raise ValueError(f"max_inflight bounds must be >= 1, got {bad}")
            self._max_inflight = {
                n: max_inflight.get(n) for n in partition.names
            }
        builders = dict(stage_fn_builders or {})
        self.recovery = recovery
        self.servers: Dict[str, PipelineServer] = {}
        for mp in partition.assignments:
            entry = registry[mp.name]
            self.servers[mp.name] = PipelineServer(
                entry.graph,
                entry.params,
                mp.plan,
                batch_size=batch_size,
                flush_timeout_s=flush_timeout_s,
                queue_depth=queue_depth,
                stage_fn_builder=builders.get(mp.name),
                backend=backend,
                name=f"mm-{mp.name}",
                recovery=recovery,
                device=self.device,
            )
        self.router = RouterMetrics(partition.names)
        self.monitor: Optional["MultiModelMonitor"] = None
        # Last-known-good persistence (serving/persistence.py): set by
        # ``serve(plan_store=...)``; saved after every successful swap.
        self.plan_store = None
        self.partition_epoch = 0
        self._swap_lock = threading.Lock()
        # Admission bookkeeping: the router counts its own admitted
        # in-flight load per model — reserved atomically with the bound
        # check, released by each ticket's done-callback — so the bound
        # is exact under concurrent clients (never exceeded, never a
        # spurious reject while a slot is free).
        self._admission_lock = {n: threading.Lock() for n in partition.names}
        self._admitted_inflight = {n: 0 for n in partition.names}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MultiModelServer":
        for srv in self.servers.values():
            srv.start()
        return self

    def warmup(self) -> None:
        for srv in self.servers.values():
            srv.warmup()

    def stop(self, timeout: float = 10.0) -> None:
        """Shut down the monitor, then every model's pipeline.

        Every server is stopped even if one fails; the first failure is
        re-raised (matching ``PipelineServer.stop`` semantics)."""
        if self.monitor is not None:
            self.monitor.stop()
        first: Optional[BaseException] = None
        for srv in self.servers.values():
            try:
                srv.stop(timeout=timeout)
            except BaseException as e:  # noqa: BLE001 — keep stopping peers
                # an interrupt (Ctrl-C / interpreter shutdown) outranks any
                # earlier serving error: it must reach the caller, not the log
                if first is None or (
                    isinstance(e, (KeyboardInterrupt, SystemExit))
                    and not isinstance(first, (KeyboardInterrupt, SystemExit))
                ):
                    first = e
        if first is not None:
            raise first
        # Parity with PipelineServer.stop(): a control loop that died on an
        # error must be as loud as a dead worker.
        monitor_error = getattr(self.monitor, "error", None)
        if monitor_error is not None:
            raise ServingError("partition monitor failed") from monitor_error

    def __enter__(self) -> "MultiModelServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.stop()
        else:  # don't mask the caller's exception with a shutdown error
            try:
                self.stop()
            except Exception:
                logger.exception(
                    "multi-model server [models=%s, epoch=%d, inflight=%d]: "
                    "stop() raised while unwinding %s (absorbed so the "
                    "caller's original exception propagates)",
                    ",".join(sorted(self.servers)) or "<none>",
                    self.partition_epoch,
                    sum(self._admitted_inflight.values()),
                    exc_type.__name__,
                )

    # -------------------------------------------------------------- routing
    def server(self, model: str) -> PipelineServer:
        try:
            return self.servers[model]
        except KeyError:
            raise KeyError(
                f"unknown model {model!r}; serving {sorted(self.servers)}"
            ) from None

    def submit(
        self,
        model: str,
        image,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> Ticket:
        """Route one image to ``model``'s pipeline.

        Admission control runs BEFORE the pipeline sees the request: if
        the model's in-flight bound is hit, :class:`AdmissionError` is
        raised immediately (regardless of ``block`` — the bound is a
        policy decision, not transient congestion).  Pipeline
        backpressure (:class:`~repro_torch.serving.server.Backpressure`) still
        applies under the bound and honours ``block``/``timeout``.
        """
        srv = self.server(model)
        limit = self._max_inflight.get(model)
        if limit is not None:
            # check-and-reserve atomically vs. peer submits; the slot is
            # released when the ticket resolves/fails (done-callback) or
            # when the pipeline refuses the hand-off below
            with self._admission_lock[model]:
                if self._admitted_inflight[model] >= limit:
                    self.router.note_reject(model)
                    raise AdmissionError(
                        f"model {model!r} at its in-flight bound ({limit})"
                    )
                self._admitted_inflight[model] += 1
        try:
            ticket = srv.submit(image, block=block, timeout=timeout)
        except BaseException as e:
            if limit is not None:
                self._release_admission(model)
            if isinstance(e, Backpressure):
                self.router.note_reject(model)
            raise
        if limit is not None:
            ticket.add_done_callback(
                lambda _t, m=model: self._release_admission(m)
            )
        self.router.note_admit(model)
        return ticket

    def _release_admission(self, model: str) -> None:
        with self._admission_lock[model]:
            self._admitted_inflight[model] -= 1

    def run(
        self, streams: Mapping[str, Sequence[Any]], timeout: float = 300.0
    ) -> Dict[str, Any]:
        """Convenience closed loop: interleave every stream round-robin,
        wait for every result.  Owning both ends of the loop, it absorbs
        its own admission rejections and pipeline backpressure by
        retrying once capacity frees up (the rejections still show in
        ``RouterMetrics``).  ``timeout`` bounds the WHOLE call — submit
        phase and result collection share one deadline, so a stalled
        pipeline fails at ~timeout rather than hanging or compounding
        per-ticket budgets."""
        unknown = [n for n in streams if n not in self.servers]
        if unknown:
            raise KeyError(f"unknown models {unknown}; serving {sorted(self.servers)}")
        t0 = time.perf_counter()
        deadline = t0 + timeout
        tickets: Dict[str, List[Ticket]] = {n: [] for n in streams}
        cursors = {n: 0 for n in streams}
        remaining = sum(len(v) for v in streams.values())
        while remaining:
            stalled = remaining
            for name, images in streams.items():
                i = cursors[name]
                if i < len(images):
                    try:
                        # bounded attempt so one full pipeline can't
                        # starve the round-robin over its siblings
                        tickets[name].append(
                            self.submit(name, images[i], timeout=0.05)
                        )
                    except Backpressure:  # incl. AdmissionError: retry later
                        continue
                    cursors[name] = i + 1
                    remaining -= 1
            if remaining == stalled:
                if time.perf_counter() > deadline:
                    raise Backpressure(
                        "run() could not drain the streams before timeout "
                        "(pipelines full or max_inflight bound never freed up)"
                    )
                time.sleep(0.001)  # admission rejects are instant: don't spin
        # one shared deadline for the whole call, not a fresh budget per
        # ticket — a stalled pipeline fails at ~timeout, not n_tickets x it
        outputs = {
            name: [
                t.result(timeout=max(0.0, deadline - time.perf_counter()))
                for t in ts
            ]
            for name, ts in tickets.items()
        }
        dt = time.perf_counter() - t0
        total = sum(len(v) for v in streams.values())
        return {
            "outputs": outputs,
            "seconds": dt,
            "throughput": total / dt,
            "per_model": {
                name: {
                    "images": len(ts),
                    "plan": self.partition[name].plan.notation(),
                }
                for name, ts in tickets.items()
            },
            "metrics": self.metrics(),
        }

    # ------------------------------------------------------------- swapping
    def swap_partition(
        self, partition: PartitionPlan, *, timeout: float = 60.0
    ) -> "MultiModelServer":
        """Hot-swap to a new global partition without dropping a ticket.

        Per-model plans that actually changed are swapped via each inner
        server's drain-and-switch epoch protocol; unchanged models keep
        serving untouched.  Serialized against concurrent swaps.

        The swap is all-or-nothing from the caller's view: if model N's
        swap fails after models 1..N-1 already switched, those models are
        swapped BACK to their old plans before the error re-raises, so
        ``self.partition`` always describes what is actually running (the
        controller's belief revert in :class:`MultiModelMonitor` depends
        on exactly this).  A rollback can only fail if that server is
        already broken — and then its own error surfaces via ``stop()``.
        """
        if sorted(partition.names) != sorted(self.partition.names):
            raise ValueError(
                f"new partition covers {partition.names}, "
                f"server runs {self.partition.names}"
            )
        with self._swap_lock:
            swapped: List[str] = []
            try:
                for mp in partition.assignments:
                    srv = self.servers[mp.name]
                    if mp.plan != srv.plan:
                        srv.swap_plan(mp.plan, timeout=timeout)
                        swapped.append(mp.name)
            except BaseException as swap_err:
                # A Ctrl-C / interpreter-shutdown interrupt — whether it WAS
                # the swap error or fires mid-rollback — must reach the
                # caller after the rollback completes, never be swallowed
                # into the unwind log as if it were a broken server.
                interrupt: Optional[BaseException] = (
                    swap_err
                    if isinstance(swap_err, (KeyboardInterrupt, SystemExit))
                    else None
                )
                for name in reversed(swapped):  # restore the running truth
                    try:
                        self.servers[name].swap_plan(
                            self.partition[name].plan, timeout=timeout
                        )
                    except (KeyboardInterrupt, SystemExit) as e:
                        logger.exception(
                            "swap_partition rollback for model %r interrupted "
                            "(re-raised after the remaining rollbacks)", name,
                        )
                        if interrupt is None:
                            interrupt = e
                    except BaseException:  # noqa: BLE001 — server is broken;
                        # its worker error resurfaces on stop(); log now so
                        # the rollback failure is visible at the moment the
                        # partition diverged from self.partition
                        logger.exception(
                            "swap_partition rollback failed for model %r "
                            "(server broken; original swap error re-raised, "
                            "worker error will resurface on stop())", name,
                        )
                if interrupt is not None and interrupt is not swap_err:
                    raise interrupt from swap_err
                raise
            self.partition = partition
            self.partition_epoch += 1
        self._persist_partition()
        return self

    def _persist_partition(self) -> None:
        """Save the running partition as last-known-good (best effort: a
        persistence error must never fail serving — it is logged)."""
        store = self.plan_store
        if store is None:
            return
        try:
            store.save_server(self)
        except Exception:  # noqa: BLE001 — persistence is best-effort
            logger.exception(
                "multi-model server: last-known-good partition persistence "
                "failed (serving continues)"
            )

    # -------------------------------------------------------------- metrics
    @property
    def inflight(self) -> Dict[str, int]:
        return {name: srv.inflight for name, srv in self.servers.items()}

    def metrics(self) -> Dict[str, Any]:
        """Router + per-model pipeline metrics + the aggregate rates the
        partition objective optimises."""
        models = {
            name: srv.metrics.snapshot() for name, srv in self.servers.items()
        }
        return {
            "partition": self.partition.notation(),
            "partition_epoch": self.partition_epoch,
            "router": self.router.snapshot(),
            "models": models,
            "completed": sum(m["completed"] for m in models.values()),
            "aggregate_throughput_img_s": sum(
                srv.metrics.throughput() for srv in self.servers.values()
            ),
        }


# ---------------------------------------------------------------------------
# Global re-partitioning: the multi-model control loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartitionEvent:
    """One controller decision that re-ran the partition DSE."""

    round: int
    triggered_by: tuple  # model names whose drift confirmed
    old_partition: PartitionPlan
    new_partition: PartitionPlan
    predicted_gain: float  # new/old aggregate objective on calibrated Ts
    swapped: bool


class PartitionController:
    """Calibrate every model -> detect drift in any -> re-partition all.

    The single-model :class:`~repro_torch.serving.adaptive.AdaptiveController`
    re-balances layers within a fixed machine; this controller owns the
    level above: per-model calibrated beliefs, and on any model's
    confirmed drift a global :func:`~repro_torch.core.dse.partition_search`
    over all calibrated matrices.  The swap test compares *aggregate
    objectives* (weighted throughputs + SLO penalties), so a re-partition
    that helps one model at a disproportionate cost to its neighbours is
    rejected.
    """

    def __init__(
        self,
        priors: Mapping[str, TimeMatrix],
        partition: PartitionPlan,
        platform: HeteroPlatform,
        *,
        weights: Optional[Mapping[str, float]] = None,
        slo_rates: Optional[Mapping[str, float]] = None,
        mode: str = "best",
        config: Optional[AdaptiveConfig] = None,
        exact_threshold: int = 8,
        fairness: str = "sum",
        power_cap_w: Optional[float] = None,
        power_objective: str = "throughput",
    ):
        if sorted(priors) != sorted(partition.names):
            raise ValueError("priors must cover exactly the partition's models")
        self.config = config or AdaptiveConfig()
        self.platform = platform
        self.mode = mode
        self.exact_threshold = exact_threshold
        self.fairness = fairness
        # DVFS dimension: re-partitions run the power-aware inner search
        # under the machine cap; a throttle event updates the cap via
        # throttle() and re-partitions unconditionally.
        self.power_cap_w = power_cap_w
        self.power_objective = power_objective
        self.weights = dict(weights or {})
        self.slo_rates = dict(slo_rates or {})
        self.partition = partition
        self.calibrators = {
            name: OnlineCalibrator(priors[name], alpha=self.config.alpha)
            for name in partition.names
        }
        self.detectors = {
            name: DriftDetector(
                threshold=self.config.threshold, patience=self.config.patience
            )
            for name in partition.names
        }
        # What each model's current plan was planned against — drift is
        # measured relative to these, not the moving calibrated belief.
        self.T_planned: Dict[str, TimeMatrix] = {
            name: self.calibrators[name].matrix() for name in partition.names
        }
        self.rounds = 0
        self.swaps = 0
        self.history: Deque[PartitionEvent] = collections.deque(maxlen=256)
        # Degraded-mode state (cluster loss): mirrors the single-model
        # AdaptiveController — ``platform`` is what the partition DSE may
        # carve up, the surviving subset while degraded.
        self.full_platform = platform
        self.lost: Dict[str, int] = {}
        self._pre_degrade: Optional[PartitionPlan] = None

    @property
    def degraded(self) -> bool:
        return self._pre_degrade is not None

    def degrade(self, lost: Mapping[str, int]) -> PartitionPlan:
        """Permanent core loss: re-partition every model onto the
        survivors (``full_platform.subset``), no gain gate — the old
        shares may overlap the dead cluster and simply cannot run.  Each
        model's new plan is validated against the IR's ``Availability``
        constraint on its own share."""
        merged = dict(self.lost)
        for core_type, n in lost.items():
            if n < 0:
                raise ValueError(f"lost {n} {core_type!r} cores < 0")
            if not any(
                ct.name == core_type for ct in self.full_platform.core_types
            ):
                raise ValueError(f"unknown core type {core_type!r}")
            merged[core_type] = merged.get(core_type, 0) + n
        surviving = {
            ct.name: ct.count - merged.get(ct.name, 0)
            for ct in self.full_platform.core_types
        }
        degraded = self.full_platform.subset(
            {k: v for k, v in surviving.items() if v > 0}
        )
        if self._pre_degrade is None:
            self._pre_degrade = self.partition
        self.lost = merged
        self.platform = degraded
        Ts = {n: self.calibrators[n].matrix() for n in self.partition.names}
        self.T_planned = Ts
        for det in self.detectors.values():
            det.reset()
        candidate = self._search(Ts)
        for mp in candidate.assignments:
            verdict = evaluate(
                mp.plan, Ts[mp.name], mp.share,
                constraints=(Availability.from_platform(mp.share),),
            )
            if verdict.binding == "availability":
                raise RuntimeError(
                    f"degraded re-partition gave {mp.name!r} lost cores: "
                    f"{mp.plan}"
                )
        swapped = candidate.plans() != self.partition.plans()
        self.history.append(
            PartitionEvent(
                round=self.rounds,
                triggered_by=("degrade",),
                old_partition=self.partition,
                new_partition=candidate,
                predicted_gain=candidate.objective
                / max(abs(self._objective_of(self.partition, Ts)), 1e-12),
                swapped=swapped,
            )
        )
        self.partition = candidate
        if swapped:
            self.swaps += 1
        return candidate

    def rejoin(self) -> PartitionPlan:
        """Lost cores came back: restore the remembered pre-fault
        partition (drift since then re-triggers the normal loop)."""
        if self._pre_degrade is None:
            raise ValueError("rejoin() without a preceding degrade()")
        restored = self._pre_degrade
        self._pre_degrade = None
        self.lost = {}
        self.platform = self.full_platform
        Ts = {n: self.calibrators[n].matrix() for n in self.partition.names}
        self.T_planned = Ts
        for det in self.detectors.values():
            det.reset()
        swapped = restored.plans() != self.partition.plans()
        self.history.append(
            PartitionEvent(
                round=self.rounds,
                triggered_by=("rejoin",),
                old_partition=self.partition,
                new_partition=restored,
                predicted_gain=restored.objective
                / max(abs(self._objective_of(self.partition, Ts)), 1e-12),
                swapped=swapped,
            )
        )
        self.partition = restored
        if swapped:
            self.swaps += 1
        return restored

    def _objective_of(
        self, partition: PartitionPlan, Ts: Mapping[str, TimeMatrix]
    ) -> float:
        names = partition.names
        # A power-aware partition runs at its ASSIGNED clocks: score it
        # there, not at f_max — otherwise a binding cap makes every
        # candidate (scored down-clocked) look worse than the incumbent
        # (scored full-clock) and drift re-partitions never pass the gate.
        tps = []
        for n in names:
            mp = partition[n]
            if mp.power is not None:
                tps.append(
                    evaluate_frequencies(
                        mp.plan, Ts[n], self.platform, mp.power.stage_freqs
                    ).throughput
                )
            else:
                tps.append(mp.plan.throughput(Ts[n]))
        return partition_objective(
            tps,
            [self.weights.get(n, 1.0) for n in names],
            [self.slo_rates.get(n, 0.0) for n in names],
            self.fairness,
        )

    def _search(self, Ts: Mapping[str, TimeMatrix]) -> PartitionPlan:
        return partition_search(
            Ts,
            self.platform,
            weights=self.weights,
            slo_rates=self.slo_rates,
            mode=self.mode,
            exact_threshold=self.exact_threshold,
            fairness=self.fairness,
            power_cap_w=self.power_cap_w,
            power_objective=self.power_objective,
        )

    def throttle(self, power_cap_w: Optional[float]) -> PartitionPlan:
        """The machine's power envelope changed: re-partition NOW under the
        new cap on the current calibrated beliefs, no gain gate (the old
        partition may be infeasible under the new envelope).  The caller
        hot-swaps via ``MultiModelServer.swap_partition``."""
        self.power_cap_w = power_cap_w
        Ts = {n: self.calibrators[n].matrix() for n in self.partition.names}
        self.T_planned = Ts
        for det in self.detectors.values():
            det.reset()
        candidate = self._search(Ts)
        swapped = candidate.plans() != self.partition.plans()
        self.history.append(
            PartitionEvent(
                round=self.rounds,
                triggered_by=("power_cap",),
                old_partition=self.partition,
                new_partition=candidate,
                predicted_gain=candidate.objective
                / max(abs(self._objective_of(self.partition, Ts)), 1e-12),
                swapped=swapped,
            )
        )
        self.partition = candidate
        if swapped:
            self.swaps += 1
        return candidate

    def step(
        self, observations: Mapping[str, Sequence[StageObservation]]
    ) -> Optional[PartitionPlan]:
        """Fold one observation window per model; returns the new
        :class:`PartitionPlan` when a global hot-swap is warranted."""
        self.rounds += 1
        triggered: List[str] = []
        for name, obs in observations.items():
            if name not in self.calibrators:
                raise KeyError(f"observations for unknown model {name!r}")
            self.calibrators[name].observe(obs)
            mp = self.partition[name]
            current = {
                (tuple(layers), stage)
                for layers, stage in zip(
                    mp.plan.allocation, mp.plan.pipeline.stages
                )
            }
            relevant = [
                o.service_s
                for o in obs
                if (o.layers, o.stage) in current and o.service_s > 0.0
            ]
            if not relevant:
                continue
            observed = max(relevant)
            predicted = mp.plan.bottleneck(self.T_planned[name])
            if self.detectors[name].update(predicted, observed):
                triggered.append(name)
        if not triggered:
            return None
        # Confirmed change-point in >= 1 model: rebase those beliefs on
        # the sustained window, reset every detector (the global re-plan
        # changes every model's reference), re-run the partition DSE.
        for name in triggered:
            self.calibrators[name].rebase(observations[name])
        for det in self.detectors.values():
            det.reset()
        Ts = {name: self.calibrators[name].matrix() for name in self.partition.names}
        self.T_planned = Ts
        candidate = self._search(Ts)
        current_score = self._objective_of(self.partition, Ts)
        gain = candidate.objective / max(abs(current_score), 1e-12)
        if current_score > 0.0:
            # both feasible-scaled: demand the usual multiplicative gain
            swapped = candidate.objective >= current_score * self.config.min_gain
        else:
            # current partition violates an SLO on the calibrated truth:
            # any strictly better assignment is worth the swap
            swapped = candidate.objective > current_score
        swapped = swapped and candidate.plans() != self.partition.plans()
        self.history.append(
            PartitionEvent(
                round=self.rounds,
                triggered_by=tuple(triggered),
                old_partition=self.partition,
                new_partition=candidate,
                predicted_gain=gain,
                swapped=swapped,
            )
        )
        if not swapped:
            return None
        self.partition = candidate
        self.swaps += 1
        return candidate


class MultiModelMonitor:
    """Background control loop over a live :class:`MultiModelServer`.

    Every ``interval_s``: sample each model's stage counters, step the
    :class:`PartitionController`, and on a re-partition hot-swap the
    whole assignment.  Error semantics match
    :class:`~repro_torch.serving.adaptive.AdaptiveMonitor`: transient faults
    retry, ``max_failures`` consecutive ones park the loop with
    ``error`` set (surfaced by ``stop()``)."""

    def __init__(
        self,
        mserver: MultiModelServer,
        controller: PartitionController,
        interval_s: Optional[float] = None,
    ):
        self.mserver = mserver
        self.controller = controller
        self.interval_s = (
            interval_s if interval_s is not None else controller.config.interval_s
        )
        self._samplers = {
            name: ServerSampler(srv, min_items=controller.config.min_items)
            for name, srv in mserver.servers.items()
        }
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.max_failures = 3
        self._consecutive_failures = 0

    def sample(self) -> Dict[str, List[StageObservation]]:
        """One observation window across every model (public for tests)."""
        return {name: s.sample() for name, s in self._samplers.items()}

    def step(self) -> Optional[PartitionPlan]:
        observations = self.sample()
        if not any(observations.values()):
            return None
        prev_partition = self.controller.partition
        prev_swaps = self.controller.swaps
        new_partition = self.controller.step(observations)
        if new_partition is None:
            return None
        try:
            self.mserver.swap_partition(new_partition)
        except BaseException:
            # A prepare-phase failure leaves the servers on their old
            # plans: revert the belief so the controller keeps filtering
            # observations against what actually runs.
            self.controller.partition = prev_partition
            self.controller.swaps = prev_swaps
            if self.controller.history:
                self.controller.history[-1] = dataclasses.replace(
                    self.controller.history[-1], swapped=False
                )
            raise
        return new_partition

    def _degraded_transition(self, transition) -> PartitionPlan:
        """Run a controller degrade/rejoin and hot-swap the result; on ANY
        failure (search or swap) restore the whole controller belief so it
        keeps describing what actually runs.  ``swap_partition`` is
        all-or-nothing, so after a failed swap the servers still run
        ``snap``'s partition."""
        c = self.controller
        snap = (
            c.partition, c.swaps, c.platform, dict(c.lost), c._pre_degrade,
            list(c.history),
        )
        try:
            new_partition = transition()
            self.mserver.swap_partition(new_partition)
        except BaseException:
            (c.partition, c.swaps, c.platform, c.lost, c._pre_degrade,
             history) = snap
            c.history = collections.deque(history, maxlen=c.history.maxlen)
            raise
        return new_partition

    def degrade(self, lost: Mapping[str, int]) -> PartitionPlan:
        """Cluster/core loss: re-partition onto the survivors and swap."""
        return self._degraded_transition(lambda: self.controller.degrade(lost))

    def rejoin(self) -> PartitionPlan:
        """Lost cores returned: restore the pre-fault partition and swap."""
        return self._degraded_transition(self.controller.rejoin)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
                self._consecutive_failures = 0
                self.error = None
            except ServerClosed:
                return  # normal shutdown race
            except Exception as e:  # noqa: BLE001 — daemon must not spray
                self.error = e
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.max_failures or any(
                    srv._closed for srv in self.mserver.servers.values()
                ):
                    return

    def start(self) -> "MultiModelMonitor":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="mm-partition-adaptive", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)


def attach_partition_adaptive(
    mserver: MultiModelServer,
    priors: Mapping[str, TimeMatrix],
    platform: HeteroPlatform,
    *,
    mode: str = "best",
    config: Optional[AdaptiveConfig] = None,
    fairness: Optional[str] = None,
    exact_threshold: int = 8,
    power_cap_w: Optional[float] = None,
    power_objective: str = "throughput",
    start: bool = True,
) -> MultiModelMonitor:
    """Wire the global re-partition loop onto a running multi-model server
    (``serve({...}, adaptive=True)``).  Weights and SLO floors come from
    the server's registry, and — unless overridden — the re-plan runs
    under the SAME fairness objective the deployed partition was searched
    with (``mserver.fairness``), so drift can never silently flip a
    max-min deployment to utilitarian.  The monitor lands on
    ``mserver.monitor`` so ``stop()`` shuts the loop down first."""
    controller = PartitionController(
        priors=priors,
        partition=mserver.partition,
        platform=platform,
        weights=mserver.registry.weights(),
        slo_rates=mserver.registry.slo_rates(),
        mode=mode,
        config=config,
        fairness=fairness if fairness is not None else mserver.fairness,
        exact_threshold=exact_threshold,
        power_cap_w=power_cap_w,
        power_objective=power_objective,
    )
    monitor = MultiModelMonitor(mserver, controller)
    mserver.monitor = monitor
    if start:
        monitor.start()
    return monitor
