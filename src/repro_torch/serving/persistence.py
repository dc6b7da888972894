"""Last-known-good plan persistence (crash-restart warm start); the
port's copy of ``repro/serving/persistence.py``, pure Python over the
port's own ``core/``, so a file either package writes loads in the other.

A fault-tolerant server (serving/faults.py) survives worker death and
core loss *within* a process; :class:`PlanStore` covers the failure mode
above that — the whole process dying.  Every successful hot-swap saves
the active :class:`~repro_torch.core.plan.Plan` (or, multi-model, every slice
of the :class:`~repro_torch.core.dse.PartitionPlan`) as JSON via the IR's
round-trip, atomically (write-temp + ``os.replace``), so a restarting
process can ``serve(resume_from=...)`` straight onto the plan that was
serving when it died — skipping the cold calibrate + DSE path entirely.

The store is deliberately dumb: one JSON file, one payload, no history.
Recovering the *latest* good operating point is the availability
feature; provenance lives in the benchmark JSONs and server metrics.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional, Union

from ..core.dse import ModelPlan, PartitionPlan
from ..core.pipeline import PipelinePlan
from ..core.plan import Plan
from ..core.platform import HeteroPlatform

logger = logging.getLogger(__name__)

__all__ = ["PlanStore"]

#: Payload schema version — bump on incompatible layout changes so a
#: stale file from an older build is skipped, not misparsed.
_VERSION = 1


class PlanStore:
    """Atomic JSON persistence for the active plan / partition.

    ``save_server`` is duck-typed over both server kinds (anything with
    ``.partition`` persists as a partition; anything with ``.plan`` as a
    single plan), which is what ``PipelineServer._persist_plan`` calls
    after every successful swap (the multi-model server, which persists
    partitions, is not ported yet).
    """

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)

    @classmethod
    def coerce(cls, store: Union["PlanStore", str, os.PathLike]) -> "PlanStore":
        return store if isinstance(store, PlanStore) else cls(store)

    # ----------------------------------------------------------------- write
    def _write(self, payload: Dict[str, Any]) -> str:
        payload = dict(payload, version=_VERSION)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        # Atomic: a crash mid-write must never leave a torn file where the
        # last known good plan used to be.
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return self.path

    def save_plan(self, plan: Any, *, epoch: Optional[int] = None) -> str:
        """Persist a single-model plan (any legacy plan type or the IR)."""
        ir = plan if isinstance(plan, Plan) else Plan.from_legacy(plan)
        return self._write({"kind": "plan", "epoch": epoch, "plan": ir.to_dict()})

    def save_partition(
        self, partition: PartitionPlan, *, epoch: Optional[int] = None
    ) -> str:
        """Persist every slice of a partition (IR round-trip per model)."""
        return self._write(
            {
                "kind": "partition",
                "epoch": epoch,
                "objective": partition.objective,
                "feasible": partition.feasible,
                "total_power_w": partition.total_power_w,
                "throughputs": partition.throughputs(),
                "models": [ir.to_dict() for ir in partition.plan_irs()],
            }
        )

    def save_server(self, server: Any) -> str:
        """Persist whatever ``server`` is running right now (duck-typed)."""
        partition = getattr(server, "partition", None)
        if partition is not None:
            return self.save_partition(
                partition, epoch=getattr(server, "partition_epoch", None)
            )
        return self.save_plan(server.plan, epoch=getattr(server, "epoch", None))

    # ------------------------------------------------------------------ read
    def load(self) -> Optional[Dict[str, Any]]:
        """The raw payload, or None when absent/unreadable/stale-format
        (a cold start, not an error — resume is best-effort by design)."""
        try:
            with open(self.path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError):
            logger.exception("plan store %s unreadable; cold start", self.path)
            return None
        if payload.get("version") != _VERSION:
            logger.warning(
                "plan store %s has version %r (want %r); cold start",
                self.path, payload.get("version"), _VERSION,
            )
            return None
        return payload

    def load_plan(self) -> Optional[Plan]:
        """The saved single-model plan IR, or None (absent / wrong kind)."""
        payload = self.load()
        if payload is None or payload.get("kind") != "plan":
            return None
        return Plan.from_dict(payload["plan"])

    def load_partition(
        self, platform: HeteroPlatform
    ) -> Optional[PartitionPlan]:
        """Rebuild the saved :class:`PartitionPlan` on ``platform``.

        Each model's share is re-carved with ``platform.subset`` from the
        persisted ``(core_type, count)`` pairs — so the file is portable
        across processes as long as the machine still has those cores.
        Returns None when absent / wrong kind / share no longer fits.
        """
        payload = self.load()
        if payload is None or payload.get("kind") != "partition":
            return None
        throughputs = payload.get("throughputs", {})
        assignments = []
        try:
            for d in payload["models"]:
                ir = Plan.from_dict(d)
                if ir.model is None or ir.share is None:
                    raise ValueError(f"partition slice lacks model/share: {d}")
                # strict subset() raises KeyError/ValueError when the
                # persisted share no longer fits this machine — caught
                # below, resuming onto a smaller platform is a cold start
                assignments.append(
                    ModelPlan(
                        name=ir.model,
                        share=platform.subset(dict(ir.share)),
                        plan=ir.as_pipeline_plan(),
                        throughput=float(throughputs.get(ir.model, 0.0)),
                    )
                )
        except (KeyError, ValueError, TypeError):
            logger.exception(
                "plan store %s: partition does not fit platform %s; "
                "cold start", self.path, platform.name,
            )
            return None
        return PartitionPlan(
            assignments=tuple(assignments),
            objective=float(payload.get("objective", 0.0)),
            feasible=bool(payload.get("feasible", True)),
            total_power_w=float(payload.get("total_power_w", 0.0)),
        )
