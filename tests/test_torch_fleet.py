"""The port's fleet: the three-level DSE (models -> boards -> shares ->
pipelines), the global router with per-board generation tokens, board
loss -> re-dispatch -> rejoin, replica autoscaling, and the strict
``HeteroPlatform.subset`` contract the fleet's degrade paths rely on.

Every test of tests/test_fleet.py, on the port's ``repro_torch.core`` and
``repro_torch.serving`` at the reference's tiny graphs (16x16 inputs),
plus parity tests with the JAX package.  The fleet DSE is pure Python in
both, so its results must be IDENTICAL: the same ``notation()``,
``objective``, ``feasible`` and ``total_power_w`` of ``fleet_search`` and
``exhaustive_fleet``, and the same ``verify_placement`` verdicts,
compared with ``==``.

Live routers run on the CPU (``device="cpu"``) at micro-batch 1, each
board a ``MultiModelServer``: their outputs must be within ``rtol=1e-4,
atol=1e-5`` of the reference's single-stage engine (the reference's bar,
tests/test_fleet.py) and bitwise equal to the port's single-stage engine
(on the CPU the library convs pick other blockings at other batch sizes,
so only equal shapes are bitwise comparable), also across board loss and
rejoin.  Submits block, so nothing sheds under load, and no test waits
on a deadline tighter than a minute.
"""
from __future__ import annotations

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref_core
import repro.serving as ref_serving
from repro.cnn.graph import Graph as RefGraph
from repro.cnn.models import MODELS as REF_MODELS
from repro_torch.cnn.graph import Graph
from repro_torch.cnn.models import MODELS
from repro_torch.cnn.params import params_from_numpy
from repro_torch.core import (
    BoardSpec,
    Placement,
    evaluate,
    exhaustive_fleet,
    fleet_search,
    hikey970,
    partition_search,
    verify_placement,
)
from repro_torch.core.fleet import BoardPlan, FleetPlan
from repro_torch.serving import (
    AutoPlanner,
    FleetAutoscaler,
    FleetRouter,
    ModelEntry,
    ModelRegistry,
    NoReplica,
    PlanStore,
    SingleStageEngine,
    host_platform,
)
from repro_torch.serving.faults import BOARD_KINDS, FaultEvent, FaultPlan

# one intra-op thread: these tests share the CPU with the other test workers
torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
PLAT = hikey970()
SMALL = PLAT.subset({"B": 2, "s": 2}, name="small")
VOCAB = PLAT.stage_vocabulary()
REF_PLAT = ref_core.hikey970()
REF_SMALL = REF_PLAT.subset({"B": 2, "s": 2}, name="small")


def tiny(name: str, ch: int = 8, G=Graph) -> Graph:
    g = G(name, (16, 16, 3))
    a = g.conv("c1", "input", ch, 3)
    a = g.conv("c2", a, ch, 3, stride=2)
    a = g.conv("c3", a, 2 * ch, 1)
    a = g.pool_max("p1", a, 2, 2)
    a = g.conv("c4", a, 2 * ch, 3)
    a = g.gap("gap", a)
    a = g.fc("fc", a, 10)
    g.softmax("sm", a)
    return g


def _random_matrix(rng, n):
    return [
        {stage: float(rng.uniform(1e-5, 1.0)) for stage in VOCAB}
        for _ in range(n)
    ]


def _rows_to_matrix(rows):
    return [dict(zip(VOCAB, row)) for row in rows]


def _plan_fields(fp):
    """What must match across packages: the placement, its score and
    feasibility, its modeled power and each model's aggregate rate."""
    return (fp.notation(), fp.objective, fp.feasible, fp.total_power_w, fp.throughputs(),
            fp.replica_counts())


def _ref_boards(boards):
    plat = {"hikey970": REF_PLAT, "small": REF_SMALL}
    return tuple(
        ref_core.BoardSpec(b.name, plat.get(b.platform.name) or
                           ref_serving.host_platform(len(b.platform.core_types)),
                           power_cap_w=b.power_cap_w)
        for b in boards
    )


# ------------------------------------------------- platform.subset (strict)
def test_subset_raises_on_absent_core_type():
    with pytest.raises(KeyError, match="absent from platform"):
        PLAT.subset({"B": 2, "gpu": 1})


def test_subset_strict_false_projects_onto_available():
    sub = PLAT.subset({"B": 2, "gpu": 1}, strict=False)
    assert {ct.name: ct.count for ct in sub.core_types} == {"B": 2}


def test_subset_still_validates_counts():
    with pytest.raises(ValueError):
        PLAT.subset({"B": 9})
    with pytest.raises(ValueError):
        PLAT.subset({"B": 0, "s": 0})


def test_plan_store_cold_start_on_smaller_platform(tmp_path):
    """The strict subset() KeyError is the cold-start signal when the
    persisted share names a core type this machine lacks."""
    reg = ModelRegistry()
    reg.add("a", tiny("a", 8), device="cpu")
    reg.add("b", tiny("b", 12), device="cpu")

    planner = AutoPlanner(platform=PLAT, mode="best", device="cpu")
    part = partition_search(planner.time_matrices(reg.graphs()), PLAT)
    store = PlanStore(tmp_path / "part.json")
    store.save_partition(part, epoch=1)
    assert store.load_partition(PLAT) is not None
    # small-only machine: shares reference "B" -> KeyError -> cold start
    assert store.load_partition(PLAT.subset({"s": 4})) is None


# ------------------------------------------------------- board fault events
def test_board_fault_events_and_round_trip():
    plan = FaultPlan.seeded_board_cycle(
        3, ["b0", "b1"], at_s=0.5, rejoin_after_s=1.0
    )
    evs = plan.board_events()
    assert [e.kind for e in evs] == list(BOARD_KINDS)
    assert evs[0].board == evs[1].board in {"b0", "b1"}
    assert evs[1].at_s == pytest.approx(1.5)
    # determinism: the same seed picks the same victim
    again = FaultPlan.seeded_board_cycle(3, ["b0", "b1"], at_s=0.5)
    assert again.events[0].board == evs[0].board
    back = FaultPlan.from_dict(plan.to_dict())
    assert back.board_events() == evs


def test_board_event_requires_board():
    with pytest.raises(ValueError):
        FaultEvent("board_loss", at_s=0.0)


# ------------------------------------------------------------ Placement IR
def test_placement_constraint_flags_missing_cores():
    rng = np.random.default_rng(0)
    T = _random_matrix(rng, 4)
    part = partition_search({"m": T}, PLAT)
    ir = part["m"].plan_ir()
    ok = evaluate(ir, T, PLAT, constraints=(Placement.for_board("b0", PLAT),))
    assert ok.feasible
    # a board that lost its big cluster cannot place a share that uses B
    dead = Placement.for_board("b0", PLAT.subset({"s": 4}))
    ev = evaluate(ir, T, PLAT, constraints=(dead,))
    assert not ev.feasible and ev.binding == "placement"


# ------------------------------------------------------------- fleet DSE
def test_fleet_search_basic_two_boards():
    rng = np.random.default_rng(1)
    Ts = {"a": _random_matrix(rng, 4), "b": _random_matrix(rng, 5)}
    boards = (BoardSpec("b0", SMALL), BoardSpec("b1", SMALL))
    fp = fleet_search(Ts, boards, replicas={"a": 2, "b": 1})
    assert fp.feasible
    assert fp.replica_counts() == {"a": 2, "b": 1}
    assert set(fp.replicas("a")) == {"b0", "b1"}
    assert len(fp.replicas("b")) == 1
    # fleet throughput of a model is the sum over its replicas
    per_board = [
        mp.throughput
        for bp in fp.boards
        if bp.partition is not None
        for mp in bp.partition.assignments
        if mp.name == "a"
    ]
    assert fp.throughputs()["a"] == pytest.approx(sum(per_board))
    assert " || " in fp.notation()
    verify_placement(fp, Ts)  # every replica fits its board


def test_fleet_search_replica_validation():
    rng = np.random.default_rng(2)
    Ts = {"a": _random_matrix(rng, 3)}
    boards = (BoardSpec("b0", SMALL), BoardSpec("b1", SMALL))
    with pytest.raises(ValueError):
        fleet_search(Ts, boards, replicas={"a": 0})
    with pytest.raises(ValueError):
        fleet_search(Ts, boards, replicas={"a": 3})
    with pytest.raises(ValueError):
        fleet_search(Ts, boards, replicas={"ghost": 1})


def test_fleet_search_respects_board_power_cap():
    rng = np.random.default_rng(3)
    Ts = {"a": _random_matrix(rng, 4)}
    open_b = (BoardSpec("b0", SMALL), BoardSpec("b1", SMALL))
    free = fleet_search(Ts, open_b, replicas={"a": 1})
    capped_b = tuple(BoardSpec(b.name, b.platform, power_cap_w=1e-9) for b in open_b)
    capped = fleet_search(Ts, capped_b, replicas={"a": 1})
    assert free.feasible and not capped.feasible
    assert capped.objective <= free.objective


def _check_matches_oracle(Ts, replicas):
    boards = (BoardSpec("b0", SMALL), BoardSpec("b1", SMALL))
    fast = fleet_search(Ts, boards, replicas=replicas)
    oracle = exhaustive_fleet(Ts, boards, replicas=replicas)
    assert fast.feasible == oracle.feasible
    assert fast.objective == pytest.approx(oracle.objective, rel=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_fleet_search_matches_exhaustive_seeded(seed):
    """Deterministic fallback of the hypothesis property below — runs
    even where hypothesis is only the conftest stub."""
    rng = np.random.default_rng(seed)
    Ts = {
        "a": _random_matrix(rng, int(rng.integers(1, 5))),
        "b": _random_matrix(rng, int(rng.integers(1, 5))),
    }
    replicas = {
        "a": int(rng.integers(1, 3)),
        "b": int(rng.integers(1, 3)),
    }
    _check_matches_oracle(Ts, replicas)


@settings(max_examples=25, deadline=None)
@given(
    st.lists(
        st.lists(
            st.floats(min_value=1e-6, max_value=1e3, allow_nan=False,
                      allow_infinity=False),
            min_size=len(VOCAB), max_size=len(VOCAB),
        ),
        min_size=1, max_size=4,
    ),
    st.lists(
        st.lists(
            st.floats(min_value=1e-6, max_value=1e3, allow_nan=False,
                      allow_infinity=False),
            min_size=len(VOCAB), max_size=len(VOCAB),
        ),
        min_size=1, max_size=4,
    ),
    st.integers(min_value=1, max_value=2),
    st.integers(min_value=1, max_value=2),
)
def test_fleet_search_matches_exhaustive(rows_a, rows_b, ra, rb):
    """Property: on 2 small boards the three-level heuristic matches the
    exhaustive board-assignment oracle (the inner partition_search
    upgrades to its own exact search at these sizes, so the match is
    provable, not probabilistic)."""
    Ts = {"a": _rows_to_matrix(rows_a), "b": _rows_to_matrix(rows_b)}
    _check_matches_oracle(Ts, {"a": ra, "b": rb})


# ------------------------------------------------ DSE parity with the reference
@pytest.mark.parametrize("capped", [False, True], ids=["open", "capped"])
@pytest.mark.parametrize("seed", range(4))
def test_fleet_search_and_oracle_match_reference_seeded(seed, capped):
    """Seeded instances on two small boards (one capped below its
    envelope in the capped case): both searches give the reference's
    placement, score, feasibility and modeled power."""
    rng = np.random.default_rng(100 + seed)
    Ts = {
        "a": _random_matrix(rng, int(rng.integers(1, 5))),
        "b": _random_matrix(rng, int(rng.integers(1, 5))),
    }
    replicas = {"a": int(rng.integers(1, 3)), "b": int(rng.integers(1, 3))}
    cap = 0.5 * SMALL.max_power_w() if capped else None
    boards = (BoardSpec("b0", SMALL, power_cap_w=cap), BoardSpec("b1", SMALL))
    ref_boards = _ref_boards(boards)
    for port_fn, ref_fn in ((fleet_search, ref_core.fleet_search),
                            (exhaustive_fleet, ref_core.exhaustive_fleet)):
        got = port_fn(Ts, boards, replicas=replicas)
        want = ref_fn(Ts, ref_boards, replicas=replicas)
        assert _plan_fields(got) == _plan_fields(want)


@pytest.mark.parametrize("plat", ["hikey970", "host4"])
@pytest.mark.parametrize("replicas", [(1, 1), (2, 1), (2, 2)], ids=lambda r: f"{r[0]}x{r[1]}")
def test_vgg16_and_mobilenet_fleet_matches_reference(plat, replicas):
    """The pair the card co-serves, on two boards of ``hikey970()`` (and
    of ``host_platform(4)``, the card's platform), planned from the
    synthetic model by both packages: the same fleet plan, and the same
    ``verify_placement`` verdicts."""
    names = ("vgg16", "mobilenet")
    make = {"hikey970": (hikey970, ref_core.hikey970),
            "host4": (lambda: host_platform(4), lambda: ref_serving.host_platform(4))}[plat]
    Ts = AutoPlanner(platform=make[0]()).time_matrices({n: MODELS[n]() for n in names})
    ref_Ts = ref_serving.AutoPlanner(platform=make[1]()).time_matrices(
        {n: REF_MODELS[n]() for n in names})
    assert Ts == ref_Ts
    want_r = dict(zip(names, replicas))
    boards = (BoardSpec("b0", make[0]()), BoardSpec("b1", make[0]()))
    got = fleet_search(Ts, boards, replicas=want_r)
    want = ref_core.fleet_search(ref_Ts, (ref_core.BoardSpec("b0", make[1]()),
                                          ref_core.BoardSpec("b1", make[1]())), replicas=want_r)
    assert _plan_fields(got) == _plan_fields(want)
    assert _verdicts(verify_placement(got, Ts)) == _verdicts(ref_core.verify_placement(want, ref_Ts))


def _verdicts(verdicts):
    return {
        key: (ev.plan.notation(), ev.objective_name, ev.score, ev.rank, ev.feasible, ev.binding,
              ev.metrics.stage_times_s, ev.metrics.throughput)
        for key, ev in verdicts.items()
    }


def test_verify_placement_refuses_what_the_reference_refuses():
    """A board that lost its big cluster holding a replica planned with
    it: both packages refuse the plan with the same message."""
    rng = np.random.default_rng(7)
    Ts = {"a": _random_matrix(rng, 4)}
    fp = fleet_search(Ts, (BoardSpec("b0", PLAT),), replicas={"a": 1})
    ref_fp = ref_core.fleet_search(Ts, (ref_core.BoardSpec("b0", REF_PLAT),), replicas={"a": 1})
    assert _verdicts(verify_placement(fp, Ts)) == _verdicts(ref_core.verify_placement(ref_fp, Ts))
    assert any(ct.name == "B" for ct in fp.boards[0].partition["a"].share.core_types)
    errors = []
    for plan, verify, sub in (
        (fp, verify_placement, PLAT.subset({"s": 4})),
        (ref_fp, ref_core.verify_placement, REF_PLAT.subset({"s": 4})),
    ):
        bp = plan.boards[0]
        moved = type(plan)(
            boards=(type(bp)(board=bp.board, platform=sub, partition=bp.partition),),
            objective=plan.objective, feasible=plan.feasible,
        )
        with pytest.raises(ValueError, match="does not fit board") as err:
            verify(moved, Ts)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert isinstance(fp, FleetPlan) and isinstance(fp.boards[0], BoardPlan)


# ------------------------------------------------------------ live router
def _numpy_params(ref_params):
    return {n: {k: np.asarray(v) for k, v in p.items()} for n, p in ref_params.items()}


@pytest.fixture(scope="module")
def fleet_setup():
    """Two tiny models on the reference's weights, the reference's
    registry of the same, two hikey970() boards, images and the
    reference's single-stage outputs."""
    ref_reg = ref_serving.ModelRegistry()
    ref_reg.add("a", tiny("a", 8, RefGraph))
    ref_reg.add("b", tiny("b", 12, RefGraph))
    reg = ModelRegistry.coerce({
        e.name: ModelEntry(name=e.name, graph=tiny(e.name, 8 if e.name == "a" else 12),
                           params=params_from_numpy(_numpy_params(e.params), "cpu"))
        for e in ref_reg
    })
    Ts = AutoPlanner(platform=PLAT, mode="best", device="cpu").time_matrices(reg.graphs())
    boards = (BoardSpec("b0", PLAT), BoardSpec("b1", PLAT))
    rng = np.random.default_rng(0)
    images = [rng.standard_normal((1, 16, 16, 3)).astype(np.float32) for _ in range(8)]
    ref_outs = {}
    for m in ("a", "b"):
        eng = ref_serving.SingleStageEngine(ref_reg[m].graph, ref_reg[m].params)
        ref_outs[m] = [np.asarray(o) for o in eng.run([jnp.asarray(x) for x in images])["outputs"]]
    return reg, Ts, boards, images, ref_outs


def _single(reg, images, backend=None):
    return {m: SingleStageEngine(reg[m].graph, reg[m].params, backend=backend, device="cpu")
            .run(images)["outputs"] for m in reg.names}


def test_fleet_router_serves_all_replicas(fleet_setup):
    reg, Ts, boards, images, ref_outs = fleet_setup
    fp = fleet_search(Ts, boards, replicas={"a": 2, "b": 2})
    with FleetRouter(reg, fp, queue_depth=2, boards=boards, device="cpu") as router:
        router.warmup()
        tickets = [(m, router.submit(m, img)) for img in images for m in ("a", "b")]
        outs = {"a": [], "b": []}
        for m, t in tickets:
            outs[m].append(t.result(timeout=60))
        snap = router.metrics()
    for m in outs:
        for got, want in zip(outs[m], ref_outs[m]):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert snap["completed"] == snap["submitted"] == 2 * len(images)
    assert snap["failed"] == 0
    assert all(d["alive"] for d in snap["boards"].values())
    with pytest.raises(KeyError):
        FleetRouter(reg, fp, boards=boards, device="cpu").submit("ghost", images[0])


def test_fleet_router_no_replica_when_model_unhosted(fleet_setup):
    reg, Ts, boards, images, _ = fleet_setup
    fp = fleet_search(Ts, boards, replicas={"a": 1, "b": 1})
    # find the board hosting "a" and kill it; "a" has no survivor
    host = fp.replicas("a")[0]
    other = [b for b in ("b0", "b1") if b != host][0]
    with FleetRouter(reg, fp, queue_depth=2, boards=boards, device="cpu") as router:
        router.warmup()
        router.fail_board(host)
        with pytest.raises(NoReplica):
            router.submit("a", images[0])
        if fp.replicas("b") == [other]:  # peer model unaffected
            router.submit("b", images[0]).result(timeout=60)


def test_seeded_board_loss_rejoin_zero_loss_bitwise(fleet_setup):
    """A seeded board-loss -> rejoin cycle loses zero tickets, duplicates
    nothing, and outputs stay bitwise equal to the fault-free baseline
    (the port's single-stage engine)."""
    reg, Ts, boards, images, _ = fleet_setup
    refs = _single(reg, images)
    fp = fleet_search(Ts, boards, replicas={"a": 2, "b": 2})
    cycle = FaultPlan.seeded_board_cycle(11, [b.name for b in boards])
    victim = cycle.events[0].board
    with FleetRouter(reg, fp, queue_depth=2, boards=boards, device="cpu") as router:
        router.warmup()
        tickets = []
        crashed = threading.Event()

        def crash():
            router.fail_board(victim)
            crashed.set()

        th = threading.Thread(target=crash)
        th.start()
        for img in images:
            for m in ("a", "b"):
                tickets.append((m, router.submit(m, img)))
        outs = {"a": [], "b": []}
        for m, t in tickets:
            outs[m].append(t.result(timeout=60))
        th.join(timeout=60)
        assert crashed.is_set()
        router.rejoin_board(victim)
        # the rejoined fleet serves again on both boards
        post = [(m, router.submit(m, img)) for img in images[:4] for m in ("a", "b")]
        for m, t in post:
            t.result(timeout=60)
        snap = router.metrics()
    assert snap["failed"] == 0
    assert snap["completed"] == snap["submitted"]
    assert snap["boards"][victim]["alive"]
    assert snap["boards"][victim]["generation"] >= 2  # loss + rejoin
    for m in outs:
        assert len(outs[m]) == len(images)  # zero lost, zero duplicated
        for got, want in zip(outs[m], refs[m]):
            assert torch.equal(got, want)


def test_autoscaler_scale_out_and_in(fleet_setup):
    reg, Ts, boards, images, _ = fleet_setup
    fp = fleet_search(Ts, boards, replicas={"a": 1, "b": 1})
    with FleetRouter(reg, fp, queue_depth=2, boards=boards, device="cpu") as router:
        router.warmup()
        # tiny target_utilization makes the observed rate saturating
        scaler = FleetAutoscaler(
            router, Ts, target_utilization=1e-6, window_s=5.0
        )
        ts = [router.submit(m, img) for img in images for m in ("a", "b")]
        for t in ts:
            t.result(timeout=60)
        assert router.observed_rate("a", 5.0) > 0
        assert scaler.desired_replicas() == {"a": 2, "b": 2}
        newp = scaler.step()
        assert newp is not None and newp.replica_counts() == {"a": 2, "b": 2}
        assert router.plan_epoch == 1
        # zero drops through the rebuild: serve again on the wider fleet
        ts = [router.submit(m, img) for img in images[:4] for m in ("a", "b")]
        for t in ts:
            t.result(timeout=60)
        snap = router.metrics()
        assert snap["failed"] == 0 and snap["completed"] == snap["submitted"]
        # idle window -> scale back in
        scaler.window_s = 0.01
        time.sleep(0.05)
        newp2 = scaler.step()
        assert newp2 is not None and newp2.replica_counts() == {"a": 1, "b": 1}
        assert len(scaler.decisions) == 2


def test_apply_plan_same_set_hot_swaps(fleet_setup):
    reg, Ts, boards, images, ref_outs = fleet_setup
    fp = fleet_search(Ts, boards, replicas={"a": 2, "b": 2})
    with FleetRouter(reg, fp, queue_depth=2, boards=boards, device="cpu") as router:
        router.warmup()
        gens = {n: d["generation"] for n, d in router.metrics()["boards"].items()}
        router.apply_plan(fp)  # identical plan: no drain, no rebuild
        after = {n: d["generation"] for n, d in router.metrics()["boards"].items()}
        assert after == gens  # same hosted sets -> epoch swap path only
        t = router.submit("a", images[0])
        np.testing.assert_allclose(
            t.result(timeout=60).numpy(), ref_outs["a"][0], rtol=RTOL, atol=ATOL,
        )


# ------------------------------------------------------ the port's own contracts
def test_fleet_router_runs_on_the_card_by_default(fleet_setup):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the no-CUDA refusal cannot be shown")
    reg, Ts, boards, _, _ = fleet_setup
    fp = fleet_search(Ts, boards, replicas={"a": 1, "b": 1})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetRouter(reg, fp, boards=boards)


def test_repeated_board_loss_cycles_and_autoscale_keep_single_stage_bits(fleet_setup):
    """The card's scenario at tiny size, on the ``cuda_fused`` route's
    plain version: three loss/rejoin cycles of the seeded victim, each
    started from a thread while traffic flows, then an autoscale that
    rebuilds boards, and a same-plan ``apply_plan``.  No ticket is lost,
    failed or duplicated to a client, every output keeps its
    single-stage bits, and the same plan changes no board's generation."""
    reg, Ts, boards, images, _ = fleet_setup
    refs = _single(reg, images, backend="cuda_fused")
    fp = fleet_search(Ts, boards, replicas={"a": 1, "b": 1})
    victim = FaultPlan.seeded_board_cycle(11, [b.name for b in boards]).events[0].board
    differ, served = [], 0
    with FleetRouter(reg, fp, backend="cuda_fused", queue_depth=2, boards=boards,
                     device="cpu") as router:
        router.warmup()

        def window():
            nonlocal served
            tickets = [(m, i, router.submit(m, img)) for i, img in enumerate(images)
                       for m in ("a", "b")]
            for m, i, t in tickets:
                if not torch.equal(t.result(timeout=60), refs[m][i]):
                    differ.append((m, i))
            served += len(tickets)

        scaler = FleetAutoscaler(router, Ts, target_utilization=1e-6, window_s=5.0)
        window()
        assert scaler.step() is not None and router.plan.replica_counts() == {"a": 2, "b": 2}
        for _ in range(3):
            th = threading.Thread(target=router.fail_board, args=(victim,))
            th.start()
            window()
            th.join(timeout=60)
            assert not th.is_alive() and not router.metrics()["boards"][victim]["alive"]
            router.rejoin_board(victim)
            window()
        gens = {n: d["generation"] for n, d in router.metrics()["boards"].items()}
        router.apply_plan(router.plan)
        assert {n: d["generation"] for n, d in router.metrics()["boards"].items()} == gens
        window()
        snap = router.metrics()
    assert not differ
    assert snap["failed"] == 0 and snap["completed"] == snap["submitted"] == served
    assert snap["boards"][victim]["generation"] >= 6  # three losses + three rejoins
    assert len(scaler.decisions) == 1


def test_submit_racing_a_board_loss_keeps_its_ticket(fleet_setup):
    """A board dies between the router's pick and its submit to that
    board's server: ``fail_board`` takes the entry as an orphan and
    re-dispatches it, so the client's submit returns its ticket, which
    resolves once with the single-stage bits.  (The reference's router
    raises the dead server's ``ServerClosed`` to the client here while
    re-dispatching the same entry; ROADMAP §3.)"""
    reg, Ts, boards, images, _ = fleet_setup
    refs = _single(reg, images)
    fp = fleet_search(Ts, boards, replicas={"a": 2, "b": 2})
    with FleetRouter(reg, fp, queue_depth=2, boards=boards, device="cpu") as router:
        router.warmup()
        # both boards idle: the router picks the first by name
        victim = "b0"
        server = router._boards[victim].server
        real_submit = server.submit

        def submit_after_the_loss(model, image, **kw):
            router.fail_board(victim)
            return real_submit(model, image, **kw)

        server.submit = submit_after_the_loss
        ticket = router.submit("a", images[3], timeout=60)
        out = ticket.result(timeout=60)
        snap = router.metrics()
    assert torch.equal(out, refs["a"][3])
    assert snap["redispatched"] == 1 and snap["failed"] == 0
    assert snap["completed"] == snap["submitted"] == 1
    assert not snap["boards"][victim]["alive"]


def test_a_lost_boards_servers_are_freed_when_fail_board_returns(fleet_setup):
    """The crash reason that ``stop()`` re-raises holds the dead servers
    in a reference cycle; ``fail_board`` collects it, so a lost board's
    servers (on the card: its stage graphs and their pools) are gone
    when it returns, with the interpreter's own collector off.  (The
    servers' loggers are silenced here: pytest keeps each log record,
    and the crash's record holds the same traceback.)"""
    import gc
    import logging
    import weakref

    reg, Ts, boards, images, _ = fleet_setup
    fp = fleet_search(Ts, boards, replicas={"a": 2, "b": 2})
    log = logging.getLogger("repro_torch.serving")
    level = log.level
    log.setLevel(logging.CRITICAL)
    gc.disable()
    try:
        with FleetRouter(reg, fp, queue_depth=2, boards=boards, device="cpu") as router:
            router.warmup()
            tickets = [router.submit(m, img) for img in images for m in ("a", "b")]
            dead = [weakref.ref(s) for s in router._boards["b0"].server.servers.values()]
            router.fail_board("b0")
            for t in tickets:
                t.result(timeout=60)
            assert [w() for w in dead] == [None, None]
    finally:
        gc.enable()
        log.setLevel(level)
