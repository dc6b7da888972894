"""A run with the timed path broken underneath comes out not correct;
the same run unbroken comes out correct (CPU, the plain routes, at a
small image size and micro-batch; the harness's look for a card is
skipped by calling ``run_cell`` directly)."""
import gc

import pytest
import torch

import repro_torch.serving.server as S
from repro_torch.kernels.graphs import GraphedFn

from portbench import bench

OFFLINE = {"batch_size": 4, "pool": 8, "preroll_batches": 2}
SERVER = {"batch_size": 4, "pool": 8, "rate": 40.0, "preroll_s": 0.2, "postroll_s": 0.1,
          "flush_timeout_s": 0.2}  # micro-batches fill at this rate
TINY = {
    "vgg16.offline.b32": OFFLINE,
    "resnet50.offline.b128": OFFLINE,
    "vgg16.server.b4": SERVER,
    "vgg16.offline.card.b32": OFFLINE,
    "resnet50.offline.card.b128": OFFLINE,
    "vgg16.server.card.b4": SERVER,
}


def tiny_cell(name):
    """``name`` at a small size, made from its files (BENCHMARK.json
    lists one of these cells; the others are kept for later PRs)."""
    config, traffic = name.split(".", 1)
    cell = bench.Cell.of(bench.load_spec(), name, config, traffic)
    cell.config["input"] = [32, 32, 3]
    cell.mix.update(TINY[name])
    return cell


def _rows(fn):
    def split_rows(x, valid):
        return list(fn([x[i:i + 1] for i in range(valid)]))
    return split_rows


def altered_answer(monkeypatch):
    """One answer altered where it is produced: the first row's classes
    shifted by one."""
    monkeypatch.setattr(S, "split_rows", _rows(lambda rows: [rows[0].roll(1, dims=1)] + rows[1:]))


def answers_swapped(monkeypatch):
    """Each micro-batch's answers handed to the wrong tickets."""
    monkeypatch.setattr(S, "split_rows", _rows(lambda rows: rows[::-1]))


def half_left_out(monkeypatch):
    """Half of each micro-batch left out, the mean of the rest's answers
    in its place."""
    def fill(rows):
        half = (len(rows) + 1) // 2
        return rows[:half] + [torch.cat(rows[:half]).mean(0, keepdim=True)] * (len(rows) - half)
    monkeypatch.setattr(S, "split_rows", _rows(fill))


def state_unchanged(monkeypatch):
    """Every stage call after the first returns the first call's output."""
    call = GraphedFn.__call__
    first = {}

    def stale(self, consts, inputs):
        if id(self) not in first:
            first[id(self)] = call(self, consts, inputs)
        return {k: v.clone() for k, v in first[id(self)].items()}
    monkeypatch.setattr(GraphedFn, "__call__", stale)


FAULTS = [altered_answer, answers_swapped, half_left_out, state_unchanged]


@pytest.mark.parametrize("cell", ["vgg16.offline.b32", "vgg16.server.b4",
                                  "resnet50.offline.card.b128", "vgg16.server.card.b4"])
@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    torch.set_num_threads(2)
    fault(monkeypatch)
    result, _ = bench.run_cell(tiny_cell(cell), 2**31 + 5, 0.6, False, device="cpu")
    assert result["correct"] is False
    assert result["compared"]["worst_prob_rel_gap"]["value"] > 1e-2


@pytest.mark.parametrize("cell", list(TINY))
def test_the_same_run_unbroken_is_correct(cell):
    torch.set_num_threads(2)
    result, info = bench.run_cell(tiny_cell(cell), 2**31 + 5, 0.6, False, device="cpu")
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] > 0 and set(result) == {
        "correct", "attempted", "failed", "metrics", "device", "compared"}
    assert list(result["compared"])[0] == "worst_prob_rel_gap"
    assert {"plan", "stage0_fill", "graph_launches", "nvidia_smi", "generator_late_ms"} <= set(info)
    assert gc.get_freeze_count() < info["gc_frozen_objects"]  # thawed after the window
