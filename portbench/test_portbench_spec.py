"""BENCHMARK.json against its required shape, and every cell's files
found by name (CPU)."""
import json
import os
import re

import pytest

from portbench import bench, traffic
from portbench import yardstick as Y

SPEC = bench.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    c = bench.Cell.resolve(SPEC, cell)
    assert c.mix["mode"] in traffic.MODES
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"] if w["name"] == cell)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    for name in c.end_to_end:
        assert callable(bench.load_reader("e2e", name).read)
    for name in c.per_layer:
        assert callable(bench.load_reader("layers", name).read)
    assert len(c.counts.layers()) == len(c.reference.layers())


@pytest.mark.parametrize("kind", ["e2e", "layers"])
def test_every_reader_file_loads(kind):
    names = [f[:-3] for f in os.listdir(os.path.join(bench.HERE, kind)) if f.endswith(".py")]
    assert names and all(callable(bench.load_reader(kind, n).read) for n in names)


def test_names_units_and_keys_keep_their_rules():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + CELLS
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for text in [w["why"] for w in SPEC["workloads"] + SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("config", ["resnet50", "vgg16"])
def test_frozen_counts_match_the_published_multiply_adds(config):
    counts = bench.importlib.import_module(f"portbench.counts.{config}")
    macs = sum(Y.macs(layer) for layer in counts.layers())
    assert macs == counts.MACS_PER_IMAGE
    assert abs(macs / counts.PUBLISHED_MACS - 1) < 0.02


def test_configs_are_uncut_and_their_files_exist():
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(bench.ROOT, c["file"])) and c["reduced"] == []
        assert bench._json(c["file"])["name"] == c["name"]


def test_roofline_bound_is_the_larger_of_compute_and_bytes():
    counts = bench.importlib.import_module("portbench.counts.resnet50")
    layer = counts.layers()[1]  # res2a_1: 1x1, 64 -> 64 at 56x56
    b = 128
    assert Y.flops(layer, b) == 2 * b * 56 * 56 * 64 * 64
    assert Y.nbytes(layer, b) == 4 * (2 * b * 56 * 56 * 64 + 64 * 64 + 64)
    assert Y.bound_s(layer, b) == pytest.approx(Y.nbytes(layer, b) / Y.PEAK_BYTES)


def test_a_cell_kept_for_later_is_made_from_its_files():
    later = bench.Cell.named(SPEC, "resnet50.offline.card.b128")
    assert later.config["name"] == "resnet50" and later.mix["ingress"] == "card"
    assert later.end_to_end == ["setup_s"] and later.per_layer == []  # no metric names it yet
    assert bench.Cell.named(SPEC, CELLS[0]).end_to_end == bench.Cell.resolve(SPEC, CELLS[0]).end_to_end
