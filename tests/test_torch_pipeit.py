"""The port's Pipe-it over a node's cards (``core/gpu_pipeit.py``)
against the reference's over a pod's model axis
(``repro/core/tpu_pipeit.py``).

Given the reference's own constants (read from its module), 16 chips
and its data axis of 16 (``data_shards=16``), the port's layer costs,
time matrix and plans equal the reference's with ``==``.  Under the
H100's rates (``roofline/analysis.py::card_peaks``: bf16 989 TFLOP/s,
3.35 TB/s, NVLink 450 GB/s a direction) on a node of 8 the plans are
valid partitions no slower than tensor parallelism over all 8, a big
layer's speedup is concave, and the small-layer regime is what the rates
compute: the reference's test has 16-way tensor parallelism of a SmolLM
layer slower than one chip, which does not hold over NVLink.
"""
from __future__ import annotations

import dataclasses

import pytest

import repro.core.tpu_pipeit as TP
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core import gpu_pipeit as GP
from repro_torch.roofline.analysis import PEAKS

REF_RATES = GP.Rates(peak=TP.PEAK, hbm=TP.HBM, link=TP.ICI, handoff_s=TP.HANDOFF_S)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_costs_equal_reference(arch):
    for seq in (4096, 32768):
        got = [dataclasses.astuple(c) for c in GP.layer_costs(get_config(arch), seq)]
        want = [dataclasses.astuple(c) for c in TP.layer_costs(ref_config(arch), seq)]
        assert got == want


@pytest.mark.parametrize("arch", ["smollm-360m", "olmoe-1b-7b", "xlstm-1.3b"])
def test_time_matrix_and_plan_equal_reference_under_its_constants(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in ("decode_32k", "train_4k"):
        sh = SHAPES[shape]
        tokens = sh.global_batch / 16 if sh.kind == "decode" else sh.global_batch * sh.seq_len / 16
        assert GP.time_matrix(GP.layer_costs(cfg, sh.seq_len), 16, tokens, REF_RATES) == \
            TP.time_matrix(TP.layer_costs(rcfg, sh.seq_len), 16, tokens)
    plat, ref_plat = GP.gpu_platform(16, REF_RATES), TP.tpu_platform(16)
    assert (plat.boundary_bytes_per_s, plat.boundary_latency_s) == \
        (ref_plat.boundary_bytes_per_s, ref_plat.boundary_latency_s)
    plan, stats = GP.plan_stages(cfg, SHAPES["decode_32k"], n_cards=16, data_shards=16, rates=REF_RATES)
    ref_plan, ref_stats = TP.plan_stages(rcfg, REF_SHAPES["decode_32k"], n_chips=16)
    assert plan.pipeline.stages == ref_plan.pipeline.stages
    assert plan.allocation == ref_plan.allocation
    assert stats == ref_stats


def test_h100_rates_come_from_the_card_table():
    rates = GP.card_rates("NVIDIA H100 80GB HBM3")
    h100 = PEAKS["H100"]
    assert (rates.peak, rates.hbm, rates.link) == (h100.bf16_flops, h100.hbm_bytes_per_s, h100.nvlink_bytes_per_s)
    assert rates.link == 450e9 and rates.handoff_s == GP.HANDOFF_S
    plat = GP.gpu_platform()
    assert plat.core_types[0].count == 8 and plat.boundary_bytes_per_s == 450e9


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_h100_plans_are_valid_and_no_slower_than_tensor_parallelism(arch, shape):
    cfg = get_config(arch)
    plan, stats = GP.plan_stages(cfg, SHAPES[shape])
    flat = [layer for stage in plan.allocation for layer in stage]
    assert flat == list(range(cfg.n_layers))
    assert sum(n for _, n in plan.pipeline.stages) <= 8
    assert stats["pipeline_steps_per_s"] >= stats["tp_baseline_steps_per_s"] * 0.999
    sh = SHAPES[shape]
    assert stats["tokens_per_step"] == (sh.global_batch if sh.kind == "decode" else sh.global_batch * sh.seq_len)


def test_h100_speedup_regimes():
    """Weight-streaming decode of a big layer speeds up near-linearly and
    concavely with cards.  A small layer's token-heavy step still speeds
    up over NVLink: 8-way tensor parallelism of a SmolLM layer at 65,536
    tokens takes 1.207 ms against 1.824 ms on one card (1.51x), where
    over the reference's ICI 16 chips are slower than one."""
    big = get_config("command-r-plus-104b")
    T = GP.time_matrix(GP.layer_costs(big, 32768), 8, tokens_per_step=8)
    t = [T[0][("c", n)] for n in range(1, 9)]
    sp = [t[0] / x for x in t]
    assert 7.5 < sp[-1] <= 8.0
    gains = [b - a for a, b in zip(sp, sp[1:])]
    assert all(g1 >= g2 - 1e-12 for g1, g2 in zip(gains, gains[1:]))  # concave

    small = get_config("smollm-360m")
    T2 = GP.time_matrix(GP.layer_costs(small, 4096), 8, tokens_per_step=65536)
    t2 = [T2[0][("c", n)] for n in range(1, 9)]
    assert t2[0] == pytest.approx(1.8239e-3, rel=1e-4)
    assert t2[7] == pytest.approx(1.2067e-3, rel=1e-4)
    assert all(a > b for a, b in zip(t2, t2[1:]))  # no collapse: every card more is faster
    assert t2[0] / t2[7] < 2.0  # but far from linear: the all-reduces hold it back
