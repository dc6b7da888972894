"""The port's dry run on the ``meta`` device: specs, parameter counts and
model FLOPs against the JAX package, the roofline counters on
hand-counted cases, the kernels' calls in a traced step, and
``run_one`` on every reduced block kind.

Counts are integers and are compared with ``==``: the specs' shapes and
dtypes, ``count_params`` and ``model_flops`` with the reference's, the
FLOPs of a product, the bytes of each counting rule, the kernels' costs
with ``roofline/analysis.py``'s cost functions, and a scaled trace with
the whole one.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import abstract_params as ref_abstract_params
from repro.roofline.analysis import RooflineTerms as RefRooflineTerms
from repro.roofline.analysis import count_params as ref_count_params
from repro.roofline.analysis import model_flops as ref_model_flops
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch.specs import cache_abstract, input_specs
from repro_torch.models import abstract_params, layer_groups
from repro_torch.models.model import N_META_TOKENS
from repro_torch.roofline.analysis import (
    PEAKS,
    analyze_step,
    card_peaks,
    count_params,
    flash_decode_cost,
    model_flops,
    ssd_cost,
    trace_step,
)

torch.set_num_threads(1)
META = torch.device("meta")


def _flat(obj, path=""):
    """{keystr path: (shape, dtype name)} in ``jax.tree_util.keystr``'s form."""
    if isinstance(obj, torch.Tensor):
        return {path: (tuple(obj.shape), str(obj.dtype).split(".")[-1])}
    out = {}
    items = sorted(obj.items()) if isinstance(obj, dict) else enumerate(obj)
    for key, val in items:
        out.update(_flat(val, f"{path}[{key!r}]"))
    return out


def _ref_flat(tree):
    return {jax.tree_util.keystr(p): (tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------ specs
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    cfg = get_config(arch)
    got = input_specs(cfg, SHAPES[shape])
    assert all(t.device == META for t in jax.tree_util.tree_leaves(got)
               if isinstance(t, torch.Tensor))
    assert _flat(got) == _ref_flat(ref_input_specs(ref_config(arch), REF_SHAPES[shape]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_abstract_matches_reference_eval_shape(arch):
    from repro.launch.specs import cache_abstract as ref_cache_abstract

    shape = SHAPES["decode_32k"]
    assert _flat(cache_abstract(get_config(arch), shape)) == _ref_flat(
        ref_cache_abstract(ref_config(arch), REF_SHAPES["decode_32k"]))


# ------------------------------------------------- parameters and FLOPs
@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    model, ref_abs = abstract_params(cfg), ref_abstract_params(rcfg)
    assert count_params(cfg, model) == ref_count_params(rcfg, ref_abs)
    for name in SHAPES:
        assert model_flops(cfg, model, SHAPES[name]) == ref_model_flops(rcfg, ref_abs, REF_SHAPES[name])


def test_roofline_terms_keep_the_reference_fields():
    fields = [f.name for f in dataclasses.fields(RefRooflineTerms)]
    terms, trace = analyze_step(lambda a, b: a @ b, torch.empty(4, 8, device=META),
                                torch.empty(8, 2, device=META), peaks=card_peaks("H100"), model_flops=64.0)
    assert list(terms.to_dict()) == fields
    assert terms.n_chips == 1 and terms.collectives == {} and terms.collective_s == 0.0
    assert terms.flops_per_chip == trace.flops == 2 * 4 * 8 * 2 and terms.useful_ratio == 0.5
    assert terms.compute_s == 128 / 989e12 and terms.memory_s == 4 * (32 + 16 + 8) / 3.35e12
    assert terms.bottleneck == "memory"


# ------------------------------------------------------ the counters
def test_one_mm_counted_exactly():
    m, k, n = 96, 160, 48
    a = torch.empty(m, k, device=META)
    b = torch.empty(k, n, device=META, dtype=torch.float32)
    trace, out = trace_step(lambda x, y: x @ y, a, b)
    assert trace.flops == 2 * m * k * n
    assert trace.bytes == 4 * (m * k + k * n + m * n)
    assert trace.argument_bytes == 4 * (m * k + k * n)
    assert trace.output_bytes == 4 * m * n and trace.alias_bytes == 0
    assert trace.temp_bytes == 0 and trace.kernels == {}
    assert out.shape == (m, n) and out.device == META


def test_byte_rules():
    """A view moves nothing; an out-of-place op reads its inputs and writes
    its output; an in-place op's output (an alias) adds nothing; a
    broadcast input is read once; an empty allocation writes nothing; an
    indexed write moves its indices and source and the slots it writes; a
    temporary is live until it is freed."""
    x = torch.empty(64, 32, device=META)
    y = torch.empty(1, 32, device=META).expand(64, 32)
    cache = torch.empty(1000, 32, device=META, dtype=torch.bfloat16)
    src = torch.empty(3, 32, device=META, dtype=torch.bfloat16)
    idx = torch.empty(3, device=META, dtype=torch.long)

    assert trace_step(lambda t: t.view(32, 64).t()[:4], x)[0].bytes == 0
    assert trace_step(lambda t, u: t + u, x, x)[0].bytes == 2 * 64 * 32 * 4  # x read once, out written
    assert trace_step(lambda t, u: t + u, x, y)[0].bytes == (64 * 32 + 32 + 64 * 32) * 4
    assert trace_step(lambda t, u: t.add_(u), x, y)[0].bytes == (64 * 32 + 32) * 4
    assert trace_step(lambda: torch.empty(1 << 20, device=META))[0].bytes == 0
    trace, _ = trace_step(lambda c, i, s: c.index_copy_(0, i, s), cache, idx, src)
    assert trace.bytes == 3 * 8 + 2 * 3 * 32 * 2
    assert trace.alias_bytes == trace.output_bytes == 1000 * 32 * 2

    def temp_then_small(t):
        big = t.repeat(4, 1)  # 4x the input, freed before the return
        return big.sum(0)

    trace, _ = trace_step(temp_then_small, x)
    assert trace.output_bytes == 32 * 4
    assert trace.temp_bytes == 4 * 64 * 32 * 4  # the peak: big, before its sum exists
    assert trace.peak_bytes == trace.argument_bytes + trace.output_bytes + trace.temp_bytes
    assert max(trace.regions.values()) == trace.temp_bytes + trace.output_bytes


def test_reduced_smollm_prefill_flops_counted_from_the_code():
    """Every product of a reduced SmolLM prefill, counted from
    ``models/blocks.py`` and ``models/attention.py``: per layer the q, k,
    v and o projections, the blocked attention's QK^T and PV over every
    (query chunk, key chunk) block, and the gated FFN's three products."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), n_layers=3)
    b, s = 2, 320
    model = D.step_model(cfg, "prefill")  # the serving form: the blocks in bf16 only
    step, args, _ = D._step_args(cfg, model, InputShape("p", s, b, "prefill"))
    trace, _ = trace_step(step, *args)
    d, h, hkv, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    c = cfg.attn_chunk
    blocks = (-(-s // c)) ** 2
    proj = 2 * b * s * d * (2 * h * dh + 2 * hkv * dh)
    attn = 2 * (2 * b * h * c * c * dh) * blocks
    ffn = 3 * 2 * b * s * d * ff
    assert cfg.glu and trace.kernels == {}
    assert trace.flops == cfg.n_layers * (proj + attn + ffn)
    bf16, f32 = 2, 4
    cache = cfg.n_layers * b * s * hkv * dh * 2 * bf16 + cfg.n_layers * s * 4
    assert D.argument_parts(model, {"caches": args[2]})["caches"] == cache
    block = sum(p.numel() for p in model.groups.parameters())
    assert trace.argument_bytes == (sum(p.numel() for p in model.parameters()) - block) * f32 + \
        block * bf16 + b * s * 4 + cache


def test_reduced_hymba_kernel_calls_with_their_cost():
    """The decode step counts one B5 call an attention layer, over every
    slot of the layer's cache (its length on the device is not read); the
    prefill one B6 call a layer, Hymba's B and C broadcast over the heads."""
    cfg = get_config("hymba-1.5b").reduced()
    b, s = 2, 384
    model = D.step_model(cfg, "decode")
    step, args, _ = D._step_args(cfg, model, InputShape("d", s, b, "decode"))
    trace, _ = trace_step(step, *args)
    hkv, g, dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.resolved_head_dim
    want = [0, 0, 0]
    for grp in layer_groups(cfg):
        w = min(s, grp.window) if grp.window else s
        for _ in range(grp.n):
            f, nb = flash_decode_cost(b, hkv, g, dh, w)
            want = [want[0] + 1, want[1] + f, want[2] + nb]
    assert sum(grp.n for grp in layer_groups(cfg)) == cfg.n_layers == want[0]
    assert trace.kernels == {"flash_decode": dict(zip(("calls", "flops", "bytes"), want))}

    step, args, _ = D._step_args(cfg, model, InputShape("p", s, b, "prefill"))
    trace, _ = trace_step(step, *args)
    nh = cfg.d_inner // 64
    chunk = min(cfg.ssd_chunk, s)
    f, nb = ssd_cost(b, s, nh, cfg.ssm_state, 64, chunk, bc_heads=1)
    assert s % chunk == 0 and N_META_TOKENS < s
    assert trace.kernels == {"ssd": {"calls": cfg.n_layers, "flops": cfg.n_layers * f,
                                     "bytes": cfg.n_layers * nb}}


def test_kernel_wrappers_on_meta_launch_nothing():
    from repro_torch.kernels import ops
    from repro_torch.kernels import runtime

    before = runtime.launch_counts()
    q = torch.empty(2, 2, 3, 64, device=META, dtype=torch.bfloat16)
    kv = torch.empty(2, 50, 2, 64, device=META, dtype=torch.bfloat16)
    y = ops.flash_decode(q, kv, kv, 7)  # no counter active: nothing recorded, nothing raised
    assert y.shape == q.shape and y.dtype == q.dtype and y.device == META
    trace, _ = trace_step(lambda: ops.flash_decode(q, kv, kv, 7))
    assert trace.kernels["flash_decode"] == dict(zip(("calls", "flops", "bytes"),
                                                     (1, *flash_decode_cost(2, 2, 3, 64, 7))))
    x = torch.empty(2, 100, 4, 64, device=META, dtype=torch.bfloat16)
    la = torch.empty(2, 100, 4, device=META)
    bc = torch.empty(2, 100, 4, 32, device=META, dtype=torch.bfloat16)
    trace, out = trace_step(lambda: ops.ssd(x, la, bc, bc, chunk=64, normalizer=True))
    assert [tuple(t.shape) for t in out] == [(2, 100, 4, 64), (2, 4, 32, 64), (2, 100, 4), (2, 4, 32)]
    assert trace.kernels["ssd"] == dict(zip(("calls", "flops", "bytes"), (1, *ssd_cost(
        2, 128, 4, 32, 64, 64, normalizer=True, la_bytes=4))))  # S padded to the chunk
    assert runtime.launch_counts() == before


# ------------------------------------------------------------- run_one
KINDS = {"dense": "smollm-360m", "moe": "olmoe-1b-7b", "hymba": "hymba-1.5b", "xlstm": "xlstm-1.3b",
         "patches": "paligemma-3b", "codebooks": "musicgen-large"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("block", list(KINDS))
def test_run_one_on_every_reduced_block_kind(block, kind):
    # one micro-batch (reduced xLSTM accumulates over 4) keeps the sLSTM's traced loop short
    cfg = dataclasses.replace(get_config(KINDS[block]).reduced(), grad_accum=1)
    shape = InputShape(f"{kind}_256", 256, 2, kind)
    rec = D.run_one(cfg, shape, card="H100")
    assert rec["status"] == "ok" and rec["n_chips"] == 1 and rec["card"] == "H100"
    assert (rec["params_total"], rec["params_active"]) == count_params(cfg, abstract_params(cfg))
    mem, roof = rec["memory"], rec["roofline"]
    parts = mem["argument_parts"]
    assert mem["argument_bytes"] == sum(parts.values())
    assert parts["compute_copy"] == 0
    if kind == "train":  # f32 m and v, and the int32 step; the parameters updated in place
        assert parts["params"] == 4 * rec["params_total"]
        assert parts["optimizer"] == 8 * rec["params_total"] + 4
        assert mem["alias_bytes"] == parts["params"]
    else:  # the serving form: the blocks in bf16 only, the rest in f32
        block = sum(p.numel() for p in abstract_params(cfg).groups.parameters())
        assert parts["params"] == 2 * block + 4 * (rec["params_total"] - block)
    assert mem["per_chip_gb"] * 1e9 == pytest.approx(
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"] - mem["alias_bytes"])
    assert roof["compute_s"] > 0 and roof["memory_s"] > 0 and roof["bottleneck"] in ("compute", "memory")
    assert 0 < roof["useful_ratio"]
    groups = layer_groups(cfg)
    n_attn = sum(g.n for g in groups if g.kind in D.ATTN_KINDS)
    n_scan = sum(g.n for g in groups if g.kind in ("hymba", "mlstm"))
    calls = {k: v["calls"] for k, v in rec["kernel_calls"].items()}
    want = {"train": {}, "prefill": {"ssd": n_scan} if n_scan else {},
            "decode": {"flash_decode": n_attn} if n_attn else {}}[kind]
    assert calls == want
    json.dumps(rec)


def test_starcoder2_served_decode_record_fits_one_card():
    """StarCoder2-15B's decode step at batch 4 over 896 slots (a
    768-token prompt and 128 steps, as ``chip_smoke.py`` serves it) fits
    one H100 in the serving form: 33.1 GB of weights where the two copies
    would hold 94.5, 40 B5 calls a step."""
    cfg = get_config("starcoder2-15b")
    rec = D.run_one(cfg, InputShape("decode_896", 896, 4, "decode"), card="H100")
    mem, parts = rec["memory"], rec["memory"]["argument_parts"]
    block = sum(p.numel() for p in abstract_params(cfg).groups.parameters())
    assert rec["status"] == "ok" and mem["fits"] and mem["per_chip_gb"] < 80.0
    assert parts["params"] == 2 * block + 4 * (rec["params_total"] - block)
    assert round(parts["params"] / 1e9, 1) == 33.1 and parts["compute_copy"] == 0
    assert rec["kernel_calls"]["flash_decode"]["calls"] == cfg.n_layers


@pytest.mark.parametrize("block,kind,units", [
    ("dense", "prefill", 11), ("dense", "train", 11), ("hymba", "prefill", 13), ("xlstm", "prefill", 9)])
def test_scaled_trace_equals_the_whole_trace(block, kind, units):
    cfg = get_config(KINDS[block]).reduced()
    if kind == "train":  # one layer keeps the whole trace short
        cfg = dataclasses.replace(cfg, n_layers=1)
    unit, n0, deg = D.scale_unit(cfg, kind)
    assert units > 2 * (n0 + deg + 1)
    shape = InputShape("long", units * unit, 2, kind)
    model = D.step_model(cfg, shape.kind)
    scaled, how = D.scaled_trace(cfg, model, shape)
    whole = D._trace(cfg, model, shape)
    assert how is not None and how["traced_seq_lens"][-1] < shape.seq_len
    assert scaled == whole


@pytest.mark.parametrize("block,layers", [
    ("dense", dict(n_layers=10)), ("moe", dict(n_layers=16, first_dense_layers=1)),
    ("hymba", dict(n_layers=32, full_attn_layers=(0, 16, 31)))])
def test_depth_fitted_prefill_counts_equal_the_whole_model(block, layers):
    """Every count of a prefill, the peak's regions included, fitted over
    the depth of each class of groups, equals the whole model's."""
    cfg = dataclasses.replace(get_config(KINDS[block]).reduced(), **layers)
    model = D.step_model(cfg, "prefill")
    shape = InputShape("s", 256, 2, "prefill")
    fitted, how = D._counts(cfg, model, shape)
    assert how is not None and max(map(sum, how["group_sizes_traced"])) < cfg.n_layers
    assert fitted == D._flat(D._trace(cfg, model, shape))


def test_train_step_is_traced_at_full_depth():
    """SmolLM-360M's train step at 8 x 1024: traced at depths 2-4 the
    optimizer's region holds a peak set by the embedding's temporaries,
    which a fit carried to 32 layers as 9.17 GB; traced whole, the layers'
    new moments hold it, 11.63 GB.  So a train step is never fitted over
    depth."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), n_layers=10)
    model = abstract_params(cfg)
    assert D._counts(cfg, model, InputShape("t", 256, 2, "train"))[1] is None


def test_scaled_peak_follows_the_region_that_holds_it():
    """SmolLM-360M's prefill at batch 32: up to 6 units the attention's
    blocks hold the peak, past 7 the FFN's temporaries, whose peak grows
    3.3x faster; the scaled trace fits each region's peak from 2-5 units
    and takes the largest at 16, the whole trace's peak."""
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=2)
    model = D.step_model(cfg, "prefill")
    shape = InputShape("p", 16 * 512, 32, "prefill")
    scaled, how = D.scaled_trace(cfg, model, shape)
    whole = D._trace(cfg, model, shape)
    short = D._trace(cfg, model, InputShape("p", how["traced_seq_lens"][0], 32, "prefill"))
    assert scaled == whole
    top = lambda t: max(t.regions, key=t.regions.get)  # noqa: E731
    assert top(short) != top(whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_one_skips_long_500k_where_the_reference_does(arch):
    if ref_config(arch).supports_long_context():
        rec = D.run_one(arch, "long_500k", card="H100")
        assert rec["status"] == "ok" and rec["shape"] == "long_500k"
    else:
        rec = D.run_one(arch, "long_500k", card="H100")
        assert rec["status"] == "skipped"


# ------------------------------------------------------- the card, the CLI
def test_card_peaks_and_detection():
    assert card_peaks("NVIDIA H100 80GB HBM3") is PEAKS["H100"]
    assert card_peaks("NVIDIA H100 PCIe") is PEAKS["H100 PCIe"]
    assert card_peaks("H100 NVL") is PEAKS["H100 NVL"]
    assert PEAKS["H100"].bf16_flops == 989e12 and PEAKS["H100"].hbm_bytes_per_s == 3.35e12
    with pytest.raises(KeyError):
        card_peaks("A100")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            D.detect_card(None)
        assert D.detect_card("H100") == ("H100", PEAKS["H100"], 80.0)


def test_main_exit_codes(tmp_path, monkeypatch):
    out = tmp_path / "dry.jsonl"

    def main(*argv):
        monkeypatch.setattr("sys.argv", ["dryrun", *argv])
        with pytest.raises(SystemExit) as e:
            D.main()
        return e.value.code

    assert main("--arch", "smollm-360m") == 2
    if not torch.cuda.is_available():
        assert main("--arch", "smollm-360m", "--shape", "decode_32k") == 2
    assert main("--arch", "smollm-360m", "--shape", "decode_32k", "--card", "H100", "--out", str(out)) == 0
    assert main("--arch", "smollm-360m", "--shape", "long_500k", "--card", "H100", "--out", str(out)) == 0
    assert main("--arch", "no-such-arch", "--shape", "decode_32k", "--card", "H100", "--out", str(out)) == 1
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["ok", "skipped", "error"]
    assert recs[0]["kernel_calls"]["flash_decode"]["calls"] == get_config("smollm-360m").n_layers
