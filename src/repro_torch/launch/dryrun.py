"""Dry run on one card: the shapes, memory and roofline terms of every
(architecture x input shape), traced on the ``meta`` device.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step on a fake 256- or 512-chip mesh and reads XLA's analyses; the
port has one card, so it runs its own step (``make_train_step`` with
AdamW on the f32 parameters; the prefill or one decode step through the
route that serves, ``backend=None``, so B5 and B6 count as kernels, on
the serving form, whose blocks are held in the compute dtype only) on
``meta`` tensors under ``roofline/analysis.py``'s counters, with the
card's peaks:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape decode_32k [--card H100] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --card H100

On a host with a card the peaks and memory are the detected card's; on
a host without one ``--card`` names the product (no default).

**Scaled traces.**  A ``meta`` op costs the same at any size, but the
port's prefill and train steps run loops whose trip counts grow with
the sequence: the blocked attention's (query chunk, key chunk) blocks,
the cross-entropy's chunks, the SSD scan's chunks and the sLSTM's time
steps.  Every trip is the same ops on the same shapes, so at a sequence
of ``n`` units (``u`` tokens, the least common multiple of the chunk
sizes the step loops over) each count is a polynomial in ``n``: of degree 2 with
attention (``n^2`` blocks), else 1.  Where the shape is long, the step
is traced at ``deg + 2`` shorter sequences of the same batch, every one
at least the longest attention window (the caches' and the windows'
sizes stay fixed there), the counts fitted exactly (integer finite
differences) on the first ``deg + 1`` and checked against the last.
The peak of live bytes is the largest of the peaks of the step's regions
(call stacks, ``roofline/analysis.py``), and which region holds it can
change with the length (SmolLM-360M's prefill: the attention's blocks up
to 6 units, the FFN's temporaries past 7), so each region's peak is
fitted and checked as the counts are, and the largest taken at the full
length.  Where a count misses its check the window moves up one unit,
and a count that misses it up to the full length raises.  A prefill's
traced lengths are themselves fitted over depth where that is cheaper:
the layers of a group are the same ops too (:func:`_counts`).  The arguments
(parameters, the optimizer state, the batch, the caches) are counted at
the full shape.  The record's ``"scaled"`` says which lengths and group
sizes were traced.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from fractions import Fraction
from math import comb
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ..configs import ARCHS, SHAPES, get_config
from ..configs.shapes import InputShape
from ..models import abstract_params, layer_groups
from ..models.config import ModelConfig
from ..models.model import N_META_TOKENS
from ..models.ssm import SLSTM_REMAT_CHUNK
from ..optim import adamw_init
from ..roofline.analysis import (
    CardPeaks,
    StepTrace,
    card_peaks,
    count_params,
    model_flops,
    storage_bytes,
    terms_of,
    trace_step,
)
from .specs import input_specs
from .steps import make_prefill_step, make_serve_step, make_train_step

ATTN_KINDS = ("dense", "moe", "hymba")


def detect_card(card: Optional[str] = None) -> Tuple[str, CardPeaks, float]:
    """(name, peaks, memory GB) of the card: the detected one on a host with
    CUDA (``card``, if given, must name the same product), else the
    product ``card`` names; with neither it raises."""
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        peaks = card_peaks(name)
        if card is not None and card_peaks(card) != peaks:
            raise ValueError(f"card {card!r} is not the detected {name!r}")
        return name, peaks, torch.cuda.get_device_properties(0).total_memory / 1e9
    if card is None:
        raise ValueError("no CUDA card on this host: name the card (card=, --card), e.g. 'H100'")
    peaks = card_peaks(card)
    return card, peaks, peaks.memory_gb


def step_model(cfg: ModelConfig, kind: str):
    """The model a ``kind`` step runs on, on ``meta``: the f32 parameters
    for training, the serving form (``launch/serve.py``'s) for a prefill
    or a decode step."""
    return abstract_params(cfg, serving=kind != "train")


def _step_args(cfg: ModelConfig, model, shape: InputShape) -> Tuple[Any, Tuple[Any, ...], Dict[str, Any]]:
    """(step, its arguments, the arguments by part) on ``meta`` tensors,
    ``model`` being :func:`step_model`'s."""
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = adamw_init(dict(model.named_parameters()))
        return make_train_step(cfg), (model, opt, specs["batch"]), {
            "optimizer": opt, "batch": specs["batch"]}
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (model, specs["batch"], specs["caches"]), {
            "batch": specs["batch"], "caches": specs["caches"]}
    return make_serve_step(cfg), (model, specs["caches"], specs["tokens"], specs["pos"]), {
        "batch": {"tokens": specs["tokens"], "pos": specs["pos"]}, "caches": specs["caches"]}


def argument_parts(model, parts: Dict[str, Any]) -> Dict[str, int]:
    """Bytes of the step's arguments by part: the parameters, any other
    storage the model holds (``compute_copy``: the blocks' compute-dtype
    copy of a two-copy model, none in :func:`step_model`'s), the
    optimizer state, the batch and the caches."""
    params = storage_bytes(list(model.parameters()))
    every = storage_bytes(model)
    out = {"params": sum(params.values()),
           "compute_copy": sum(nb for key, nb in every.items() if key not in params)}
    for name, obj in parts.items():
        out[name] = sum(storage_bytes(obj).values())
    return out


def _trace(cfg: ModelConfig, model, shape: InputShape) -> StepTrace:
    step, args, _ = _step_args(cfg, model, shape)
    return trace_step(step, *args)[0]


def _flat(trace: StepTrace) -> Dict[str, int]:
    """The trace's counts by name, each region's peak among them (the
    step's own peak, the largest, is not: it is fitted region by region)."""
    out = {"flops": trace.flops, "bytes": trace.bytes, "output_bytes": trace.output_bytes,
           "alias_bytes": trace.alias_bytes}
    for name, rec in trace.kernels.items():
        for key, val in rec.items():
            out[f"kernel:{name}:{key}"] = val
    for name, val in trace.regions.items():
        out[f"region|{name}"] = val
    return out


def scale_unit(cfg: ModelConfig, kind: str) -> Tuple[int, int, int]:
    """(unit tokens u, least units n0 a scaled trace takes, degree) of a
    ``kind`` step: u the least common multiple of the chunk sizes the step
    loops over (the attention's blocks, the SSD scan's chunks, and in
    training the cross-entropy's chunks and the sLSTM's checkpointed
    ones); n0 two units at least (at one, the blocked attention's single
    block holds other temporaries) and enough for the longest attention
    window and the sequence's prefix (image patches, meta tokens); degree
    2 with attention."""
    kinds = {g.kind for g in layer_groups(cfg)}
    attn = bool(kinds & set(ATTN_KINDS))
    chunks = [cfg.ssd_chunk] + ([cfg.attn_chunk] if attn else [])
    if kind == "train":
        chunks += [cfg.loss_chunk] + ([SLSTM_REMAT_CHUNK] if "slstm" in kinds else [])
    unit = math.lcm(*chunks)
    prefix = (cfg.n_patches or 0) + (N_META_TOKENS if cfg.block_kind == "hymba" else 0)
    n0 = max(2, -(-max(cfg.sliding_window, prefix + 1) // unit))
    return unit, n0, 2 if attn else 1


def with_group_sizes(cfg: ModelConfig, sizes: List[int]) -> ModelConfig:
    """``cfg`` with the same layer groups (kinds and windows, in order), of
    ``sizes`` layers each; raises where the config cannot say so (xLSTM's
    runs of mLSTM layers share one length)."""
    groups = layer_groups(cfg)
    n = sum(sizes)
    if cfg.block_kind == "xlstm":
        runs = {s for g, s in zip(groups, sizes) if g.kind == "mlstm"}
        out = dataclasses.replace(cfg, n_layers=n, slstm_every=runs.pop() + 1 if cfg.slstm_every and runs else 0)
    elif cfg.block_kind == "hymba":
        full, off = [], 0
        for g, size in zip(groups, sizes):
            if not g.window:
                full.extend(range(off, off + size))
            off += size
        out = dataclasses.replace(cfg, n_layers=n, full_attn_layers=tuple(full))
    elif cfg.block_kind == "moe":
        out = dataclasses.replace(cfg, n_layers=n, first_dense_layers=sizes[0] if cfg.first_dense_layers else 0)
    else:
        out = dataclasses.replace(cfg, n_layers=n)
    got = [(g.kind, g.window, g.n) for g in layer_groups(out)]
    if got != [(g.kind, g.window, size) for g, size in zip(groups, sizes)]:
        raise ValueError(f"{cfg.name}: no config has the groups {sizes}; got {got}")
    return out


def _counts(cfg: ModelConfig, model, shape: InputShape) -> Tuple[Dict[str, int], Optional[Dict[str, Any]]]:
    """The step's counts at ``shape`` (``_flat``'s), and how they were
    fitted over depth, or None.  The layers of a group are the same ops on
    the same shapes, so in a prefill every count is affine in the number
    of layers of each class of groups (kind and window) holding more than
    4, the peak's regions too (a layer's temporaries are freed before the
    next layer runs): the step is traced with those groups at ``b``
    layers, with each class's at ``b + 1`` and with all at ``b + 2``, the
    counts fitted exactly on the first and checked on the last, from
    ``b = 2``; a missed check moves ``b`` up.  A train step is traced at
    its full depth: its peak gathers across the layers (the saved
    activations, the optimizer's new moments) and the region that holds
    it can change far past any depth a check reaches (SmolLM-360M's
    optimizer: the embedding's temporaries up to some depth, the moments
    of every layer past it).  Where the traces would hold as many layers
    as the model, the step is traced whole."""
    groups = layer_groups(cfg)
    classes: Dict[Tuple[str, int], List[int]] = {}
    for i, g in enumerate(groups):
        if g.n > 4:
            classes.setdefault((g.kind, g.window), []).append(i)
    flats: Dict[Tuple[int, ...], Dict[str, int]] = {}

    def flat_of(sizes: List[int]) -> Dict[str, int]:
        key = tuple(sizes)
        if key not in flats:
            c = with_group_sizes(cfg, sizes)
            flats[key] = _flat(_trace(c, step_model(c, shape.kind), shape))
        return flats[key]

    for b in range(2, cfg.n_layers):
        base = [b if g.n > 4 else g.n for g in groups]

        def grown(by: Dict[Tuple[str, int], int]) -> List[int]:
            return [s + by.get((g.kind, g.window), 0) if g.n > 4 else s for g, s in zip(groups, base)]

        plans = [grown({})] + [grown({k: 1}) for k in classes] + [grown({k: 2 for k in classes})]
        if shape.kind != "prefill" or not classes or sum(map(sum, {tuple(p) for p in plans} | set(flats))) \
                >= cfg.n_layers:
            break
        try:
            base_f, *grown_f, check_f = [flat_of(p) for p in plans]
        except ValueError:  # no config has these groups
            break
        full: Dict[str, int] = {}
        for key in set().union(base_f, check_f, *grown_f):
            y0 = base_f.get(key, 0)
            per_layer = [Fraction(f.get(key, 0) - y0, len(classes[k])) for k, f in zip(classes, grown_f)]
            if y0 + sum(2 * p * len(classes[k]) for k, p in zip(classes, per_layer)) != check_f.get(key, 0):
                break
            full[key] = y0 + sum(p * sum(groups[i].n - b for i in classes[k]) for k, p in zip(classes, per_layer))
        else:
            if all(v.denominator == 1 for v in full.values()):
                return {k: int(v) for k, v in full.items()}, {
                    "group_sizes_traced": sorted(map(list, flats)), "fitted_at": plans[:-1],
                    "checked_at": plans[-1], "group_sizes": [g.n for g in groups]}
    return _flat(_trace(cfg, model, shape)), None


def _from_counts(full: Dict[str, int], args) -> StepTrace:
    """A trace from fitted counts, the arguments counted as they are."""
    kernels: Dict[str, Dict[str, int]] = {}
    regions: Dict[str, int] = {}
    for key, val in full.items():
        if key.startswith("kernel:"):
            _, name, field = key.split(":")
            kernels.setdefault(name, {})[field] = val
        elif key.startswith("region|"):
            regions[key.split("|", 1)[1]] = val
    new_out = full["output_bytes"] - full["alias_bytes"]
    return StepTrace(flops=full["flops"], bytes=full["bytes"], kernels=kernels,
                     argument_bytes=sum(storage_bytes(args).values()),
                     output_bytes=full["output_bytes"], alias_bytes=full["alias_bytes"],
                     temp_bytes=max(0, max(regions.values(), default=0) - new_out), regions=regions)


def scaled_trace(cfg: ModelConfig, model, shape: InputShape) -> Tuple[StepTrace, Optional[Dict[str, Any]]]:
    """The step's trace at ``shape``: traced whole, or fitted from shorter
    traces (the module's docstring) and shallower ones (:func:`_counts`)
    where that is exact and cheaper.  Returns (trace, the record's
    ``"scaled"`` entry or None)."""
    unit, n0, deg = scale_unit(cfg, shape.kind)
    n_full, rem = divmod(shape.seq_len, unit)
    _, args, _ = _step_args(cfg, model, shape)
    if shape.kind == "decode" or rem or n_full <= 2 * (n0 + deg + 1):
        full, depth = _counts(cfg, model, shape)
        return _from_counts(full, args), depth and {"depth": depth}
    flats: Dict[int, Dict[str, int]] = {}
    depth = None

    def flat_at(n: int) -> Dict[str, int]:
        nonlocal depth
        if n not in flats:
            s = n * unit
            flats[n], depth = _counts(cfg, model, InputShape(f"{shape.name}@{s}", s, shape.global_batch,
                                                             shape.kind))
        return flats[n]

    def at(y: List[int], k: int) -> int:  # Newton's forward differences from the window's start
        diffs, row = [], y[:deg + 1]
        while row:
            diffs.append(row[0])
            row = [b - a for a, b in zip(row, row[1:])]
        return sum(comb(k, j) * d for j, d in enumerate(diffs))

    # a count that holds its polynomial only past some length (a region's
    # peak where a block of constant size sits in it) moves the window of
    # traced lengths up until every count checks
    start = n0
    while True:
        window = [flat_at(start + k) for k in range(deg + 2)]
        ys = {key: [f.get(key, 0) for f in window] for key in sorted(set().union(*window))}
        missed = {key: (y[-1], at(y, deg + 1)) for key, y in ys.items() if at(y, deg + 1) != y[-1]}
        if not missed:
            break
        if start + deg + 2 >= n_full:
            raise RuntimeError(f"{cfg.name} {shape.name}: counts are not a degree-{deg} polynomial in the "
                               f"sequence's {unit}-token units up to {(start + deg + 1) * unit}: {missed}")
        start += 1
    lens = [(start + k) * unit for k in range(deg + 2)]
    trace = _from_counts({key: at(y, n_full - start) for key, y in ys.items()}, args)
    return trace, {"traced_seq_lens": sorted(n * unit for n in flats), "fitted_at": lens[:-1],
                   "checked_at": lens[-1], "unit_tokens": unit, "degree": deg, "depth": depth,
                   "why": "every trip of the step's loops is the same ops on the same shapes; the "
                          "peak of live bytes fitted and checked region by region, its largest taken"}


def run_one(arch: Union[str, ModelConfig], shape_name: Union[str, InputShape],
            card: Optional[str] = None) -> dict:
    """The dry-run record of one (arch x shape) on one card: ``arch`` names
    a config of ``configs/`` or is a ``ModelConfig`` (a reduced one in the
    tests), ``shape_name`` names a shape of ``configs/shapes.py`` or is an
    ``InputShape``; ``card`` as :func:`detect_card`."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    arch = cfg.name
    shape = shape_name if isinstance(shape_name, InputShape) else SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return {
            "arch": arch, "shape": shape.name, "status": "skipped",
            "reason": "pure full attention — long_500k requires sub-quadratic decode (DESIGN.md §4)",
        }
    name, peaks, mem_gb = detect_card(card)
    model = step_model(cfg, shape.kind)
    t0 = time.perf_counter()
    trace, scaled = scaled_trace(cfg, model, shape)
    trace_s = time.perf_counter() - t0
    arg_parts = argument_parts(model, _step_args(cfg, model, shape)[2])
    terms = terms_of(trace).finalize(model_flops(cfg, model, shape), peaks)
    total, active = count_params(cfg, model)
    fitted = [f"lengths {scaled['traced_seq_lens']}"] if scaled and "traced_seq_lens" in scaled else []
    if scaled and scaled["depth"]:
        fitted.append(f"group sizes {scaled['depth']['group_sizes_traced']}")
    print(f"[{arch} x {shape.name} | one {name}] trace {trace_s:.1f}s"
          + (f" (fitted from {' and '.join(fitted)})" if fitted else ""))
    print(f"  memory: argument {trace.argument_bytes / 1e9:.3f} GB, output {trace.output_bytes / 1e9:.3f}, "
          f"temp {trace.temp_bytes / 1e9:.3f}, alias {trace.alias_bytes / 1e9:.3f} -> "
          f"{terms.memory_per_chip_gb:.3f} GB of {mem_gb:.1f}")
    print(f"  roofline: compute={terms.compute_s * 1e3:.3f}ms memory={terms.memory_s * 1e3:.3f}ms "
          f"-> {terms.bottleneck}-bound; useful_ratio={terms.useful_ratio:.3f}")
    return {
        "arch": arch,
        "shape": shape.name,
        "status": "ok",
        "n_chips": 1,
        "card": name,
        "card_memory_gb": mem_gb,
        "trace_s": round(trace_s, 2),
        "params_total": total,
        "params_active": active,
        "memory": {
            "argument_bytes": trace.argument_bytes,
            "output_bytes": trace.output_bytes,
            "temp_bytes": trace.temp_bytes,
            "alias_bytes": trace.alias_bytes,
            "per_chip_gb": terms.memory_per_chip_gb,
            "fits": terms.memory_per_chip_gb <= mem_gb,
            "argument_parts": arg_parts,
        },
        "roofline": terms.to_dict(),
        "kernel_calls": trace.kernels,
        "op_flops": trace.flops,
        "op_bytes": trace.bytes,
        "scaled": scaled,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true", help="every arch x shape")
    ap.add_argument("--card", default=None,
                    help="the card's product (H100, H100 PCIe, H100 NVL); required on a host without one")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    args = ap.parse_args()
    try:
        detect_card(args.card)
    except (KeyError, ValueError) as e:
        ap.error(str(e))

    if args.all:
        combos = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        combos = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, args.card)
        except Exception as e:  # the record says what failed; the exit code counts it
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "status": "error", "error": f"{type(e).__name__}: {e}"}
            failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
