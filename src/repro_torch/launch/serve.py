"""Serving launcher: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-15b \\
        --batch 4 --prompt-len 768 --gen 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --reduced --device cpu --batch 2 --prompt-len 8 --gen 4

Port of ``repro/launch/serve.py``: random weights from a seed, in the
serving form (``init_params(..., serving=True)``: the blocks held in the
compute dtype only, so StarCoder2-15B, DeepSeek-MoE-16B and
Moonlight-16B-A3B fit one 80 GB card), a random
prompt batch (``[B, S, K]`` of K codebooks for MusicGen; with
PaliGemma's vision prefix, random 1152-wide patch features before it, as
the reference stubs its vision tower), one prefill that fills the caches, then ``--gen`` greedy
decode steps (the first one re-feeds the prompt's last token, as the
reference does).  On the card each decode step runs the flash-decode
kernel (B5) in every attention layer (on an int8 KV cache for the
configs with ``kv_quant``, dequantized as it reads); Hymba's prefill
runs the SSD kernel (B6) in every layer and xLSTM's in every mLSTM
layer, with its normalizer channel; a dense or MoE prefill launches no
hand-written kernel (its attention is the plain blockwise form, as the
reference's), nor does an xLSTM decode step (its recurrent steps are
plain, as the reference's).  The
prefill runs op by op; the decode loop runs its first step op by op,
captures one step as a CUDA graph and replays it for the rest
(``launch/steps.py::GraphedServeStep``; ``generate(..., graphs=False)``
runs every step op by op).  Times are CUDA-event times taken after a
device sync.  With ``--device cpu`` the kernels' plain versions run and the times are host
clock times of the CPU, not of any device.  Every block kind of the
configs runs: dense, MoE, Hymba and xLSTM.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import torch

from ..configs import get_config
from ..kernels.config import resolve_device
from ..models import ModelConfig, init_cache, init_params
from ..models.model import N_META_TOKENS, SIGLIP_DIM, prefix_tokens
from .steps import make_eager_serve_step, make_prefill_step, make_serve_step


class _Timer:
    """CUDA events on the card (after a sync), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.kind = "cuda_events" if self.cuda else "host_clock"

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._s = self._lap = self._mark()

    def lap(self) -> None:
        """Mark a point between :meth:`start` and :meth:`stop` (no sync)."""
        self._lap = self._mark()

    def stop(self) -> float:
        """Milliseconds since :meth:`start`, the device's work included."""
        self._e = self._mark()
        return self._ms(self._s, self._e)

    def since_lap(self) -> float:
        """Milliseconds from the last :meth:`lap` to :meth:`stop`."""
        return self._ms(self._lap, self._e)

    def _ms(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def generate(
    cfg: ModelConfig,
    params,
    prompt: torch.Tensor,
    gen: int,
    backend: Optional[str] = None,
    keep_logits: int = 0,
    step_hook: Optional[Callable[[str, int], None]] = None,
    graphs: bool = True,
    patches: Optional[torch.Tensor] = None,
) -> Dict[str, object]:
    """Prefill ``prompt`` [B, S] ([B, S, K] with K codebooks), after
    ``patches`` [B, n_patches, 1152] where the config has a vision prefix,
    and decode ``gen`` greedy tokens ([B, K] a step with codebooks).

    On the card the decode steps after the first replay one CUDA graph
    (``graphs=False`` runs them op by op).  ``step_hook(phase, i)`` is
    called on the host after the prefill (``"prefill", 0``) and after each
    decode step (``"decode", i``), before anything waits for the device.
    The weights' copy in the compute dtype is made before the timers
    start.  Returns the generated tokens [B, gen], the prefill's last
    hidden state, the logits of the first ``keep_logits`` decode steps,
    the prefill and decode times, and the time a step takes from the
    third step on (``steady_ms_per_step``: the graph's replays, past the
    first step and the capture)."""
    dev = prompt.device
    b, s = prompt.shape[:2]
    if cfg.n_codebooks and (prompt.dim() != 3 or prompt.shape[2] != cfg.n_codebooks):
        raise ValueError(f"{cfg.name}: want a prompt [B, S, {cfg.n_codebooks}], got {tuple(prompt.shape)}")
    if (patches is None) != (not cfg.n_patches):
        raise ValueError(f"{cfg.name}: patches [B, {cfg.n_patches}, {SIGLIP_DIM}] go with the vision prefix "
                         f"and nothing else; got {None if patches is None else tuple(patches.shape)}")
    batch = {"tokens": prompt} if patches is None else {"tokens": prompt, "patches": patches}
    extra = prefix_tokens(cfg)
    caches = init_cache(cfg, b, max_len=s + extra + gen, device=dev)
    prefill_step = make_prefill_step(cfg, backend)
    step = (make_serve_step if graphs else make_eager_serve_step)(cfg, backend)
    timer = _Timer(dev)
    params.compute_blocks(getattr(torch, cfg.compute_dtype))  # set-up, not prefill time

    timer.start()
    last_hidden = prefill_step(params, batch, caches)
    if step_hook is not None:
        step_hook("prefill", 0)
    prefill_ms = timer.stop()

    tok = prompt[:, -1:]
    generated: List[torch.Tensor] = []
    kept: List[torch.Tensor] = []
    timer.start()
    for i in range(gen):
        if i == 2:
            timer.lap()
        logits = step(params, caches, tok, s + extra + i)
        if step_hook is not None:
            step_hook("decode", i)
        if i < keep_logits:
            kept.append(logits)
        nxt = logits.argmax(dim=-1)  # [B], or [B, K] with codebooks
        tok = nxt[:, None]
        generated.append(nxt)
    decode_ms = timer.stop()
    steady_ms = timer.since_lap() / (gen - 2) if gen > 2 else None
    return {
        "tokens": torch.stack(generated, dim=1) if generated else prompt.new_zeros((b, 0, *prompt.shape[2:])),
        "last_hidden": last_hidden,
        "logits": kept,
        "caches": caches,
        "prefill_ms": prefill_ms,
        "decode_ms": decode_ms,
        "decode_tok_per_s": gen * b / (decode_ms / 1e3) if gen else 0.0,
        "steady_ms_per_step": steady_ms,
        "timer": timer.kind,
        "max_len": s + extra + gen,
    }


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA card (raises without one)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = init_params(cfg, seed=args.seed, device=dev, serving=True)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (args.batch, args.prompt_len) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    prompt = torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)
    patches = torch.randn((args.batch, cfg.n_patches, SIGLIP_DIM), generator=g, device=dev) \
        if cfg.n_patches else None
    out = generate(cfg, params, prompt, args.gen, patches=patches)
    clock = "CUDA events" if out["timer"] == "cuda_events" else "host clock, CPU"
    before = [f"+{cfg.n_patches} image patches"] if cfg.n_patches else []
    before += [f"+{N_META_TOKENS} meta tokens"] if cfg.block_kind == "hymba" else []
    lead = f" ({', '.join(before)})" if before else ""
    books = f"x{cfg.n_codebooks} codebooks" if cfg.n_codebooks else ""
    print(f"prefill: {args.batch}x{args.prompt_len}{books}{lead} in {out['prefill_ms']:.3f} ms ({clock})")
    print(f"decode: {args.gen} steps x batch {args.batch} = {args.gen * args.batch} tokens "
          f"in {out['decode_ms']:.3f} ms -> {out['decode_tok_per_s']:,.1f} tok/s ({clock})")
    print("sample token ids:", out["tokens"][0, :8].tolist())
    return out


if __name__ == "__main__":
    main()
