"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 100 --batch 8 --seq 128 [--reduced] [--ckpt-dir ckpts]

Port of ``repro/launch/train.py``: the same flags and lines, plus
``--device`` (default: the card; ``--device cpu`` runs the plain routes
on the host) and ``--seed`` (the weights' generator and the token
stream).  Random weights from ``init_params``, AdamW with a 20-step
warmup to ``--lr`` and a cosine to ``--steps``, batches from the
synthetic token stream (``data/pipeline.py``), a checkpoint of the
parameters in the reference's layout every ``--ckpt-every`` steps.
"""
from __future__ import annotations

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from ..checkpoint import save_checkpoint
    from ..configs import get_config
    from ..data import make_batch_iterator
    from ..kernels.config import resolve_device, synchronize
    from ..models import init_params, params_to_numpy
    from ..optim import adamw_init
    from .steps import make_train_step

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} vocab={cfg.vocab_size} device={dev}")

    params = init_params(cfg, seed=args.seed, device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"params: {n_params/1e6:.1f}M")
    opt = adamw_init(dict(params.named_parameters()))
    step_fn = make_train_step(cfg, base_lr=args.lr, warmup=20, total=args.steps)
    it = make_batch_iterator(cfg, args.batch, args.seq, seed=args.seed, device=dev, prefetch=2)

    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(1, args.steps + 1):
        batch = next(it)
        params, opt, metrics = step_fn(params, opt, batch)
        tokens_done += args.batch * args.seq
        if step % args.log_every == 0 or step == 1:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            print(
                f"step {step:5d}  loss {loss:7.4f}  lr {float(metrics['lr']):.2e}  "
                f"gnorm {float(metrics['grad_norm']):.2f}  "
                f"{tokens_done/dt:,.0f} tok/s"
            )
        if args.ckpt_dir and step % args.ckpt_every == 0:
            path = save_checkpoint(
                args.ckpt_dir, step, {"params": params_to_numpy(cfg, params)},
                metadata={"arch": cfg.name, "loss": float(metrics["loss"])},
            )
            print(f"  checkpoint -> {path}")
    synchronize(dev)
    it.close()
    print(f"done in {time.perf_counter()-t0:.1f}s")


if __name__ == "__main__":
    main()
