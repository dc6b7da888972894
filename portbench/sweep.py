"""Find the highest Poisson rate a server cell sustains: one process, one
server, a window at each rate in turn.

    python3 portbench/sweep.py --workload vgg16.server.card.b4 --seed <n> \
        --seconds 8 --rates 400 500 600 700 800

For each rate it prints one JSON line: requests, sheds, answers
completed per second, p50/p95 from the due time, and the median latency
of the window's last quarter of requests over its first quarter: a
backlog that grows through the window reads well above 1.  The highest
rate with no shed and a ratio near 1 is the knee; the cell's mix runs at
4/5 of it.  Not run by the benchmark's own runs.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from repro_torch.serving.planner import serve

    from portbench import traffic
    from portbench.bench import Cell, _graph, load_spec, pool_images
    from portbench.readers import percentile
    from portbench.weights import make_weights

    cell = Cell.named(load_spec(), args.workload)
    cfg, mix = cell.config, dict(cell.mix)
    dev = torch.device("cuda")
    params = make_weights(cell.counts.layers(), args.seed, cfg["weights"], dev)
    images = pool_images(cell, args.seed, dev)
    server = serve(_graph(cfg), backend=cfg["route"], batch_size=int(mix["batch_size"]),
                   flush_timeout_s=float(mix["flush_timeout_s"]),
                   queue_depth=int(mix.get("queue_depth", 2)), params=params, device=dev)
    try:
        for rate in args.rates:
            mix["rate"] = rate
            w = traffic.drive(server, images, mix, args.seconds, args.seed)
            reqs = w.window_requests()
            lat = [r.latency_s() for r in reqs]
            q = max(1, len(reqs) // 4)
            head = percentile([x for x in lat[:q] if x != traffic.MISS_S], 50)
            tail = percentile([x for x in lat[-q:] if x != traffic.MISS_S], 50)
            done = [r for r in reqs if r.output is not None]
            print(json.dumps({
                "rate": rate, "requests": len(reqs), "shed": sum(r.shed for r in reqs),
                "completed_per_s": len(done) / w.seconds,
                "p50_ms": 1e3 * percentile(lat, 50), "p95_ms": 1e3 * percentile(lat, 95),
                "tail_over_head": (tail / head) if head and tail else None,
            }), flush=True)
    finally:
        server.stop(timeout=traffic.DRAIN_S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
