"""Run one cell of BENCHMARK.json against the port on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; ``breakdown`` when
traced; ``compared`` last).  Earlier lines, and
``portbench-runs/<workload>.<seed>.<trace>.json``, carry the
rest: the plan, the card's clocks and power, generator lateness, sheds,
micro-batch fill, graph launches, the f32-peak shares.  The numbers the
run was judged by end standard error, each beside its limit.  Exits
non-zero without a result where the card is missing or too few, or
where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from portbench.bench import Cell, load_spec, run_cell

    cell = Cell.resolve(load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, info = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of {bad} were loaded", file=sys.stderr)
        return 3
    out_dir = os.path.join(ROOT, "portbench-runs")
    os.makedirs(out_dir, exist_ok=True)
    record = dict(info, result=result)
    with open(os.path.join(out_dir, f"{cell.name}.{args.seed}.{args.trace}.json"), "w") as f:
        json.dump(record, f, indent=1)
    print("portbench info " + json.dumps(info))
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
