"""The control of ``correct``: the plain reference put in the program's
place and computed in TF32 (the precision below the configurations' f32),
judged against the f32 reference by the cell's own number, at the cell's
size (its pool of images, in blocks of its micro-batch).

    python3 portbench/control.py --workload <cell> --seeds <n> ... \
        [--program-seconds <s>]

One JSON line a seed: the control's reading and, with
``--program-seconds``, the program's own reading from a run of that
window in the same process (the limit's lower reading).  Not run by the
benchmark's own runs.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from portbench.bench import Cell, load_spec, reference_probs, run_cell, worst_gap

    cell = Cell.named(load_spec(), args.workload)
    dev = torch.device("cuda")
    number = cell.config["correct"]["number"]
    for seed in args.seeds:
        line = {"workload": cell.name, "seed": seed, "number": number}
        if args.program_seconds > 0:
            result, _ = run_cell(cell, seed, args.program_seconds, False, device=dev)
            line["program"] = result["compared"][number]["value"]
            line["correct"] = result["correct"]
        ref = reference_probs(cell, seed, dev, "f32")
        control = reference_probs(cell, seed, dev, "tf32", batch=int(cell.mix["batch_size"]))
        line["control"] = worst_gap(control, ref)
        line["max_ref_prob"] = float(ref.max())
        print(json.dumps(line), flush=True)
        del ref, control
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
