"""Readings that the correctness limits are set from, on the card.

    python3 bench/control.py --workload <cell> --seed <n> \
        --program-seeds 12 --control-seeds 3 --seconds 2

runs, in one process, the cell's short window and check with the program
on ``--program-seeds`` seeds (the lower readings), then with the control
in the program's place on ``--control-seeds`` further seeds (the upper
readings): the reference at the next precision below the configuration's
(bfloat16 for float32).  One JSON line a run, then the largest program
reading and the smallest control reading of each number compared.  The
benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def readings(workload: str, seed: int, program_seeds: int,
             control_seeds: int, seconds: float, device: str = "cuda:0",
             bench=None) -> dict:
    """{"program": [...], "control": [...]}: each run's checks."""
    from bench import harness
    cell = harness.Cell(workload, **({"bench": bench} if bench else {}))
    out = {"program": [], "control": []}
    for mode, count, base in (("program", program_seeds, seed),
                              ("control", control_seeds,
                               seed + program_seeds)):
        make = None
        if mode == "control":
            make = lambda c, state: c.generator.control(c.cfg, c.traffic,  # noqa: E731
                                                     state, c.ref)
        for s in range(base, base + count):
            res = harness.run_cell(cell, s, seconds, False, device,
                                   time.perf_counter(), make_system=make)
            row = {"mode": mode, "seed": s, "correct": res["correct"],
                   "checks": {k: v["value"] for k, v in
                              res["checks"].items()},
                   "metrics": {k: v["value"] for k, v in
                               res["metrics"].items()}}
            print(json.dumps(row), flush=True)
            out[mode].append(row)
            import torch
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return out


def summary(out: dict) -> dict:
    names = out["program"][0]["checks"] if out["program"] else {}
    return {name: {"program_max": max(r["checks"][name]
                                      for r in out["program"]),
                   "control_min": min((r["checks"][name]
                                       for r in out["control"]),
                                      default=None)}
            for name in names}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--program-seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    out = readings(args.workload, args.seed, args.program_seeds,
                   args.control_seeds, args.seconds)
    print(json.dumps({"workload": args.workload, "summary": summary(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
