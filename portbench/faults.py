"""A cell's run with its timed path broken underneath, at the cell's own
size on the card: the readings of each fault the check must catch.

    python3 portbench/faults.py --workload <cell> --fault none|stale|drop_half|alter_answer \\
        --seeds 21 22 23 [--seconds 2]

prints, per seed, `correct` and each number the check compared beside its
limit; `none` reads sound runs, several seeds in one process. The faults are the drivers' (`drivers/eval.Tap`,
`drivers/train.Recorder`).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench faults: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        h = harness.Run(args.workload, seed, args.seconds, False, t_start=time.perf_counter(),
                        fault=None if args.fault == "none" else args.fault)
        result, checks = harness.load_driver(h.cell["driver"]).run(h)
        look = result.get("extra", {}).get("check_look")
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": result["correct"],
                          "checks": checks, "look": look}), flush=True)
        del result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
