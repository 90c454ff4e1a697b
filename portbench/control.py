"""The control of the correctness check: the reference put in the
program's place and computed in the nearest precision below the one the
configurations state (float32 with TF32 off): float32 with TF32 on. It has
to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--out f.json]

runs, for each seed, the cell's check at the cell's own size with the
TF32 reference's outputs in the program's place, and prints each number
beside the cell's limit. Eval cells: the batches the first
`check_batches` passes keep (harness.kept_batches) of the pass the cell's
traffic makes. Train cells: the first three steps, and three steps from
the state they leave in place of the steps after the window.
The program itself is not run.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def eval_control(h) -> dict:
    import itertools

    import torch

    from portbench import checks, harness

    opt = h.options()
    batches = harness.plan_eval(h, opt)
    n = min(int(h.cell.get("check_batches", 12)), len(batches))
    gaps = {"score_gap": 0.0, "span_gap": 0.0, "saliency_gap": 0.0}
    ref = h.reference_model()
    for i in sorted(set(itertools.islice(harness.kept_batches(batches, h.seed), n))):
        batch, meta = batches[i]
        checks.reference_precision(False)
        want = checks.reference_eval_outputs(ref, batch, h.device)
        checks.reference_precision(True)
        got = checks.reference_eval_outputs(ref, batch, h.device)
        checks.reference_precision(False)
        for k, v in checks.eval_gaps(got, want, batch, meta["n_rows"]).items():
            gaps[k] = max(gaps[k], v)
    del ref
    torch.cuda.empty_cache()
    return gaps


def train_control(h) -> dict:
    """Steps 1-3 from the seed's weights, then three steps from the state
    they leave, standing for the steps after the window: each by the TF32
    reference in the program's place, judged as the driver judges them."""
    import torch

    from portbench import checks, harness
    from portbench.drivers import train as T
    from portbench.reference.train import train_steps

    opt = h.options()
    n = T.CHECK_STEPS
    batches = harness.plan_train(h, opt, 2 * n)
    ref = h.reference_model()
    p0 = {k: p.detach().clone() for k, p in ref.named_parameters()}
    moments = {}
    checks.reference_precision(True)
    staged = [checks._stage(b, h.device) for b, _ in batches[:n]]
    losses, g1 = train_steps(ref, staged, h.cfg, h.seed, opt.lr, opt.weight_decay, opt.grad_clip,
                             state=moments)
    p3 = {k: p.detach().clone() for k, p in ref.named_parameters()}
    snapshot = ({k: (p3[k], m.clone(), v.clone()) for k, (m, v) in moments.items()}, n)
    staged = [checks._stage(b, h.device) for b, _ in batches[n:]]
    end_losses, _ = train_steps(ref, staged, h.cfg, h.seed, opt.lr, opt.weight_decay,
                                opt.grad_clip, first_step=n, state=moments, adam_steps=n)
    after = {k: p.detach().clone() for k, p in ref.named_parameters()}
    checks.reference_precision(False)
    del ref, staged
    torch.cuda.empty_cache()
    values, _, look = T.reference_gaps(h, opt, batches, losses, g1, p0, p3)
    end_values, _, end_look = T.end_gaps(h, opt, batches[n:], n, snapshot, end_losses, after)
    return dict(values, **end_values, worst_change3_gap=look["worst_change3_gap"],
                loss3_gap=max(look["loss_gap_steps"]),
                worst_change_end_gap=end_look["worst_change_end_gap"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        h = harness.Run(args.workload, seed, 0.0, False, t_start=t0)
        fn = train_control if h.cell["driver"] == "train" else eval_control
        values = fn(h)
        limits = h.cell["limits"]
        row = {"seed": seed, "seconds": time.perf_counter() - t0,
               "values": values,
               "fails": [k for k, v in values.items() if k in limits and v > limits[k]]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
