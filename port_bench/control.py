#!/usr/bin/env python3
"""The readings behind the limits of the comparison, on one GPU.

    python3 port_bench/control.py --workload <cell> --seconds <s>
                                  --seeds <n> [<n> ...] [--controls <k>]
                                  [--fresh]

For every seed, one run of the program (set-up, a window of ``--seconds``,
the comparison) prints the number the comparison computed.  For the first
``--controls`` seeds it also prints the control's: the reference's own
algorithm and certificate computed in bfloat16 in the program's place (the
configurations state float32), on the inputs of every answer the
program's run compared (the loop's own states, as the program met them),
and, for a batch cell, in the program's place for one whole batch at the
cell's size.  ``--fresh`` draws a loop's every segment afresh from the
seed (``"pool": 0``) in place of the mix's fixed pool, so that the
program's readings cover as many states as seeds.  The benchmark's runs
do not run it.  One JSON line per reading.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fresh", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from port_bench import harness
    bench = harness.Bench()
    cell = bench.cell(args.workload)
    conf = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    settings = conf["solver"][traffic["mode"]]
    ref = bench.module("reference", conf["kind"])
    over = {"traffic": {"pool": 0}} if args.fresh else {}
    for n, seed in enumerate(args.seeds):
        r = harness.run(bench, args.workload, seed, args.seconds, False,
                        device=args.device, overrides=over,
                        keep_samples=True)
        samples, rows = r.pop("_samples")
        line = {"seed": seed, "fresh": args.fresh,
                "program": r["checks"]["u_err"]["value"],
                "correct": r["correct"], "attempted": r["attempted"],
                "failed": r["failed"]}
        if n < args.controls:
            solve = harness.control_solver(ref, conf, settings,
                                           torch.device(args.device))
            values, compared, _ = harness.compare(
                ref, conf, settings, rows, samples,
                torch.device(args.device), answer=solve)
            line["control_on_program_inputs"] = values["u_err"]
            line["compared"] = compared
            if traffic["mode"] == "batch":
                c = harness.run(bench, args.workload, seed, 0.0, False,
                                device=args.device, engine="control",
                                overrides={"traffic": {"warmup": 0}})
                line["control_in_place"] = c["checks"]["u_err"]["value"]
        print(json.dumps(line), flush=True)
        del samples, r
    return 0


if __name__ == "__main__":
    sys.exit(main())
