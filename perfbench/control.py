"""Readings for the limits of a cell's correctness check, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--seconds 2] [--fault <name>]

For each of ``--seeds`` it makes a whole run of the cell with a short
window, in this one process, and prints the numbers the run compared (the
program's readings: the lower ones).  With ``--fault`` (a name in
:data:`perfbench.faults.FAULTS`) those runs drive the program with that
fault planted under the timed path.  For each of ``--control-seeds`` it
puts the control in the program's place: the plain reference with every
convolution operand in bfloat16, the precision below the float32 the
configuration states, on as many of the seed's frames as a run compares,
against the float32 reference (the upper readings).  The benchmark's own
runs never run the control.  One JSON line per reading, then a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int) -> dict:
    """The control against the reference on a run's count of the seed's
    frames."""
    from perfbench import check, frames, reference

    cfg, traffic = cell.config, cell.traffic
    n = traffic["sample"] * traffic.get("batch", 1)
    pool = frames.pool(seed, traffic["pool"], tuple(cfg["in_hw"]))
    w = reference.load_weights()
    pairs = [(reference.upscale(pool[k], cfg["scale"], w, "bfloat16"),
              reference.upscale(pool[k], cfg["scale"], w))
             for k in range(min(n, len(pool)))]
    return check.compare(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import faults, harness, run as bench_run, spec

    if args.fault is not None:
        faults.FAULTS[args.fault](setattr)

    os.environ["JAX_COMPILATION_CACHE_DIR"] = str(bench_run.CACHE)
    cell = spec.load_cell(args.workload, trace=False)
    import jax

    jax.config.update("jax_compilation_cache_dir", str(bench_run.CACHE))
    if len(jax.devices()) < cell.chips:
        print(f"control: needs {cell.chips} devices", file=sys.stderr)
        return 2
    for line in bench_run.card_lines():
        print(line, flush=True)
    program, control = [], []
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, time.monotonic(),
                        None)
        nums = {k: v["value"] for k, v in r["checked"].items()}
        program.append(nums)
        print(json.dumps({"reading": args.fault or "program", "seed": seed,
                          **nums,
                          "correct": r["correct"],
                          "attempted": r["attempted"]}), flush=True)
    for seed in args.control_seeds:
        nums = control_numbers(cell, seed)
        control.append(nums)
        print(json.dumps({"reading": "control", "seed": seed, **nums}),
              flush=True)
    summary = {"workload": args.workload}
    for key in ("mismatch_share", "bytes_over_1_lsb"):
        if program and args.fault is None:
            summary[f"program_max_{key}"] = max(p[key] for p in program)
        elif program:
            summary[f"{args.fault}_min_{key}"] = min(p[key] for p in program)
        if control:
            summary[f"control_min_{key}"] = min(c[key] for c in control)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
