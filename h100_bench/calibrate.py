"""The readings that the limits of ``limits/<cell>.json`` are set from,
made on the card at the cell's own size (the benchmark's runs do not run
this):

- sound runs on many seeds, each one whole fit;
- the control on each of them: the cell's reference in the precision
  below the configuration's (its ``CONTROL``), read at the same draws in
  the program's place;
- each fault of ``faults.py`` planted in the program, on a few seeds.

    python3 h100_bench/calibrate.py --workload eight_schools.nuts --seeds 101 102 --fault-seeds 201 202 203 --out readings.jsonl

Prints one JSON line per reading, and appends it to ``--out`` where given.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# a window this short holds one whole fit: each reading is one fit's
WINDOW_S = 1.0


def main(argv=None):
    from h100_bench import faults, harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", help="a file to append the readings to")
    args = ap.parse_args(argv)
    spec = harness.Spec.load(ROOT, args.workload)
    ref = harness.load_module(harness.HERE / "reference" / f"{spec.cell['config']}.py")
    def emit(line):
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    runs = [(None, s) for s in args.seeds] + [(f, s) for f in faults.FAULTS
                                               for s in args.fault_seeds]
    for fault, seed in runs:
        keep = {}
        t = time.perf_counter()
        with faults.planted(fault):
            result, compared = harness.run_cell(spec, seed, WINDOW_S, False,
                                                device="cuda", keep=keep)
        line = {"cell": args.workload, "seed": seed, "reading": fault or "sound",
                "numbers": {k: v for k, (v, _) in compared.items()},
                "fits": len(keep["fits"]), "metrics": result["metrics"],
                "s": time.perf_counter() - t}
        emit(line)
        if fault is None:
            t = time.perf_counter()
            control = harness.compare(spec, keep["fits"], keep["data"], None, "cuda",
                                      precision=ref.CONTROL)
            emit({"cell": args.workload, "seed": seed, "reading": f"control:{ref.CONTROL}",
                  "numbers": control, "s": time.perf_counter() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())
