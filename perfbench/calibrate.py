"""Readings that set the limits of ``correct``, run on the card:

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 --seconds 3 \\
        [--control] [--fault unchanged|half|altered|stale_key] [--set key=json ...]

For each seed, one process runs the cell as a run does (set-up, a window
of ``--seconds``, the program's state freed) and prints one JSON line: the
numbers the program's output reads against the reference and, with
``--control``, those the control reads (the reference in bfloat16 put in
the program's place). ``--fault`` breaks the timed path underneath
(``faults.py``) for the whole run; ``--set`` changes a key of the traffic
mix for the probe (``--set job_steps=1000000``: one job all window).
The benchmark's own runs never run this.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    import argparse
    import importlib
    import json
    import time

    import torch

    from perfbench import core, faults

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted({f for d in ("render", "train")
                                              for f in faults.of(d)}))
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON")
    args = p.parse_args(argv)
    core.cache_dirs()
    bench = core.load_benchmark()
    cell, config, traffic = core.load_cell(bench, args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        traffic = {**traffic, key: json.loads(value)}
    device = core.device_of(cell["chips"])
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    for seed in args.seeds:
        ctx = core.Context(cell, config, traffic, seed, args.seconds, False, device)
        t0 = time.perf_counter()
        with faults.planted(args.fault, ctx):
            # a cell whose ranks are processes of their own plants it in them
            c = driver.Cell(ctx, args.fault) if getattr(driver.Cell, "traces_itself", False) \
                else driver.Cell(ctx)
            window = c.window(args.seconds, t0)
            c.release()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "set": args.set, "units": window.units, "measures": window.measures,
                "failed": getattr(c, "failed_steps", 0),
                "program": {k.name: k.value for k in c.check()}}
        if hasattr(c, "gaps"):  # the numbers the checks take their medians of
            line["gaps"] = c.gaps()
        if args.control:
            line["control"] = {k.name: k.value for k in driver.control(c)}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del c
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
