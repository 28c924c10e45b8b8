"""The readings that a cell's limits are set from, many seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 11 12 ... --control-seeds 11 12 13 --out <file>

For each seed of ``--seeds`` the program's readings, as a run's check takes
them (set-up, the first steps or the sampled requests of a short window at
the cell's load, the reference), with ``--fault`` planted if given
(``faults.py``); for each of ``--control-seeds`` also the control's, the
reference in TF32 in the program's place. One JSON line a
reading, to ``--out`` and standard output. The benchmark's own runs do not
run this; it needs the card.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", choices=("frozen", "tile"), help="run the program with this fault planted")
    p.add_argument("--out", type=Path, required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import faults, harness
    from portbench.run import CACHE

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    Driver = cell.driver().Driver
    dev = torch.device("cuda", 0)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("a") as f:
        for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
            drv = Driver(cell.config, cell.traffic, seed, dev)
            with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
                drv.setup(CACHE)
                rec = drv.run(units=cell.traffic["check_window"]) if cell.traffic["kind"] == "view" else {}
            failed = drv.setup_rec["failed"] + rec.get("failed", 0)
            drv.release()
            rows = []
            if seed in args.seeds:
                rows.append({"side": args.fault or "program", **drv.readings(rec)})
            if seed in args.control_seeds:
                rows.append({"side": "control", **drv.control_readings(rec)})
            for r in rows:
                line = json.dumps({"workload": args.workload, "seed": seed, "failed": failed, **r})
                print(line, flush=True)
                f.write(line + "\n")
            del drv
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
