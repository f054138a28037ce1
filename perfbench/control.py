"""Readings that set a cell's limits: on each seed, the numbers the check
compares for the program (set-up, a short window at the cell's own load,
the judge) and for the control (the reference in the next precision down,
TF32, in the program's place). The benchmark's own runs never run it.

    python3 -m perfbench.control --workload <name> --seeds 1 2 3 --seconds 2

One JSON line a seed, then one with the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from perfbench import core, faults


def readings(cell: core.Cell, seed: int, seconds: float, device, control: bool = True,
             fault: str = None) -> dict:
    """The program's readings on ``seed`` (with ``fault`` planted in it, if
    given) and, with ``control``, the control's."""
    name = cell.traffic["driver"]
    driver = core.load_module(core.HERE / "drivers" / f"{name}.py")
    drv = driver.Driver(cell, seed, device)
    t0 = time.perf_counter()
    with faults.plant(name, fault) if fault else contextlib.nullcontext():
        drv.setup()
        win = drv.window(seconds)
    drv.release()
    out = {"seed": seed, "setup_s": time.perf_counter() - t0, "attempted": win["attempted"],
           "fault": fault, "program": drv.judge()}
    if control:
        out["control"] = drv.control_judge()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control_seeds", type=int, default=3,
                   help="run the control on the first this many seeds")
    p.add_argument("--fault", default=None,
                   help="plant this fault of perfbench.faults in the program")
    args = p.parse_args(argv)

    import torch

    cell = core.load_cell(args.workload)
    core.require_cards(torch, cell.chips)
    rows = []
    for i, seed in enumerate(args.seeds):
        rows.append(readings(cell, seed, args.seconds, torch.device("cuda"),
                             control=i < args.control_seeds, fault=args.fault))
        print(json.dumps(rows[-1]), flush=True)
    names = list(cell.traffic["limits"])
    summary = {"workload": args.workload, "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows) for k in names},
               "control_min": {k: min((r["control"][k] for r in rows if "control" in r),
                                      default=None) for k in names},
               "limits": cell.traffic["limits"]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
