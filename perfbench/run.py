"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs made on the card from the seed, the cell's
shapes warmed, K1's library built on a checkout's first run) counts in
``setup_s``, from the process's start to the first timed call. Then the
window runs closed loop for ``--seconds``; with ``--trace 1`` under the
profiler, and the line carries the per-layer metrics instead of the
end-to-end ones. Once the window has closed the device's peak memory is
read, the program's state freed, and the sampled answers are judged against
the plain reference: each number compared is printed beside its limit, on
standard error and last in the line. The line is the last of standard
output. No card, too few cards, or the JAX stack in ``sys.modules``: no
line and a non-zero exit.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from perfbench import core  # noqa: E402
from perfbench import trace as tr  # noqa: E402


def card_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def per_layer_metrics(cell: core.Cell, trace: tr.Trace) -> dict:
    """Each per-layer metric of the cell from its reader
    ``metrics/<name>.py``; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = core.load_module(core.HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(trace)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: core.Cell, seed: int, seconds: float, trace_on: bool, device,
             t0: float = None) -> dict:
    """Set up, measure, judge; returns the result line as a dict (``device``
    without the card's name, which the caller adds)."""
    import torch

    driver = core.load_module(core.HERE / "drivers" / f"{cell.traffic['driver']}.py")
    drv = driver.Driver(cell, seed, device)
    before = time.perf_counter() - (_T0 if t0 is None else t0)
    drv.setup()
    setup_s = time.perf_counter() - (_T0 if t0 is None else t0)
    print(f"setup_s {setup_s!r} {json.dumps(dict(imports=before, **drv.phases.seconds))}",
          file=sys.stderr)
    holder = {}
    with tr.traced(trace_on, holder):
        win = drv.window(seconds)
    if win.get("diag"):
        print(f"window {json.dumps(win['diag'])}", file=sys.stderr)
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    info = drv.trace_info()
    drv.release()
    readings = drv.judge()
    checks = core.checks_from(readings, cell.traffic["limits"])
    seen = {k: v for k, v in readings.items() if k not in cell.traffic["limits"]}
    if seen:
        print(f"judge {json.dumps(seen)}", file=sys.stderr)
    result = {"correct": all(c.ok for c in checks), "attempted": int(win["attempted"]),
              "failed": int(win["failed"])}
    if trace_on:
        trace = tr.Trace(holder["events"], holder["wall_s"], **info)
        result["metrics"] = per_layer_metrics(cell, trace)
        result["device"] = {"memory_peak_bytes": peak, "busy_s": trace.busy_s,
                            "window_s": trace.window_s}
        result["breakdown"] = tr.breakdown(trace)
    else:
        wanted = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(win["metrics"], setup_s=setup_s)
        result["metrics"] = {k: {"value": values[k], "unit": u} for k, u in wanted.items()}
        result["device"] = {"memory_peak_bytes": peak}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    # one process, one host thread: the program's host side is dispatch
    torch.set_num_threads(1)
    try:
        cell = core.load_cell(args.workload)
        core.require_cards(torch, cell.chips)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
        found = core.forbidden_loaded()
        if found:
            raise core.BenchError(f"modules of the JAX stack were loaded: {found}")
    except core.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    device.update(result["device"])
    result["device"] = device
    result["power"] = card_power_limit()
    result["checks"] = result.pop("checks")  # last in the line
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
