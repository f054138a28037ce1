"""What every cell shares: the spec files, seeds, the device guard, the
closed-loop window, the check against the limits and the result line.

Nothing here imports the program; the drivers under ``drivers/`` do.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may hold once its window has closed:
# the JAX stack and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "sudo_rm_rf_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing spec, JAX loaded)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """Import a file by its path; a metric's name may hold dots."""
    if not path.is_file():
        raise BenchError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name or f"perfbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic files
    read, and the per-layer metrics that report in it."""

    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _reports_in(metric: dict, cell: str, e2e_names) -> bool:
    """A per-layer metric reports in the cells it lists, or, listing none,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, bench_path: Path = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root)."""
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf_entry = configs[w["config"]]
    config = load_json(ROOT / conf_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports_in(m, name, e2e_names)]
    return Cell(name, w["config"], config, w["traffic"], traffic, int(w["chips"]), e2e,
                per_layer)


def sub_seed(seed: int, *path) -> int:
    """A 63-bit seed for one use (weights, inputs, order, sample) of a run
    seeded with ``seed``, any whole number."""
    words = [abs(int(seed)), int(int(seed) < 0)]
    words += [zlib.crc32(str(p).encode()) for p in path]
    state = np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)
    return int(state[0] >> np.uint64(1))


def require_cards(torch, chips: int) -> None:
    """Raise unless ``chips`` CUDA cards are present: no fallback to the CPU."""
    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is False: this benchmark runs on a card only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")


def fp32_strict(torch) -> None:
    """fp32 as fp32: no TF32 in cuBLAS or cuDNN (PyTorch's cuDNN default
    takes TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(torch, device) -> None:
    """Let the program's freed tensors go back to the device."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def worst(values) -> float:
    """The largest of a tensor's values, or inf where any is not finite (a
    NaN never passes a check)."""
    v = values.double()
    return float(v.max()) if bool(v.isfinite().all()) else math.inf


def forbidden_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that are the JAX stack or the JAX
    package, compared whole (``sudo_rm_rf_tpu_torch`` is not
    ``sudo_rm_rf_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def closed_loop(request: Callable[[int], object], seconds: float,
                min_requests: int = 1) -> dict:
    """Run ``request(i)`` back to back until ``seconds`` have passed since
    the first began (and at least ``min_requests`` ran). Each request ends
    holding its result on the host, so the host clock spans the work.
    Returns the count, the window's seconds (to the end of the last
    request), and each request's latency in seconds."""
    lat = []
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds or i < min_requests:
        t0 = time.perf_counter()
        request(i)
        end = time.perf_counter()
        lat.append(end - t0)
        i += 1
    return {"count": i, "elapsed_s": end - start, "latencies_s": lat}


class Phases:
    """Seconds of the named phases of a set-up, each to the mark that ends it."""

    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in 0..100) of all ``values``."""
    v = sorted(values)
    if not v:
        raise BenchError("percentile of no values")
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


class Reservoir:
    """A uniform sample of ``k`` of a stream's items, drawn from a seed
    (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclass
class Check:
    """One number compared, with its limit: it passes at or below."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


def checks_from(readings: Dict[str, float], limits: Dict[str, float]) -> List[Check]:
    missing = set(limits) - set(readings)
    if missing:
        raise BenchError(f"the check gave no reading for {sorted(missing)}")
    return [Check(k, float(readings[k]), float(limits[k])) for k in limits]
