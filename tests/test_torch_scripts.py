"""The port's training and serving measurement scripts
(``scripts/torch_*.py``) run end to end on the CPU at toy size (``--tiny``),
in this process: each returns its rows, labelled as CPU numbers, with the
keys its docstring promises."""

import importlib.util
import os

import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
CASES = {
    "torch_bench_ingestion": (["--steps", "2", "--timelength", "0.25", "--workers", "2"],
                              "ms_per_step", 3),
    "torch_bench_training": (["--reps", "1", "--quick"], "ms_per_step", 16),
    "torch_profile_train_step": (["--reps", "1", "--bs", "2"], "ms", 12),
    "torch_bench_relay": (["--steps", "2", "--chains", "2", "--bs", "2"], "ms_per_step", 6),
    # the serving sweeps and the roofline: six paths at one batch; the GC
    # gate search's timed recipe; the wide configuration's five paths; the
    # three serving rows timed with --measure
    "torch_bench_batch_sweep": (["--bs", "2", "--n_hi", "1"], "ms_batch", 6),
    "torch_bench_gc_serving": (["--bs", "2", "--n_hi", "1", "--families_sweep"], "ms_batch", 1),
    "torch_bench_quantized": (["--config", "u36_wide", "--bs", "2", "--n_hi", "1",
                               "--attribute"], "ms_per_batch", 5),
    "torch_roofline_bound": (["--measure", "--n_hi", "1"], "measured_ms", 3),
}
# the keys each serving script promises on every row it returns
ROW_KEYS = {
    "torch_bench_batch_sweep": ("path", "bs", "au_s_per_s", "idle_pct", "k1_launches",
                                "fidelity_db"),
    "torch_bench_gc_serving": ("path", "bs", "families", "au_s_per_s", "idle_pct",
                               "k1_launches", "fidelity_db", "gated_fidelity_db"),
    "torch_bench_quantized": ("config", "bs", "path", "au_s_per_s", "idle_pct", "k1_launches"),
    "torch_roofline_bound": ("row", "flops_g", "compute_floor_ms", "logical_bytes_gb",
                             "logical_roofline_ms", "least_bytes_ms", "floor_ms",
                             "recoverable_x_max", "fused_traffic_max_x", "idle_pct",
                             "k1_launches"),
}


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(SCRIPTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(CASES))
def test_script_runs_at_toy_size_on_the_cpu(name, capsys):
    argv, key, n_rows = CASES[name]
    rows = _load(name).main(argv + ["--device", "cpu", "--tiny"])
    assert len(rows) == n_rows
    assert all(row[key] > 0 and row["device"] == "cpu (not a device measurement)"
               for row in rows), rows
    assert capsys.readouterr().out.count('"device": "cpu (not a device measurement)"') >= n_rows
    assert all(k in row for row in rows for k in ROW_KEYS.get(name, ())), rows


def test_gc_sweep_times_every_path_at_toy_size():
    """Without --families_sweep: each of the three GroupComm forwards in fp32
    and bf16 and both int8 modes, fidelity against the fp32 xla forward."""
    rows = _load("torch_bench_gc_serving").main(["--bs", "2", "--n_hi", "1", "--device", "cpu",
                                                 "--tiny"])
    impls = ("kernel", "fma_merged", "xla")
    assert [r["path"] for r in rows] == [f"{i}_{d}" for i in impls for d in ("fp32", "bf16")] \
        + ["int8_dynamic", "int8_static"]
    by = {r["path"]: r for r in rows}
    assert by["xla_fp32"]["fidelity_db"] >= 150  # the reference against itself
    assert all(by[f"{i}_fp32"]["fidelity_db"] >= 80 for i in impls)
    assert all(35 <= by[f"{i}_bf16"]["fidelity_db"] < 80 for i in impls)
    assert all(r["ms_batch"] > 0 and r["k1_launches"] == 0 and r["idle_pct"] is None
               for r in rows)
