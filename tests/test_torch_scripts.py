"""The port's training measurement scripts (``scripts/torch_*.py``) run end to
end on the CPU at toy size (``--tiny``), in this process: each returns its
rows, labelled as CPU numbers, with the keys its docstring promises."""

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
