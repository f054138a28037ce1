"""On the card: each cell's program passes its limits, and its control (the
reference in the next precision down) and each fault the cell can have
fail them, at the cell's own sizes and a short window. Skips without a
CUDA card; run on the card with ``python -m pytest perfbench/tests -q -m card``."""

import pytest

from perfbench import control, core, faults

WORKLOADS = core.load_json(core.ROOT / "BENCHMARK.json")["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
FAULTED = [(w["name"], how) for w in WORKLOADS
           for how in faults.kinds(core.load_cell(w["name"]).traffic["driver"])]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload):
    device = _card()
    cell = core.load_cell(workload)
    r = control.readings(cell, 2**31 + 17, 0.5, device)
    limits = cell.traffic["limits"]
    assert all(c.ok for c in core.checks_from(r["program"], limits)), r
    assert not all(c.ok for c in core.checks_from(r["control"], limits)), r


@pytest.mark.card
@pytest.mark.parametrize("workload,how", FAULTED)
def test_each_fault_fails(workload, how):
    device = _card()
    cell = core.load_cell(workload)
    r = control.readings(cell, 2**31 + 29, 0.5, device, control=False, fault=how)
    assert not all(c.ok for c in core.checks_from(r["program"], cell.traffic["limits"])), r
