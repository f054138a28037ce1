"""Whole runs at toy sizes on the CPU, past the harness's look for a card:
sound, they come out correct; with the timed path broken underneath, each
fault a cell can have makes ``correct`` false."""

import pytest
import torch

from perfbench import core, faults, run


def _run(cell, seed=2**31 + 3):
    return run.run_cell(cell, seed, 0.2, False, "cpu")


def test_sound_runs_are_correct(serve_cell, recordings_cell):
    for cell in (serve_cell, recordings_cell):
        line = _run(cell)
        assert line["correct"], (cell.traffic_name, line["checks"])
        assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("how", faults.SERVING)
def test_serving_faults(serve_cell, how):
    with faults.plant("serve_batches", how):
        assert not _run(serve_cell)["correct"]


@pytest.mark.parametrize("how", faults.RECORDINGS)
def test_recordings_faults(recordings_cell, how):
    with faults.plant("recordings", how):
        assert not _run(recordings_cell)["correct"]


def test_recordings_front_end_fault(recordings_cell, monkeypatch):
    from sudo_rm_rf_tpu_torch.inference import overlap_add

    monkeypatch.setattr(overlap_add, "_hann", lambda n: torch.ones(n).numpy())
    assert not _run(recordings_cell)["correct"]


def test_faults_are_taken_out_again(serve_cell):
    from sudo_rm_rf_tpu_torch.models import fast_inference

    plain = fast_inference.improved_forward_fast
    with faults.plant("serve_batches", "answer"):
        assert fast_inference.improved_forward_fast is not plain
    assert fast_inference.improved_forward_fast is plain
