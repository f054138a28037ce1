"""Fixtures of the benchmark's own tests: toy cells on the CPU.

Run them with ``python -m pytest perfbench/tests -q``; the ones marked
``card`` run only where a CUDA card is present and skip elsewhere.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY_MODEL = dict(model_type="relu", out_channels=16, in_channels=32, num_blocks=2,
                 upsampling_depth=3, enc_kernel_size=21, enc_num_basis=32, num_sources=2,
                 fs=8000, serve={"impl": "kernel", "compute_dtype": None})


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    torch.set_num_threads(2)


def toy_cell(traffic: str, config: str = None, **traffic_over):
    """A cell of BENCHMARK.json's traffic ``traffic`` at toy widths and
    sizes, for the CPU."""
    from perfbench import core

    hp = dict(TOY_MODEL)
    if config is not None:
        full = core.load_json(core.HERE / "configs" / f"{config}.json")
        full.update(hp)
        hp = full
    tr = dict(core.load_json(core.HERE / "traffic" / f"{traffic}.json"), **traffic_over)
    return core.Cell("toy", "toy", hp, traffic, tr, 1, [], [])


SERVE = dict(batch=2, ring=3, sample=3, seconds_per_example=0.5)
RECORDINGS = dict(n_recordings=5, min_seconds=0.2, max_seconds=1.4, chunk_seconds=0.4,
                  batch_chunks=2, sample=3)
@pytest.fixture
def serve_cell():
    return toy_cell("offline_batch32_4s", **SERVE)


@pytest.fixture
def recordings_cell():
    return toy_cell("recordings_2_68s", **RECORDINGS)
