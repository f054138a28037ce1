"""The serving path's host spans (``utils/tracing.py``) on the CPU: nothing
recorded without a profiler; under one, the front end's and the forward's
spans, their tree, their attributes, and their stamps on the profiler's
clock."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sudo_rm_rf_tpu_torch import models
from sudo_rm_rf_tpu_torch.inference import OverlapAddSeparator
from sudo_rm_rf_tpu_torch.models.fast_inference import improved_forward_fast
from sudo_rm_rf_tpu_torch.utils import tracing
from _torch_threads import one_intra_op_thread  # noqa: F401 (autouse, module scope)

FS = 8000
CHUNK = 4 * FS
BATCH = 8
HP = dict(out_channels=16, in_channels=32, num_blocks=3, upsampling_depth=3,
          enc_kernel_size=21, enc_num_basis=24, num_sources=2)


@pytest.fixture(autouse=True)
def no_spans_left():
    tracing.clear()
    yield
    tracing.clear()


def _stub(x):  # (B, 1, T) -> (B, 2, T)
    return torch.cat([x, 0.5 * x], dim=1)


def _separator():
    return OverlapAddSeparator(torch.nn.Linear(1, 1), CHUNK, num_sources=2,
                               batch_chunks=BATCH, forward_fn=_stub)


def _mixture(seconds, seed=0):
    return np.random.default_rng(seed).standard_normal(int(seconds * FS)).astype(np.float32)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    _separator().separate(_mixture(20.0))
    assert tracing.spans() == []
    assert tracing.span("a") is tracing.span("b", rows=1)  # one shared no-op


@pytest.mark.parametrize("seconds", [20.0, 2.0])
def test_separate_records_one_tree_a_call(seconds):
    sep, mix = _separator(), _mixture(seconds)
    with _cpu_profile():
        want = sep.separate(mix)
        sep.separate(mix)
    got = sep.separate(mix)  # the profiler is off again
    np.testing.assert_array_equal(got, want)
    recs = tracing.spans()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent == 0]
    assert [r.name for r in roots] == ["overlap_add.separate"] * 2
    n_chunks = max(1, -(-(len(mix) - CHUNK) // (CHUNK // 2)) + 1)
    for root in roots:
        assert root.attrs == {"samples": len(mix), "chunks": n_chunks}
        tree = [r for r in recs if r.request == root.id]
        for r in tree:
            if r is not root:
                p = by_id[r.parent]
                assert p.request == root.id
                assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        names = [r.name for r in tree]
        assert names.count("overlap_add.chunk") == names.count("overlap_add.stitch") == 1
        assert names.count("overlap_add.align") == n_chunks - 1
        batches = [r for r in tree if r.name == "overlap_add.batch"]
        assert sum(b.attrs["rows"] for b in batches) == n_chunks
        assert sum(b.attrs["slots"] for b in batches) == -(-n_chunks // BATCH) * BATCH
        for b in batches:
            kids = [r.name for r in tree if r.parent == b.id]
            assert kids == ["overlap_add.upload", "overlap_add.forward", "overlap_add.fetch"]
            # the padded batch went up; its valid rows' estimates came back
            assert b.attrs["h2d_bytes"] == BATCH * CHUNK * 4
            assert b.attrs["d2h_bytes"] == b.attrs["rows"] * 2 * CHUNK * 4
        for name in ("overlap_add.chunk", "overlap_add.batch", "overlap_add.stitch"):
            assert all(by_id[r.parent] is root for r in tree if r.name == name)


def test_forward_records_its_encode_blocks_and_decode():
    torch.manual_seed(0)
    model = models.get_model("relu", **HP).eval()
    x = torch.randn(3, 1, 1600)
    with _cpu_profile():
        improved_forward_fast(model, x, impl="fma")
    recs = tracing.spans()
    root, = [r for r in recs if r.parent == 0]
    assert root.name == "forward" and root.attrs == {"rows": 3}
    kids = sorted((r for r in recs if r is not root), key=lambda r: r.start_ns)
    assert [r.name for r in kids] == (["forward.encode"] + ["forward.block"] * HP["num_blocks"]
                                      + ["forward.decode"])
    assert all(r.parent == root.id and r.request == root.id for r in kids)
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in kids)


def test_spans_lie_on_the_profilers_clock():
    """A span opened around a ``record_function`` range starts before the
    profiler's own event of it and ends after it."""
    with _cpu_profile() as prof:
        with tracing.span("outer"):
            with record_function("inner_range"):
                torch.ones(64).sum()
    outer, = tracing.spans()
    inner, = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner_range"]
    assert outer.start_ns <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.end_ns
    # and the same clock: the range is not seconds away from the span
    assert outer.end_ns - outer.start_ns < 10**9


def test_an_exception_closes_its_spans():
    with _cpu_profile():
        with pytest.raises(RuntimeError):
            with tracing.span("outer"):
                with tracing.span("inner"):
                    raise RuntimeError("boom")
        with tracing.span("next"):
            pass
    inner, outer, nxt = tracing.spans()
    assert (inner.name, outer.name, nxt.name) == ("inner", "outer", "next")
    assert inner.parent == outer.id and nxt.parent == 0 and nxt.request == nxt.id
